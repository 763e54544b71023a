r"""Elementwise bijections and the distribution convertors.

Counterpart of ``normflow__tpu/models/elementwise.py``: ``softplus_log2``,
``Identity``/``Clone``, ``Scale``, ``Tanh``/``ArcTanh``, ``Expit``/
``Logit``, the Pade maps, ``SgnBias``, ``SplineFlow``/``SplineNet`` and the
convertors ``UnityDistConvertor``, ``PhaseDistConvertor`` and
``DistConvertor``.  The per-channel maps (``Pade*``, ``spline_shape``) keep
the JAX package's data layout: channels on the axis ``channels_axis`` of
the data, the last by default.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import spline as sp
from .core import Flow, FlowList, sum_density

__all__ = ["softplus_log2", "inv_softplus_log2", "Identity", "Clone", "Scale",
           "Tanh", "ArcTanh", "Expit", "Logit", "Pade11", "Pade22", "Pade32",
           "SgnBias", "SplineFlow", "SplineNet", "UnityDistConvertor",
           "PhaseDistConvertor", "DistConvertor"]

_LOG2 = math.log(2.0)


def softplus_log2(x):
    r"""``log(1 + 2^x) / log 2``, so that ``softplus_log2(0) = 1``.

    Exact for every ``x``: ``F.softplus`` turns linear above its threshold
    of 20, which JAX's softplus does not, so it is computed as a
    ``logaddexp`` instead."""
    return torch.logaddexp(x * _LOG2, torch.zeros_like(x)) / _LOG2


def inv_softplus_log2(y):
    """The inverse of :func:`softplus_log2`, for a weight that should start
    at a given positive value."""
    y = torch.as_tensor(y)
    return torch.log(torch.expm1(y * _LOG2)) / _LOG2


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _zero_logj(x, density):
    if density:
        return torch.zeros_like(x)
    return torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)


def _weights(shape, value=0.0, *, dtype=None, device=None):
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


class Identity(Flow):
    """Identity bijection.  It takes and ignores ``rvol``, so that it can
    stand for the mean-field flow of a ``PSDBlock``."""

    def forward(self, x, log0=0.0, *, density: bool = False, rvol=None):
        return x, log0 + _zero_logj(x, density)

    backward = forward


class Clone(Identity):
    """Copy bijection: the identity (no tensor is modified in place)."""


class Scale(Flow):
    """Global positive scaling ``y = w x`` with ``w = softplus_log2(weight)``
    (zero weight gives the identity)."""

    @classmethod
    def build(cls, dtype=None, label="scale_", *, device=None):
        """The JAX package's factory (``label`` names a JAX leaf group;
        the port's flows carry none)."""
        return cls(dtype=dtype, device=device)

    def __init__(self, *, dtype=None, device=None):
        super().__init__()
        self.w = _weights((1,), dtype=dtype, device=device)

    @property
    def weight(self):
        return softplus_log2(self.w)

    def forward(self, x, log0=0.0, *, density: bool = False):
        return x * self.weight, log0 + self._logj(x, density, +1)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return x / self.weight, log0 + self._logj(x, density, -1)

    def _logj(self, x, density, sign):
        logw = sign * torch.log(self.weight)  # shape (1,)
        if density:
            return logw.expand(x.shape).to(x.dtype)
        n = float(math.prod(x.shape[1:]))
        return (logw * n).expand(x.shape[:1]).to(x.dtype)


def _tanh(x, log0, density):
    # log(1 - tanh^2 x) = 2 (log 2 - x - softplus(-2x)), stable for large |x|
    logj = 2 * (_LOG2 - x - _softplus(-2 * x))
    return torch.tanh(x), log0 + sum_density(logj, density)


def _arctanh(x, log0, density):
    logj = -torch.log1p(-x * x)
    return torch.atanh(x), log0 + sum_density(logj, density)


class Tanh(Flow):
    """``y = tanh(x)``, ``logJ = sum log(1 - tanh^2 x)``."""

    def forward(self, x, log0=0.0, *, density: bool = False):
        return _tanh(x, log0, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return _arctanh(x, log0, density)


class ArcTanh(Flow):
    """``y = atanh(x)``."""

    def forward(self, x, log0=0.0, *, density: bool = False):
        return _arctanh(x, log0, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return _tanh(x, log0, density)


def _expit(x, log0, density):
    logj = F.logsigmoid(x) + F.logsigmoid(-x)
    return torch.sigmoid(x), log0 + sum_density(logj, density)


def _logit(x, log0, density):
    y = torch.log(x) - torch.log1p(-x)
    logj = -(torch.log(x) + torch.log1p(-x))
    return y, log0 + sum_density(logj, density)


class Expit(Flow):
    """Sigmoid with a stable log-Jacobian."""

    def forward(self, x, log0=0.0, *, density: bool = False):
        return _expit(x, log0, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return _logit(x, log0, density)


class Logit(Flow):
    """``y = log(x / (1 - x))``."""

    def forward(self, x, log0=0.0, *, density: bool = False):
        return _logit(x, log0, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return _expit(x, log0, density)


class _ChannelFlow(Flow):
    """A map with one parameter per channel along ``channels_axis``."""

    def _per_channel(self, w, ndim):
        shape = [1] * ndim
        shape[self.channels_axis] = w.shape[0]
        return w.reshape(shape)


class Pade11(_ChannelFlow):
    r"""Pade 1/1 bijection of [0, 1], ``f(x) = x / (x + (1 - x) d_1)``, with
    ``d_1 = softplus_log2(w1)`` per channel."""

    @classmethod
    def build(cls, n_channels=1, channels_axis=-1, dtype=None,
              label="pade11", *, device=None):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(n_channels, channels_axis, dtype=dtype, device=device)

    def __init__(self, n_channels=1, channels_axis=-1, *, dtype=None,
                 device=None):
        super().__init__()
        self.w1 = _weights((n_channels,), dtype=dtype, device=device)
        self.channels_axis = channels_axis

    def forward(self, x, log0=0.0, *, density: bool = False):
        d1 = softplus_log2(self._per_channel(self.w1, x.dim()))
        denom = x + (1 - x) * d1
        logj = torch.log(d1) - 2 * torch.log(denom)
        return x / denom, log0 + sum_density(logj, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        d1 = softplus_log2(self._per_channel(self.w1, x.dim()))
        denom = x + (1 - x) / d1
        logj = -torch.log(d1) - 2 * torch.log(denom)
        return x / denom, log0 + sum_density(logj, density)


class Pade22(_ChannelFlow):
    r"""Pade 2/2 bijection of [0, 1],
    ``f(x) = x (x + d_0 (1 - x)) / (1 + (d_1 + d_0 - 2) x (1 - x))`` with
    per-channel ``d_0, d_1 > 0``; ``symmetric=True`` ties ``d_1 = d_0``."""

    @classmethod
    def build(cls, n_channels=1, channels_axis=-1, symmetric=False,
              dtype=None, label="pade22", *, device=None):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(n_channels, channels_axis, symmetric, dtype=dtype,
                   device=device)

    def __init__(self, n_channels=1, channels_axis=-1, symmetric=False, *,
                 dtype=None, device=None):
        super().__init__()
        self.w0 = _weights((n_channels,), dtype=dtype, device=device)
        self.w1 = _weights((n_channels,), dtype=dtype, device=device)
        self.channels_axis = channels_axis
        self.symmetric = symmetric

    def _derivs(self, ndim):
        d0 = softplus_log2(self._per_channel(self.w0, ndim))
        w1 = self.w0 if self.symmetric else self.w1
        return d0, softplus_log2(self._per_channel(w1, ndim))

    @staticmethod
    def _g1(x, d0, d1):
        denom = 1 + (d1 + d0 - 2) * x * (1 - x)
        return (d0 + 2 * (1 - d0) * x + (d1 + d0 - 2) * x**2) / denom**2

    def forward(self, x, log0=0.0, *, density: bool = False):
        d0, d1 = self._derivs(x.dim())
        denom = 1 + (d1 + d0 - 2) * x * (1 - x)
        y = x * (x + d0 * (1 - x)) / denom
        logj = torch.log(self._g1(x, d0, d1))
        return y, log0 + sum_density(logj, density)

    def backward(self, y, log0=0.0, *, density: bool = False):
        d0, d1 = self._derivs(y.dim())
        # the positive root of a x^2 + b x + c = 0 in the citardauq form
        c = y
        b = (d1 + d0 - 2) * y - d0
        a = -1 - b
        delta = torch.sqrt(torch.clamp(b * b - 4 * c * a, min=0.0))
        denom_q = -b + delta
        safe = torch.where(torch.abs(denom_q) < torch.finfo(y.dtype).tiny,
                           torch.ones_like(denom_q), denom_q)
        x = 2 * c / safe
        logj = -torch.log(self._g1(x, d0, d1))
        return x, log0 + sum_density(logj, density)


class Pade32(_ChannelFlow):
    r"""Odd Pade 3/2 bijection of the real line,
    ``f(x) = x (a + x^2) / (1 + a x^2)``, ``a = 3 sigmoid(w0)`` per channel;
    the inverse runs ``newton_iters`` Newton steps from ``x = y``."""

    @classmethod
    def build(cls, n_channels=1, channels_axis=-1, dtype=None,
              label="pade32", *, device=None):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(n_channels, channels_axis, dtype=dtype, device=device)

    def __init__(self, n_channels=1, channels_axis=-1, newton_iters=24, *,
                 dtype=None, device=None):
        super().__init__()
        self.w0 = _weights((n_channels,), -_LOG2, dtype=dtype, device=device)
        self.channels_axis = channels_axis
        self.newton_iters = newton_iters

    def _a(self, ndim):
        return 3 * torch.sigmoid(self._per_channel(self.w0, ndim))

    @staticmethod
    def _f(x, a):
        s = x * x
        return x * (a + s) / (1 + a * s)

    @staticmethod
    def _df(x, a):
        s = x * x
        return (a * s**2 + (3 - a * a) * s + a) / (1 + a * s) ** 2

    def forward(self, x, log0=0.0, *, density: bool = False):
        a = self._a(x.dim())
        logj = torch.log(self._df(x, a))
        return self._f(x, a), log0 + sum_density(logj, density)

    def backward(self, y, log0=0.0, *, density: bool = False):
        a = self._a(y.dim())
        x = y
        for _ in range(self.newton_iters):
            x = x - (self._f(x, a) - y) / self._df(x, a)
        logj = -torch.log(self._df(x, a))
        return x, log0 + sum_density(logj, density)


class SgnBias(Flow):
    """Volume-preserving discontinuous bias ``y = x + sgn(x) w^2``; valid
    only as the first layer of a flow.  ``w`` starts at 0.05, or uniform
    on [0, 0.1) from ``generator``."""

    @classmethod
    def build(cls, key=None, size=(1,), dtype=None, label="sgnbias_", *,
              device=None):
        """The JAX package's factory: ``key`` is a ``torch.Generator``
        here (``None``: the weight starts at 0.05); ``label`` is not
        kept."""
        return cls(size, generator=key, dtype=dtype, device=device)

    def __init__(self, size=(1,), *, generator=None, dtype=None,
                 device=None):
        super().__init__()
        size = tuple(size)
        if generator is None:
            w = torch.full(size, 0.05, dtype=torch.float64)
        else:
            w = torch.rand(size, generator=generator,
                           dtype=torch.float64) / 10
        self.w = nn.Parameter(w.to(dtype=dtype or torch.get_default_dtype(),
                                   device=device))

    def forward(self, x, log0=0.0, *, density: bool = False):
        return x + torch.sign(x) * self.w**2, log0 + _zero_logj(x, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return x - torch.sign(x) * self.w**2, log0 + _zero_logj(x, density)


class SplineFlow(Flow):
    """Trainable-knot monotone spline, applied elementwise.

    ``knots_len - 1`` weights give the x (and y) knots through
    softmax + cumsum, ``knots_len`` weights the derivatives through
    ``softplus_log2``; ``smooth=True`` drops the derivative weights and
    uses parameter-free derivatives.  The end knots are pinned to
    ``(xlim[0], ylim[0])`` and ``(xlim[1], ylim[1])``.  ``knots_x``,
    ``knots_y`` and ``knots_d`` fix a coordinate set (held as buffers, not
    trained); ``spline_shape`` gives one spline per trailing index of the
    data (the weights carry those leading axes); ``kind`` is ``'rqs'``
    (rational quadratic) or ``'rls'`` (rational linear); ``extrap`` augments
    the knots (``ops.spline.augment_knots``)."""

    @classmethod
    def build(cls, knots_len, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
              knots_x=None, knots_y=None, knots_d=None, spline_shape=(),
              smooth=False, extrap=None, kind="rqs", dtype=None,
              label="spline_", *, device=None):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(knots_len, xlim=xlim, ylim=ylim, knots_x=knots_x,
                   knots_y=knots_y, knots_d=knots_d,
                   spline_shape=spline_shape, smooth=smooth, extrap=extrap,
                   kind=kind, dtype=dtype, device=device)

    def __init__(self, knots_len, *, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
                 knots_x=None, knots_y=None, knots_d=None, spline_shape=(),
                 smooth=False, extrap=None, kind="rqs", dtype=None,
                 device=None):
        super().__init__()
        if knots_len < 2:
            raise ValueError("knots_len < 2 for splines")
        if kind not in ("rqs", "rls"):
            raise ValueError(f"unknown spline kind {kind!r}")
        extrap = dict(extrap or {})
        if "periodic" in extrap.values() and knots_d is None:
            # softplus derivatives are strictly positive, never zero
            raise ValueError(
                "extrap='periodic' requires fixed knots_d with zero "
                "boundary derivatives (trainable derivatives are strictly "
                "positive)")
        self.spline_shape = tuple(spline_shape)
        kw = dict(dtype=dtype, device=device)

        def init(n, fixed):
            return None if fixed is not None else _weights(
                (*self.spline_shape, n), **kw)

        self.weights_x = init(knots_len - 1, knots_x)
        self.weights_y = init(knots_len - 1, knots_y)
        self.weights_d = None if smooth else init(knots_len, knots_d)
        for name, fixed in (("fixed_knots_x", knots_x),
                            ("fixed_knots_y", knots_y),
                            ("fixed_knots_d", knots_d)):
            self.register_buffer(name, None if fixed is None else torch.as_tensor(
                np.asarray(fixed), dtype=dtype or torch.get_default_dtype(),
                device=device), persistent=False)
        self.knots_len = knots_len
        self.xlim, self.ylim = tuple(xlim), tuple(ylim)
        self.extrap = extrap
        self.kind = kind

    def make_knots(self):
        """``(kx, ky, kd)`` from the weights (or the fixed knots), then
        augmented per ``extrap``."""
        def coords(w, fixed, lim):
            if fixed is not None:
                return fixed
            return sp.knot_coords(w, lim[0], lim[1] - lim[0])

        kx = coords(self.weights_x, self.fixed_knots_x, self.xlim)
        ky = coords(self.weights_y, self.fixed_knots_y, self.ylim)
        if self.fixed_knots_d is not None:
            kd = self.fixed_knots_d
        elif self.weights_d is not None:
            kd = softplus_log2(self.weights_d)
        else:
            smooth = (sp.smooth_derivatives_rq if self.kind == "rqs"
                      else sp.smooth_derivatives_rl)
            kd = smooth(*torch.broadcast_tensors(kx, ky))
        if self.extrap:
            kx, ky, kd = sp.augment_knots(kx, ky, kd, **self.extrap)
        return kx, ky, kd

    def _spline_fn(self):
        return sp.rqs if self.kind == "rqs" else sp.rls

    def forward(self, x, log0=0.0, *, density: bool = False):
        y, g = self._spline_fn()(x, *self.make_knots())
        return y, log0 + sum_density(torch.log(g), density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        y, g = self._spline_fn()(x, *self.make_knots(), inverse=True)
        return y, log0 + sum_density(torch.log(g), density)


class SplineNet(SplineFlow):
    """The spline as a plain function: ``net(x)`` is the map and
    ``net.invert(y)`` its inverse, without log-Jacobians."""

    def __call__(self, x):
        return self._spline_fn()(x, *self.make_knots())[0]

    def invert(self, y):
        return self._spline_fn()(y, *self.make_knots(), inverse=True)[0]


class UnityDistConvertor(SplineFlow):
    """Density convertor for variables in [0, 1]; ``symmetric=True`` puts
    the spline on [0.5, 1] with an odd reflection on the left."""

    @classmethod
    def build(cls, knots_len, symmetric=False, label=None, **kwargs):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(knots_len, symmetric, **kwargs)

    def __init__(self, knots_len, symmetric=False, **kwargs):
        if symmetric:
            kwargs.setdefault("xlim", (0.5, 1.0))
            kwargs.setdefault("ylim", (0.5, 1.0))
            kwargs.setdefault("extrap", {"left": "anti"})
        super().__init__(knots_len, **kwargs)


class PhaseDistConvertor(SplineFlow):
    """Density convertor for phases in [-pi, pi]; ``symmetric=True`` puts
    the spline on [0, pi] with an odd reflection on the left."""

    @classmethod
    def build(cls, knots_len, symmetric=False, label="phase-dc_",
              **kwargs):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(knots_len, symmetric, **kwargs)

    def __init__(self, knots_len, symmetric=False, **kwargs):
        lim = (0.0, math.pi) if symmetric else (-math.pi, math.pi)
        kwargs.setdefault("xlim", lim)
        kwargs.setdefault("ylim", lim)
        if symmetric:
            kwargs.setdefault("extrap", {"left": "anti"})
        super().__init__(knots_len, **kwargs)


class DistConvertor(FlowList):
    """Density convertor for real variables: ``Expit -> SplineFlow ->
    Logit`` (no spline layers at ``knots_len <= 1``), optionally with a
    ``Scale`` first (``initial_scale``) or last (``final_scale``) and a
    ``SgnBias`` before everything (``sgnbias``, its weight drawn from
    ``generator`` if one is given).

    ``symmetric=True``, the default here, puts the spline on [0.5, 1] with
    an odd ('anti') reflection on the left, so the map is odd; every model
    the JAX package assembles passes it (``DistConvertor.build(...,
    symmetric=True)``), whose own default is ``False``.  ``symmetric=False``
    puts it on [0, 1].  Other keywords go to the spline."""

    @classmethod
    def build(cls, knots_len, symmetric=False, label="dc_", sgnbias=False,
              initial_scale=False, final_scale=False, key=None, dtype=None,
              **kwargs):
        """The JAX package's factory, with its default ``symmetric=False``;
        ``key`` is a ``torch.Generator`` here (the ``SgnBias`` weight's),
        ``label`` is not kept."""
        return cls(knots_len, symmetric=symmetric, sgnbias=sgnbias,
                   initial_scale=initial_scale, final_scale=final_scale,
                   generator=key, dtype=dtype, **kwargs)

    def __init__(self, knots_len, *, symmetric=True, smooth=False,
                 sgnbias=False, initial_scale=False, final_scale=False,
                 generator=None, dtype=None, device=None, **kwargs):
        kw = dict(dtype=dtype, device=device)
        lim = (0.5, 1.0) if symmetric else (0.0, 1.0)
        if symmetric:
            kwargs.setdefault("extrap", {"left": "anti"})
        flows = []
        if knots_len > 1:
            flows = [Expit(), SplineFlow(knots_len, xlim=lim, ylim=lim,
                                         smooth=smooth, **kwargs, **kw),
                     Logit()]
        if initial_scale:
            flows = [Scale(**kw)] + flows
        elif final_scale:
            flows = flows + [Scale(**kw)]
        if sgnbias:  # SgnBias must come first if it exists
            flows = [SgnBias(generator=generator, **kw)] + flows
        super().__init__(flows)

    def _find(self, kind):
        return next((f for f in self.flows if type(f) is kind), None)

    @property
    def spline_layer(self):
        """The ``SplineFlow`` (``None`` at ``knots_len <= 1``)."""
        return self._find(SplineFlow)

    @property
    def scale_layer(self):
        """The ``Scale``, if any."""
        return self._find(Scale)

    @property
    def sgnbias_layer(self):
        """The ``SgnBias``, if any."""
        return self._find(SgnBias)
