r"""Elementwise bijections and the distribution convertor.

Counterpart of ``normflow__tpu/models/elementwise.py``: ``softplus_log2``
(l.31-39), ``Scale`` (l.72-103), ``Expit``/``Logit`` (l.133-158),
``SplineFlow`` (l.326-423) and ``DistConvertor`` (l.473-502).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import spline as sp
from .core import Flow, FlowList, sum_density

__all__ = ["softplus_log2", "Scale", "Expit", "Logit", "SplineFlow",
           "DistConvertor"]

_LOG2 = math.log(2.0)


def softplus_log2(x):
    r"""``log(1 + 2^x) / log 2``, so that ``softplus_log2(0) = 1``.

    Exact for every ``x``: ``F.softplus`` turns linear above its threshold
    of 20, which JAX's softplus does not, so it is computed as a
    ``logaddexp`` instead."""
    return torch.logaddexp(x * _LOG2, torch.zeros_like(x)) / _LOG2


class Scale(Flow):
    """Global positive scaling ``y = w x`` with ``w = softplus_log2(weight)``
    (zero weight gives the identity)."""

    def __init__(self, *, dtype=None, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(1, dtype=dtype, device=device))

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


class SplineFlow(Flow):
    """Trainable-knot rational-quadratic spline, applied elementwise.

    ``knots_len - 1`` weights give the x (and y) knots through
    softmax + cumsum, ``knots_len`` weights the derivatives through
    ``softplus_log2``; ``smooth=True`` drops the derivative weights and
    uses slope-averaged derivatives.  The end knots are pinned to
    ``(xlim[0], ylim[0])`` and ``(xlim[1], ylim[1])``; ``extrap`` augments
    the knots (``ops.spline.augment_knots``)."""

    def __init__(self, knots_len, *, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
                 smooth=False, extrap=None, dtype=None, device=None):
        super().__init__()
        if knots_len < 2:
            raise ValueError("knots_len < 2 for splines")

        def init(n):
            return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))

        self.weights_x = init(knots_len - 1)
        self.weights_y = init(knots_len - 1)
        self.weights_d = None if smooth else init(knots_len)
        self.knots_len = knots_len
        self.xlim, self.ylim = tuple(xlim), tuple(ylim)
        self.extrap = dict(extrap or {})

    def make_knots(self):
        kx = sp.knot_coords(self.weights_x, self.xlim[0],
                            self.xlim[1] - self.xlim[0])
        ky = sp.knot_coords(self.weights_y, self.ylim[0],
                            self.ylim[1] - self.ylim[0])
        if self.weights_d is not None:
            kd = softplus_log2(self.weights_d)
        else:
            kd = sp.smooth_derivatives_rq(kx, ky)
        if self.extrap:
            kx, ky, kd = sp.augment_knots(kx, ky, kd, **self.extrap)
        return kx, ky, kd

    def forward(self, x, log0=0.0, *, density: bool = False):
        y, g = sp.rqs(x, *self.make_knots())
        return y, log0 + sum_density(torch.log(g), density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        y, g = sp.rqs(x, *self.make_knots(), inverse=True)
        return y, log0 + sum_density(torch.log(g), density)


class DistConvertor(FlowList):
    """Convertor for real variables: ``Expit -> SplineFlow -> Logit``,
    optionally followed by a final ``Scale``.  Only the symmetric form is
    ported (``DistConvertor.build(..., symmetric=True)`` in the JAX
    package): the spline lives on ``[0.5, 1]`` with an odd ('anti')
    reflection on the left."""

    def __init__(self, knots_len, *, smooth=False, final_scale=False,
                 dtype=None, device=None):
        spl = SplineFlow(knots_len, xlim=(0.5, 1.0), ylim=(0.5, 1.0),
                         extrap={"left": "anti"}, smooth=smooth, dtype=dtype,
                         device=device)
        flows = [Expit(), spl, Logit()]
        if final_scale:
            flows.append(Scale(dtype=dtype, device=device))
        super().__init__(flows)
