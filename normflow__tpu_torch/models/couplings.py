r"""Mask-based coupling flows: shift, affine and rational-quadratic spline.

Counterpart of ``normflow__tpu/models/couplings.py:36-350``.  Net ``k``
reads the frozen partition and parameterises the transform of partition
``k % 2``.  The data keeps the JAX package's layout, ``(B, *lat)`` (with
any trailing channel axes); the conditioner is a PyTorch module on NCHW
data, fed the frozen partition with a channel axis 1 in front of the
lattice, and emits its transform parameters on axis 1: 2 channels for the
affine ``(t, s)``, ``3m - 2`` for an ``m``-knot spline.

``RQSplineCoupling`` routes as the JAX package's ``_can_fuse`` does: with
free knots and ``None`` or ``'linear'`` sides the conditioner output goes
straight to the fused coupling kernel's wrapper (``ops.kernels.
rqs_coupling``, which dispatches on the tensor's device and raises on the
card for a knot count it was not built for); fixed knots and the
reflecting extrapolations take the plain ``ops.spline.rqs`` on either
device, as the JAX package's XLA branch does.  Its ``backend``, fixed at
construction as in the JAX package, picks the layout: ``"xla"`` (the
default) and ``"pallas"`` run the conditioners NCHW, whose output takes
the NCHW kernels; ``"pallas_reg"`` (JAX: the kernels read the conv's
channels-last output and transpose in registers) hands the conditioner
the frozen partition channels-last, a view with no copy, which the conv
stack keeps (``models/nets.py``), and its output goes to the wrapper as it
comes, which takes the channels-last kernels.  The route takes every
lattice rank the conv stack does, 1 to 4, as the JAX package's does: the
kernels read one flat run of sites, whatever the rank.

The controlled couplings (``couplings.py:356-531``): a
:class:`DirectCntrCoupling` maps ``(x, control)``, its first layer
conditioned on the control instead of the other partition; a
:class:`CntrCoupling` keeps its control as a buffer (not a parameter:
never trained) that :meth:`CntrCoupling.refresh_control` draws from its
``control_generator(generator, batch_size)`` (JAX: ``(key,
batch_size)``) into the same tensor whenever the shape holds, so that a
captured training step that draws it keeps writing and reading one
address.  :func:`refresh_controls` draws every ``CntrCoupling`` of a flow
(the ``Fitter`` does so before every step), :func:`has_controls` says
whether there is one; both find one inside a plain list or dict too.

``Coupling.transfer`` and ``Coupling.grow`` (``normflow__tpu/models/
couplings.py:95-117``) return new couplings: on another lattice's mask,
and with conditioners appended whose last layer is zero, so that the grown
flow computes the same map.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..ops import spline as sp
from ..ops.kernels.spline_coupling import rqs_coupling
from .core import Flow, sum_density
from .elementwise import softplus_log2

__all__ = ["Coupling", "ShiftCoupling", "AffineCoupling", "RQSplineCoupling",
           "MultiRQSplineCoupling", "DirectCntrCoupling", "CntrCoupling",
           "CntrShiftCoupling", "CntrAffineCoupling", "CntrRQSplineCoupling",
           "CntrMultiRQSplineCoupling", "refresh_controls", "has_controls"]


class Coupling(Flow):
    """Base coupling: ``mask.split(x) -> (x0, x1, *extra)``, net ``k``
    transforms partition ``k % 2`` from the other one, and ``mask.cat``
    reassembles, with any ``extra`` parts of the split (``DoubleMask``'s
    invisible partition) passed through untouched."""

    def __init__(self, nets, *, mask):
        super().__init__()
        self.nets = nn.ModuleList(nets)
        self.mask = mask

    def forward(self, x, log0=0.0, *, density: bool = False):
        return self._layers(x, log0, density, inverse=False)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return self._layers(x, log0, density, inverse=True)

    def _layers(self, x, log0, density, inverse, control=None):
        """Every layer in order, or in reverse order for ``inverse``; the
        first layer's frozen input is ``control`` where one is given
        (:class:`DirectCntrCoupling`)."""
        parts = list(self.mask.split(x))
        x, extra = parts[:2], parts[2:]
        atomic = self.atomic_backward if inverse else self.atomic_forward
        order = range(len(self.nets))
        for k in (reversed(order) if inverse else order):
            parity = k % 2
            frozen = control if k == 0 and control is not None \
                else x[1 - parity]
            x[parity], log0 = atomic(
                x_active=x[parity], x_frozen=frozen, parity=parity,
                net=self.nets[k], log0=log0, density=density)
        return self.mask.cat(*x, *extra), log0

    def atomic_forward(self, *, x_active, x_frozen, parity, net, log0,
                       density):
        raise NotImplementedError

    def atomic_backward(self, *, x_active, x_frozen, parity, net, log0,
                        density):
        raise NotImplementedError

    @staticmethod
    def preprocess_fz(x):
        """The frozen partition as a one-channel NCHW input."""
        return x.unsqueeze(1)

    def transfer(self, mask=None, **kwargs):
        """A new coupling with every conditioner transferred (``kwargs``)
        and, if given, ``mask`` (the new lattice's) in place of this one's."""
        new = copy.deepcopy(self)
        new.nets = nn.ModuleList(net.transfer(**kwargs) for net in self.nets)
        if mask is not None:
            new.mask = mask
        return new

    def grow(self, new_nets):
        """A new coupling with ``new_nets`` appended as near-identity
        layers: each one's last layer is zeroed (``zeroed_final``), and a
        zero conditioner output is the identity of every coupling here
        (shift 0; affine ``t = s = 0``; uniform knots with unit
        derivatives for the spline, to round-off), so the grown flow
        computes the same map while the zeroed layers still get
        gradients.  The existing conditioners keep their indices, and so
        their parities."""
        new = copy.deepcopy(self)
        new.nets.extend(net.zeroed_final() for net in new_nets)
        return new


def _zero_logj(x, density):
    if density:
        return torch.zeros_like(x)
    return torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)


class ShiftCoupling(Coupling):
    """Additive coupling ``y = x + t(frozen)``, ``logJ = 0``; ``t`` is the
    conditioner's channel 0."""

    def _shift(self, x_frozen, net):
        return net(self.preprocess_fz(x_frozen))[:, 0]

    def atomic_forward(self, *, x_active, x_frozen, parity, net, log0,
                       density):
        y = self.mask.purify(x_active + self._shift(x_frozen, net),
                             channel=parity)
        return y, log0 + _zero_logj(x_active, density)

    def atomic_backward(self, *, x_active, x_frozen, parity, net, log0,
                        density):
        y = self.mask.purify(x_active - self._shift(x_frozen, net),
                             channel=parity)
        return y, log0 + _zero_logj(x_active, density)


class AffineCoupling(Coupling):
    r"""Affine coupling ``y = t + x e^{-s}``, ``logJ = -sum s``: ``t`` and
    ``s`` are the first channels of the two halves of the conditioner's
    channels (channels 0 and 1 of a two-channel net), ``s <- |s|``, both
    purified by the mask."""

    def _params(self, x_frozen, parity, net):
        out = net(self.preprocess_fz(x_frozen))
        half = out.shape[1] // 2
        t = self.mask.purify(out[:, 0], channel=parity)
        s = self.mask.purify(out[:, half], channel=parity)
        return t, torch.abs(s)

    def atomic_forward(self, *, x_active, x_frozen, parity, net, log0,
                       density):
        t, s = self._params(x_frozen, parity, net)
        return t + x_active * torch.exp(-s), log0 - sum_density(s, density)

    def atomic_backward(self, *, x_active, x_frozen, parity, net, log0,
                        density):
        t, s = self._params(x_frozen, parity, net)
        return (x_active - t) * torch.exp(s), log0 + sum_density(s, density)


def _fixed(cache, name, a, out):
    """The fixed knots ``a`` on ``out``'s device and dtype, kept in
    ``cache`` under ``name`` for each device and dtype (a CUDA graph must
    not copy from the host)."""
    if a is None:
        return None
    key = (name, out.device, out.dtype)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(a), dtype=out.dtype,
                                     device=out.device)
    return cache[key]


def _knots_from_net_out(out, *, xlim, ylim, xwidth, ywidth, fixed_x,
                        fixed_y, extrap):
    """Per-site knots from the net's channels on the last axis of ``out``:
    ``(m-1, m-1, m)`` slices for the x knots, the y knots and the
    derivatives, or ``(m-1, m)`` where one coordinate set is fixed, or the
    derivatives alone; softmax + cumsum coordinates in the box,
    ``softplus_log2`` derivatives, then the augmentation ``extrap``."""
    n = out.shape[-1]
    if fixed_x is None and fixed_y is None:
        m = (n + 2) // 3
        x_, y_, d_ = torch.split(out, [m - 1, m - 1, m], dim=-1)
        kx = sp.knot_coords(x_, xlim[0], xwidth)
        ky = sp.knot_coords(y_, ylim[0], ywidth)
    elif fixed_y is None:
        m = (n + 2) // 2
        y_, d_ = torch.split(out, [m - 1, m], dim=-1)
        kx, ky = fixed_x, sp.knot_coords(y_, ylim[0], ywidth)
    elif fixed_x is None:
        m = (n + 2) // 2
        x_, d_ = torch.split(out, [m - 1, m], dim=-1)
        kx, ky = sp.knot_coords(x_, xlim[0], xwidth), fixed_y
    else:
        kx, ky, d_ = fixed_x, fixed_y, out
    kd = softplus_log2(d_)
    if extrap:
        kx, ky, kd = sp.augment_knots(kx, ky, kd, **dict(extrap))
    return kx, ky, kd


class RQSplineCoupling(Coupling):
    """Coupling with per-site RQ splines: the net emits ``3m - 2`` channels
    for ``m`` free knots (``2m - 1`` with ``knots_x`` or ``knots_y`` fixed,
    ``m`` with both); ``extrap`` sides are ``None``, ``'linear'``,
    ``'anti'``, ``'anti-periodic'`` or ``'periodic'``.  See the module
    docstring for the route."""

    BACKENDS = ("xla", "pallas", "pallas_reg")

    @classmethod
    def build(cls, nets, *, mask, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
              knots_x=None, knots_y=None, extrap=None, backend="xla",
              label="rqs_coupling_"):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(nets, mask=mask, xlim=xlim, ylim=ylim, knots_x=knots_x,
                   knots_y=knots_y, extrap=extrap, backend=backend)

    def __init__(self, nets, *, mask, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
                 knots_x=None, knots_y=None, extrap=None, backend="xla"):
        super().__init__(nets, mask=mask)
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {self.BACKENDS}")
        self.xlim, self.ylim = tuple(xlim), tuple(ylim)
        self.extrap = dict(extrap or {})
        self.knots_x, self.knots_y = knots_x, knots_y
        self._backend = backend
        self._knots = {}

    @property
    def backend(self):
        """``"xla"``, ``"pallas"`` or ``"pallas_reg"``, fixed at
        construction (module docstring): a captured graph of one route
        never replays for another."""
        return self._backend

    def _can_fuse(self):
        """Whether the fused kernel's wrapper takes this coupling."""
        return (self.knots_x is None and self.knots_y is None
                and self.extrap.get("left") in (None, "linear")
                and self.extrap.get("right") in (None, "linear"))

    def make_knots(self, out):
        """Per-site knots of the conditioner output ``out``
        ``(B, C, *lat)``, knots on the last axis."""
        return _knots_from_net_out(
            out.movedim(1, -1), xlim=self.xlim, ylim=self.ylim,
            xwidth=self.xlim[1] - self.xlim[0],
            ywidth=self.ylim[1] - self.ylim[0],
            fixed_x=_fixed(self._knots, "x", self.knots_x, out),
            fixed_y=_fixed(self._knots, "y", self.knots_y, out),
            extrap=self.extrap)

    def _net_input(self, x_frozen):
        """The conditioner's input: :meth:`preprocess_fz`, or on the
        ``pallas_reg`` route the same values channels-last, strides
        ``(S, 1, ...)`` for ``S`` sites (``(H W, 1, W, 1)`` at 2-D), a view
        of the contiguous partition, at any lattice rank."""
        if self._backend != "pallas_reg":
            return self.preprocess_fz(x_frozen)
        return x_frozen.contiguous().unsqueeze(-1).movedim(-1, 1)

    def _transform(self, x_active, x_frozen, parity, net, inverse):
        out = net(self._net_input(x_frozen))
        if self._can_fuse():
            fx, logg = rqs_coupling(
                x_active.contiguous(),
                out if self._backend == "pallas_reg" else out.contiguous(),
                xlim=self.xlim, ylim=self.ylim, left=self.extrap.get("left"),
                right=self.extrap.get("right"), inverse=inverse)
        else:
            fx, g = sp.rqs(x_active, *self.make_knots(out), inverse=inverse)
            logg = torch.log(g)
        return (self.mask.purify(fx, channel=parity),
                self.mask.purify(logg, channel=parity))

    def atomic_forward(self, *, x_active, x_frozen, parity, net, log0,
                       density):
        fx, logg = self._transform(x_active, x_frozen, parity, net, False)
        return fx, log0 + sum_density(logg, density)

    def atomic_backward(self, *, x_active, x_frozen, parity, net, log0,
                        density):
        fx, logg = self._transform(x_active, x_frozen, parity, net, True)
        return fx, log0 + sum_density(logg, density)


class MultiRQSplineCoupling(Coupling):
    """One RQ spline per input channel, on the plain spline.  The data
    carries ``num_splines`` trailing channels, ``(B, *lat, c)``; the net
    takes the frozen partition with those channels on axis 1, and its
    output channels split evenly into one knot group per spline."""

    @classmethod
    def build(cls, nets, *, mask, xlims=((0.0, 1.0), (0.0, 1.0)),
              ylims=((0.0, 1.0), (0.0, 1.0)), knots_x=None, knots_y=None,
              extraps=None, label="multi_rqs_coupling_"):
        """The JAX package's factory (``label`` is not kept)."""
        return cls(nets, mask=mask, xlims=xlims, ylims=ylims,
                   knots_x=knots_x, knots_y=knots_y, extraps=extraps)

    def __init__(self, nets, *, mask, xlims=((0.0, 1.0), (0.0, 1.0)),
                 ylims=((0.0, 1.0), (0.0, 1.0)), knots_x=None, knots_y=None,
                 extraps=None):
        super().__init__(nets, mask=mask)
        n = len(xlims)
        self.xlims = tuple(map(tuple, xlims))
        self.ylims = tuple(map(tuple, ylims))
        self.knots_x = tuple(knots_x or [None] * n)
        self.knots_y = tuple(knots_y or [None] * n)
        self.extraps = tuple(dict(e or {}) for e in (extraps or [{}] * n))
        self._knots = {}

    @property
    def num_splines(self):
        return len(self.xlims)

    def _transform(self, x_active, x_frozen, parity, net, inverse):
        out = net(x_frozen.movedim(-1, 1)).movedim(1, -1)
        fxs, loggs = [], []
        for i, (xi, oi) in enumerate(zip(
                x_active.chunk(self.num_splines, dim=-1),
                out.chunk(self.num_splines, dim=-1))):
            kx, ky, kd = _knots_from_net_out(
                oi, xlim=self.xlims[i], ylim=self.ylims[i],
                xwidth=self.xlims[i][1] - self.xlims[i][0],
                ywidth=self.ylims[i][1] - self.ylims[i][0],
                fixed_x=_fixed(self._knots, ("x", i), self.knots_x[i], out),
                fixed_y=_fixed(self._knots, ("y", i), self.knots_y[i], out),
                extrap=self.extraps[i])
            # the knots broadcast over the channel slice
            fx, g = sp.rqs(xi, kx[..., None, :], ky[..., None, :],
                           kd[..., None, :], inverse=inverse)
            fxs.append(fx)
            loggs.append(torch.log(g))
        return (self.mask.purify(torch.cat(fxs, dim=-1), channel=parity),
                self.mask.purify(torch.cat(loggs, dim=-1), channel=parity))

    atomic_forward = RQSplineCoupling.atomic_forward
    atomic_backward = RQSplineCoupling.atomic_backward


# --------------------------------------------------------------------- #
# controlled couplings
# --------------------------------------------------------------------- #
class DirectCntrCoupling(Flow):
    """A coupling whose first layer's frozen input is an external control:
    ``forward((x, control)) -> ((y, control), log0 + logJ)``, and
    ``backward`` alike; ``coupling`` is any :class:`Coupling`."""

    def __init__(self, coupling):
        super().__init__()
        self.coupling = coupling

    def forward(self, x_and_control, log0=0.0, *, density: bool = False):
        x, control = x_and_control
        y, log0 = self.coupling._layers(x, log0, density, False, control)
        return (y, control), log0

    def backward(self, x_and_control, log0=0.0, *, density: bool = False):
        x, control = x_and_control
        y, log0 = self.coupling._layers(x, log0, density, True, control)
        return (y, control), log0


class CntrCoupling(Flow):
    """A controlled coupling with a stored control (the ``control``
    buffer; ``None`` until drawn).  ``control_generator(generator,
    batch_size)`` returns a fresh control; sampling uses the stored one and
    never draws.  The JAX leaf order is the coupling's, then the control
    (``leaf_order``)."""

    leaf_order = ("coupling", "control")

    def __init__(self, coupling, control=None, control_generator=None):
        super().__init__()
        self.coupling = coupling
        self.register_buffer("control", control)
        self.control_generator = control_generator

    @torch.no_grad()
    def refresh_control(self, generator, batch_size: int):
        """Draw a new control from ``generator`` into the buffer, in place
        when its shape, dtype and device hold; returns ``self``."""
        if self.control_generator is None:
            raise ValueError(
                "CntrCoupling.refresh_control needs a control_generator "
                "(a callable (generator, batch_size) -> control tensor)")
        new = self.control_generator(generator, batch_size)
        old = self.control
        if old is not None and (old.shape, old.dtype, old.device) == (
                new.shape, new.dtype, new.device):
            old.copy_(new)
        else:
            self.control = new.detach().clone()
        return self

    def _control(self):
        if self.control is None:
            raise ValueError(
                "CntrCoupling has no control tensor: call "
                "refresh_control(generator, batch_size) first (the Fitter "
                "does this when a control_generator is set)")
        return self.control

    def forward(self, x, log0=0.0, *, density: bool = False):
        return self.coupling._layers(x, log0, density, False,
                                     self._control())

    def backward(self, x, log0=0.0, *, density: bool = False):
        return self.coupling._layers(x, log0, density, True,
                                     self._control())

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a stored control of another shape, or one this coupling has not
        # drawn yet, takes a buffer of its own shape first
        value = state_dict.get(prefix + "control")
        if value is not None and (self.control is None
                                  or self.control.shape != value.shape):
            device = next(self.coupling.parameters(), value).device
            self.control = torch.empty_like(value, device=device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _cntr_couplings(node, seen=None):
    """Every :class:`CntrCoupling` with a control generator under
    ``node``: through registered submodules and through plain lists,
    tuples and dicts held by a module (``_map_container``'s case in
    JAX)."""
    seen = set() if seen is None else seen
    if isinstance(node, nn.Module):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, CntrCoupling) and \
                node.control_generator is not None:
            yield node
        children = [*node._modules.values(),
                    *(v for v in vars(node).values()
                      if isinstance(v, (list, tuple, dict)))]
        for child in children:
            yield from _cntr_couplings(child, seen)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _cntr_couplings(v, seen)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _cntr_couplings(v, seen)


def has_controls(flow) -> bool:
    """Whether ``flow`` holds a ``CntrCoupling`` with a control
    generator."""
    return next(_cntr_couplings(flow), None) is not None


def refresh_controls(flow, generator, batch_size: int):
    """Draw a fresh control for every ``CntrCoupling`` of ``flow`` from
    ``generator``, one after the other, each in place where its shape
    holds; returns ``flow``."""
    for c in list(_cntr_couplings(flow)):
        c.refresh_control(generator, batch_size)
    return flow


def CntrShiftCoupling(nets, *, mask, control_generator=None, **kwargs):
    return CntrCoupling(ShiftCoupling(nets, mask=mask, **kwargs),
                        control_generator=control_generator)


def CntrAffineCoupling(nets, *, mask, control_generator=None, **kwargs):
    return CntrCoupling(AffineCoupling(nets, mask=mask, **kwargs),
                        control_generator=control_generator)


def CntrRQSplineCoupling(nets, *, mask, control_generator=None, **kwargs):
    return CntrCoupling(RQSplineCoupling(nets, mask=mask, **kwargs),
                        control_generator=control_generator)


def CntrMultiRQSplineCoupling(nets, *, mask, control_generator=None,
                              **kwargs):
    return CntrCoupling(MultiRQSplineCoupling(nets, mask=mask, **kwargs),
                        control_generator=control_generator)
