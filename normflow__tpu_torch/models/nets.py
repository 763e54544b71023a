"""Conditioner nets: circular convolutions, conv stacks, linear stacks.

Counterpart of ``normflow__tpu/models/nets.py``: ``ACTIVATIONS``,
``CircularConv`` (1-4 spatial dims, per-layer dilation), ``ConvNet``,
``RowParityFeature``, ``Dense``, ``PlusBias`` and ``LinearNet``.  Data here
is NCHW, PyTorch's layout; conv weights are OIHW and ``Dense`` weights
``(out, in)`` (the JAX package keeps channels last, HWIO and ``(in, out)``
weights; ``utils.transplant`` converts).  A 4-D conv is the sum of 3-D
convs of the input rolled along the first lattice axis, as in the JAX
package (neither cuDNN nor XLA has a native 4-D conv).

Channels-last data (each site's channels one contiguous run, strides
``(S C, 1, ..., C)`` for ``S`` sites: the ``pallas_reg`` route of
``models/couplings.py``, which hands the conditioner its input so) stays
channels-last through ``CircularConv`` and ``RowParityFeature`` at every
lattice rank, 1 to 4: the periodic pad is copied into a channels-last
tensor as ATen pads NCHW data, the parity plane concatenated on the
channels-last view (``F.pad``'s circular mode and ``torch.cat`` return
NCHW), and cuDNN's 2-D and 3-D convs (NHWC, NDHWC), the activations and
the dtype casts keep the layout of their input; the weights keep their own
(OIHW) layout.  PyTorch copies a 1-D conv's input to NCL, so a 1-D conv
runs as a 2-D conv over a unit axis in front of the lattice axis (free
views of the channels-last data both ways).  A channels-last 4-D conv
convolves the free view ``(B L0, C, L1, L2, L3)`` once, with the ``k0``
kernel slices stacked on the output channels, and sums slice ``i``'s
output rolled along the first lattice axis (a roll commutes with a conv
that acts on each ``(b, l0)`` slice alone), in the JAX package's order
``i = 0 ... k0 - 1``; the NCHW 4-D conv rolls and copies its input for
each slice.  On the CPU a float64 conv returns NCHW, which the next layer
takes as it comes.

Under a space axis (``parallel/space.py``) a conv on a slab reads the
``dilation (k - 1) / 2`` lattice rows before and after it along the first
lattice axis from the ranks that hold them (``space.halo``, whose backward
returns their cotangents) in place of the periodic wrap, on a slab of any
height, an empty one included, and ``RowParityFeature`` takes the parity
of the global row.

The conv nets and ``LinearNet`` have ``zeroed()`` (every weight zero),
``zeroed_final()`` (the last layer zero: the net outputs zeros, so a
coupling on it is the identity, while the hidden layers keep their weights
and the zeroed layer a nonzero gradient) and ``transfer()`` (a copy: their
weights do not depend on the lattice), each returning a new module
(``normflow__tpu/models/nets.py:224-240, 263-270, 356-368``).

A ``ConvNet`` with a ``compute_dtype`` (``torch.bfloat16``, or its JAX
name ``'bfloat16'``) casts its input and every weight to that dtype at
each call, runs the stack there and casts the result back to the caller's
dtype; the weights stay in their own dtype (``normflow__tpu/models/
nets.py:160-222``).  Its convs then do what ``lax.conv_general_dilated``
does in a reduced dtype: the conv in that dtype, the bias added after it,
in that dtype too (the bias inside ``F.conv2d`` rounds differently).
``fuse_out_cast`` makes the last layer emit the caller's dtype directly,
JAX's ``preferred_element_type``: PyTorch has none, so that conv runs in
float32 on the rounded input and weights with TF32 off, whose products of
bf16 values are exact in float32.
"""

from __future__ import annotations

import contextlib
import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lattice import channels_last, neighbor_mean
from ..parallel import space

__all__ = ["ACTIVATIONS", "CircularConv", "ConvNet", "RowParityFeature",
           "Dense", "PlusBias", "LinearNet"]


def _avg_neighbor_pool(x):
    # the lattice axes of NCHW data: all but the batch and channel axes
    return neighbor_mean(x, axes=range(2, x.dim()))


ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leaky_relu": F.leaky_relu,  # slope 0.01, as jax.nn.leaky_relu
    # exact for every x, as JAX's (F.softplus turns linear above 20)
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "avg_neighbor_pool": _avg_neighbor_pool,
    "abs": torch.abs,
    "expit": torch.sigmoid,
    "logit": lambda x: torch.log(x) - torch.log1p(-x),
    "none": lambda x: x,
}

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _circular_pad_channels_last(x, pad):
    """``F.pad(x, pad, mode="circular")`` of channels-last ``x``, returned
    channels-last (``pad`` lists the last lattice axis first, as ``F.pad``
    does), as ATen pads NCHW data: ``x`` copied into the middle of a new
    tensor, then each axis's wraps copied from inside it, each over the
    whole extent of the other axes."""
    n_pad = len(pad) // 2
    dims = range(x.dim() - 1, x.dim() - 1 - n_pad, -1)
    shape = list(x.shape)
    for i, d in enumerate(dims):
        shape[d] += pad[2 * i] + pad[2 * i + 1]
    out = x.new_empty([shape[0], *shape[2:], shape[1]]).movedim(-1, 1)
    middle = out
    for i, d in enumerate(dims):
        middle = middle.narrow(d, pad[2 * i], x.shape[d])
    middle.copy_(x)
    for i, d in enumerate(dims):
        lo, hi, n = pad[2 * i], pad[2 * i + 1], x.shape[d]
        if lo:
            out.narrow(d, 0, lo).copy_(out.narrow(d, n, lo))
        if hi:
            out.narrow(d, lo + n, hi).copy_(out.narrow(d, lo, hi))
    return out


def _uniform(shape, bound, generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return nn.Parameter(((2 * u - 1) * bound).to(
        dtype=dtype or torch.get_default_dtype(), device=device))


def _zeroed(module, part=None):
    """A copy of ``module`` with every weight of ``part(copy)`` (default:
    the whole copy) set to zero."""
    new = copy.deepcopy(module)
    with torch.no_grad():
        for p in (new if part is None else part(new)).parameters():
            p.zero_()
    return new


def _final_part(net):
    """What ``zeroed_final`` zeroes, as one module: the last layer and the
    ``final_bias`` (if any), those of the wrapped net through a
    ``RowParityFeature``."""
    if isinstance(net, RowParityFeature):
        return _final_part(net.net)
    parts = [net.layers[-1]]
    if getattr(net, "final_bias", None) is not None:
        parts.append(net.final_bias)
    return nn.ModuleList(parts)


class _Transferable:
    """``zeroed``, ``zeroed_final`` and ``transfer`` (see the module
    docstring)."""

    def zeroed(self):
        return _zeroed(self)

    def zeroed_final(self):
        return _zeroed(self, _final_part)

    def transfer(self, **kwargs):
        return copy.deepcopy(self)


class CircularConv(nn.Module):
    """One conv layer with periodic padding, 1-4 spatial dims;
    ``dilation`` spaces the taps that many sites apart.

    Weights start Kaiming-uniform with bound ``1/sqrt(fan_in)``, PyTorch's
    conv default and the JAX package's init (``nets.py:49-61``)."""

    @classmethod
    def build(cls, key, in_channels, out_channels, kernel_size, conv_dim=2,
              bias=True, dtype=None, dilation=1, *, device=None):
        """The JAX package's factory; ``key`` is the ``torch.Generator``
        the weights are drawn from."""
        return cls(in_channels, out_channels, kernel_size, conv_dim=conv_dim,
                   bias=bias, dilation=dilation, generator=key, dtype=dtype,
                   device=device)

    def __init__(self, in_channels, out_channels, kernel_size, *, conv_dim=2,
                 bias=True, dilation=1, generator=None, dtype=None,
                 device=None):
        super().__init__()
        ks = ((kernel_size,) * conv_dim if isinstance(kernel_size, int)
              else tuple(kernel_size))
        if len(ks) != conv_dim or not 1 <= conv_dim <= 4:
            raise ValueError(f"conv_dim {conv_dim} with kernel {ks}")
        bound = 1.0 / math.sqrt(in_channels * math.prod(ks))
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.weight = _uniform((out_channels, in_channels, *ks), bound, **kw)
        self.bias = _uniform((out_channels,), bound, **kw) if bias else None
        self.conv_dim = conv_dim
        self.dilation = int(dilation)

    def _convnd(self, x, w, bias=None, slab=None):
        # periodic 'same' padding of the dilated extent e = (k-1) d + 1,
        # split ((e-1)//2, e//2) as in the JAX package; F.pad lists the
        # last spatial dim first.  On a slab (parallel/space.py) the first
        # lattice axis takes its neighbours' rows instead of wrapping
        d = self.dilation
        pad = []
        for k in reversed(w.shape[2:]):
            pad += [((k - 1) * d) // 2, ((k - 1) * d + 1) // 2]
        if slab is not None:
            x = space.halo(x, 2, pad[-2], pad[-1], slab)
            pad[-2:] = [0, 0]
            if not slab.rows:
                # an empty slab: a zero row more makes one output row, which
                # goes, so that the weights and the halo stay in the graph
                # (every rank runs the halo's backward)
                x = F.pad(x, [0, 0] * (x.dim() - 3) + [0, 1])
                return self._conv_padded(x, w, bias, pad).narrow(2, 0, 0)
        return self._conv_padded(x, w, bias, pad)

    def _conv_padded(self, x, w, bias, pad):
        d = self.dilation
        if not channels_last(x):
            x = F.pad(x, pad, mode="circular")
            return _CONV[w.dim() - 2](x, w, bias, dilation=d)
        x = _circular_pad_channels_last(x, pad)
        if w.dim() > 3:
            return _CONV[w.dim() - 2](x, w, bias, dilation=d)
        # (B, C, L) as (B, C, 1, L): ATen would copy it to NCL
        return F.conv2d(x.unsqueeze(2), w.unsqueeze(2), bias,
                        dilation=(1, d)).squeeze(2)

    def _conv4d(self, x, w, slab=None):
        # sum over the first kernel axis of 3-D convs of the input rolled
        # along the first lattice axis, which goes into the batch; on a
        # slab the roll reads the halo rows
        if slab is None and channels_last(x):
            return self._conv4d_channels_last(x, w)
        b, c, l0, *rest = x.shape
        k0 = w.shape[2]
        shifts = [(i - (k0 - 1) // 2) * self.dilation for i in range(k0)]
        if slab is not None:
            lo, hi = -min(shifts), max(shifts)
            xp = space.halo(x, 2, lo, hi, slab)
        y = 0.0
        for i, shift in enumerate(shifts):
            if slab is None:
                xi = torch.roll(x, -shift, dims=2)
            else:
                xi = xp.narrow(2, lo + shift, l0)
            xi = xi.transpose(1, 2)
            yi = self._convnd(xi.reshape(b * l0, c, *rest), w[:, :, i])
            y = y + yi.reshape(b, l0, *yi.shape[1:]).transpose(1, 2)
        return y

    def _conv4d_channels_last(self, x, w):
        # one 3-D conv of the free view (B L0, C, L1, L2, L3), kernel slice
        # i's outputs at channels [i O, (i + 1) O); slice i's output rolled
        # by its shift along L0 and summed in JAX's order, on the
        # channels-last view (B, L0, L1, L2, L3, O)
        b, c, l0, *rest = x.shape
        o, k0 = w.shape[0], w.shape[2]
        w3 = w.movedim(2, 0).reshape(k0 * o, c, *w.shape[3:])
        z = self._convnd(x.movedim(1, -1).reshape(b * l0, *rest, c)
                         .movedim(-1, 1), w3)
        z = z.movedim(1, -1).reshape(b, l0, *rest, k0, o)
        y = None
        for i in range(k0):
            s = ((i - (k0 - 1) // 2) * self.dilation) % l0
            zi = z[..., i, :]
            if s:
                zi = torch.cat([zi[:, s:], zi[:, :s]], 1)
            y = zi if y is None else y + zi
        return y.contiguous().movedim(-1, 1)  # a copy only if none rolled

    def forward(self, x, out_dtype=None):
        """The conv of ``x`` with the weights cast to ``x``'s dtype.  In
        the weights' own dtype the bias goes into the conv, as before; in
        another one (a ``ConvNet``'s compute dtype) it is added after it.
        ``out_dtype``: emit that dtype, the conv in float32 on the rounded
        operands (see the module docstring)."""
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        slab = space.current()
        if x.dtype == self.weight.dtype and out_dtype is None:
            if self.conv_dim < 4:
                return self._convnd(x, w, b, slab)
            y = self._conv4d(x, w, slab)
            return y if b is None else y + b.reshape(-1, 1, 1, 1, 1)
        if out_dtype is not None:
            x, w = x.to(out_dtype), w.to(out_dtype)
            b = None if b is None else b.to(out_dtype)
        with _no_tf32() if out_dtype is not None else \
                contextlib.nullcontext():
            y = self._convnd(x, w, slab=slab) if self.conv_dim < 4 \
                else self._conv4d(x, w, slab)
        if b is None:
            return y
        return y + b.reshape(-1, *([1] * (y.dim() - 2)))


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's convs without TF32 inside the block."""
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def _as_dtype(dtype):
    """A torch dtype from itself or its name (``'bfloat16'``, as the JAX
    package spells it); ``None`` stays ``None``."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _per_layer(value, n):
    if value is None:
        return (1,) * n
    if isinstance(value, int):
        return (value,) * n
    value = tuple(value)
    if len(value) != n:
        raise ValueError(f"{len(value)} dilations for {n} layers")
    return value


class ConvNet(_Transferable, nn.Module):
    """Stack of circular conv layers, one activation name (or ``None``)
    per layer, sizes ``[in_channels, *hidden_sizes, out_channels]``, an
    optional ``pre_act``, per-layer ``dilations`` (an int or one per
    layer) and a ``compute_dtype`` (``None``: the weights' own), with
    ``fuse_out_cast`` (default ``False``, as in JAX) for the last layer
    (see the module docstring)."""

    @classmethod
    def build(cls, key, in_channels, out_channels, kernel_size, conv_dim=2,
              hidden_sizes=(), acts=(None,), pre_act=None, bias=True,
              dtype=None, compute_dtype=None, dilations=None, *,
              device=None):
        """The JAX package's factory; ``key`` is the ``torch.Generator``
        the weights are drawn from."""
        return cls(in_channels, out_channels, kernel_size, conv_dim=conv_dim,
                   hidden_sizes=hidden_sizes, acts=acts, pre_act=pre_act,
                   bias=bias, dilations=dilations,
                   compute_dtype=compute_dtype, generator=key, dtype=dtype,
                   device=device)

    def __init__(self, in_channels, out_channels, kernel_size, *, conv_dim=2,
                 hidden_sizes=(), acts=(None,), pre_act=None, bias=True,
                 dilations=None, compute_dtype=None, generator=None,
                 dtype=None, device=None):
        super().__init__()
        sizes = [in_channels, *hidden_sizes, out_channels]
        acts = tuple(acts)
        if len(acts) != len(hidden_sizes) + 1:
            raise ValueError("one activation per layer")
        dil = _per_layer(dilations, len(acts))
        self.layers = nn.ModuleList(
            CircularConv(sizes[i], sizes[i + 1], kernel_size,
                         conv_dim=conv_dim, bias=bias, dilation=dil[i],
                         generator=generator, dtype=dtype, device=device)
            for i in range(len(acts)))
        self.acts = acts
        self.pre_act = pre_act
        self.compute_dtype = _as_dtype(compute_dtype)
        self.fuse_out_cast = False

    def forward(self, x):
        out_dtype = x.dtype
        cd = _as_dtype(self.compute_dtype)
        if cd is not None:
            x = x.to(cd)
        if self.pre_act is not None:
            x = ACTIVATIONS[self.pre_act](x)
        n_last = len(self.layers) - 1
        for i, (layer, act) in enumerate(zip(self.layers, self.acts)):
            fuse = (i == n_last and act is None and self.fuse_out_cast
                    and cd is not None and out_dtype != cd)
            x = layer(x, out_dtype=out_dtype if fuse else None)
            if act is not None:
                x = ACTIVATIONS[act](x)
        return x.to(out_dtype)


class RowParityFeature(_Transferable, nn.Module):
    """Appends a +-1 row-parity plane ``2 (row % 2) - 1`` as the last input
    channel, after the field, so a shared-weight conv on the
    checkerboard-packed grid can tell its row-skewed geometry apart."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        slab = space.current()  # the global row index on a slab
        row0 = 0 if slab is None else slab.row0
        rows = torch.arange(row0, row0 + x.shape[2], device=x.device)
        par = (2.0 * (rows % 2) - 1.0).to(x.dtype)
        shape = [1, 1, x.shape[2]] + [1] * (x.dim() - 3)
        plane = par.reshape(shape).expand(x.shape[0], 1, *x.shape[2:])
        if channels_last(x):  # concatenated on the NHWC view, kept so
            return self.net(torch.cat(
                [x.movedim(1, -1), plane.movedim(1, -1)], -1).movedim(-1, 1))
        return self.net(torch.cat([x, plane], dim=1))


class Dense(nn.Module):
    """One linear layer on the last axis, weight ``(out, in)``; PyTorch's
    ``Linear`` init, uniform with bound ``1/sqrt(in_features)``."""

    @classmethod
    def build(cls, key, in_features, out_features, bias=True, dtype=None, *,
              device=None):
        """The JAX package's factory; ``key`` is a ``torch.Generator``."""
        return cls(in_features, out_features, bias, generator=key,
                   dtype=dtype, device=device)

    def __init__(self, in_features, out_features, bias=True, *,
                 generator=None, dtype=None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.weight = _uniform((out_features, in_features), bound, **kw)
        self.bias = _uniform((out_features,), bound, **kw) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PlusBias(nn.Module):
    """A bias add on the last axis, the bias drawn from N(0, 1)."""

    @classmethod
    def build(cls, key, out_features, dtype=None, *, device=None):
        """The JAX package's factory; ``key`` is a ``torch.Generator``."""
        return cls(out_features, generator=key, dtype=dtype, device=device)

    def __init__(self, out_features, *, generator=None, dtype=None,
                 device=None):
        super().__init__()
        b = torch.randn((out_features,), generator=generator,
                        dtype=torch.float64)
        self.bias = nn.Parameter(b.to(dtype=dtype or torch.get_default_dtype(),
                                      device=device))

    def forward(self, x):
        return x + self.bias


class LinearNet(_Transferable, nn.Module):
    """Stack of ``Dense`` layers with activations on the features axis
    ``features_axis``, an optional ``pre_act`` and an optional final
    ``PlusBias``."""

    @classmethod
    def build(cls, key, in_features, out_features, hidden_sizes=(),
              acts=(None,), pre_act=None, final_bias=False,
              features_axis=-1, bias=True, dtype=None, *, device=None):
        """The JAX package's factory; ``key`` is a ``torch.Generator``."""
        return cls(in_features, out_features, hidden_sizes=hidden_sizes,
                   acts=acts, pre_act=pre_act, final_bias=final_bias,
                   features_axis=features_axis, bias=bias, generator=key,
                   dtype=dtype, device=device)

    def __init__(self, in_features, out_features, *, hidden_sizes=(),
                 acts=(None,), pre_act=None, final_bias=False,
                 features_axis=-1, bias=True, generator=None, dtype=None,
                 device=None):
        super().__init__()
        sizes = [in_features, *hidden_sizes, out_features]
        acts = tuple(acts)
        if len(acts) != len(hidden_sizes) + 1:
            raise ValueError("one activation per layer")
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            Dense(sizes[i], sizes[i + 1], bias=bias, **kw)
            for i in range(len(acts)))
        self.final_bias = PlusBias(out_features, **kw) if final_bias else None
        self.acts = acts
        self.pre_act = pre_act
        self.features_axis = features_axis

    def forward(self, x):
        axis = self.features_axis % x.dim()
        y = x.movedim(axis, -1)
        if self.pre_act is not None:
            y = ACTIVATIONS[self.pre_act](y)
        for layer, act in zip(self.layers, self.acts):
            y = layer(y)
            if act is not None:
                y = ACTIVATIONS[act](y)
        if self.final_bias is not None:
            y = self.final_bias(y)
        return y.movedim(-1, axis)
