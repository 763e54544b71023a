"""Lattice grids and neighbour stencils (``normflow__tpu/ops/lattice.py``).

Index and momentum grids built from static shapes, the nearest-neighbour
mean by rolls, and the channels-last test of activations (:func:`channels_last`).  The grids are made on the device they are asked for, so a
CUDA graph that builds one holds no copy from the host.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["outer", "outer_sum", "outer_arange", "outer_linspace",
           "arange_like", "lattice_k2", "rfft_lattice_k2", "neighbor_mean"]


def outer(x, y, rule: Callable = lambda a, b: a * b):
    """Outer combination ``rule(x[i...], y[j...])`` by broadcasting
    (default: the product)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return rule(x.reshape(x.shape + (1,) * y.dim()), y)


def outer_sum(x, y):
    """Outer sum: ``z[i..., j...] = x[i...] + y[j...]``."""
    return outer(x, y, rule=lambda a, b: a + b)


def outer_arange(tuple_of_tuples, rule=lambda a, b: a * b,
                 arange_gen=torch.arange):
    """Grid from 1-D ranges ``arange_gen(*args)``, one per tuple, combined
    pairwise by ``rule``."""
    out = None
    for args in tuple_of_tuples:
        axis = arange_gen(*args)
        out = axis if out is None else outer(out, axis, rule)
    return out


def outer_linspace(tuple_of_tuples, rule=lambda a, b: a * b):
    """:func:`outer_arange` with ``linspace(start, stop, num)`` ranges."""
    return outer_arange(tuple_of_tuples, rule=rule, arange_gen=torch.linspace)


def arange_like(x, axis: int = -1):
    """The index along ``axis``, broadcast to the shape of ``x``."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = n
    return torch.arange(n, device=x.device).reshape(shape).expand(x.shape)


def lattice_k2(lat_shape: Sequence[int], dtype=None, device=None):
    """``k_hat^2 = sum_mu 4 sin^2(k_mu / 2)`` on the lattice momentum grid."""
    out = None
    for n in lat_shape:
        k = torch.linspace(0.0, 2 * math.pi * (1 - 1 / n), n, dtype=dtype,
                           device=device)
        k2 = 4 * torch.sin(k / 2) ** 2
        out = k2 if out is None else outer_sum(out, k2)
    return out


def rfft_lattice_k2(lat_shape: Sequence[int], dtype=None, device=None):
    """:func:`lattice_k2` trimmed on the last axis for ``rfftn`` layouts."""
    k2 = lattice_k2(lat_shape, dtype, device)
    return k2[..., : (1 + lat_shape[-1] // 2)]


def neighbor_mean(x, axes: Sequence[int] | None = None):
    """Mean of the ``2 n`` nearest neighbours along ``axes`` (default: every
    axis but the batch axis 0) by periodic rolls; axes of extent 1 are
    skipped and do not count in ``n``."""
    if axes is None:
        axes = range(1, x.dim())
    y, n = 0.0, 0
    for mu in axes:
        if x.shape[mu] == 1:
            continue
        n += 1
        y = y + torch.roll(x, 1, mu) + torch.roll(x, -1, mu)
    return y / (2 * max(n, 1))


def channels_last(x):
    """Whether ``x``, ``(N, C, *lat)``, is channels-last: each site's ``C``
    values one contiguous run (a channel stride of 1), the sites in order.
    A tensor with one channel or one site per sample can be NCHW-contiguous
    as well; its channel stride decides."""
    return x.dim() > 2 and x.stride(1) == 1 and \
        x.movedim(1, -1).is_contiguous()
