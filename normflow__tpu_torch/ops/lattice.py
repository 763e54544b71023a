"""Lattice momentum grids (``normflow__tpu/ops/lattice.py:71-90``)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["lattice_k2", "rfft_lattice_k2"]


def lattice_k2(lat_shape: Sequence[int], dtype=None, device=None):
    """``k_hat^2 = sum_mu 4 sin^2(k_mu / 2)`` on the lattice momentum grid."""
    out = None
    for n in lat_shape:
        k = torch.linspace(0.0, 2 * math.pi * (1 - 1 / n), n, dtype=dtype,
                           device=device)
        k2 = 4 * torch.sin(k / 2) ** 2
        out = k2 if out is None else out.unsqueeze(-1) + k2
    return out


def rfft_lattice_k2(lat_shape: Sequence[int], dtype=None, device=None):
    """:func:`lattice_k2` trimmed on the last axis for ``rfftn`` layouts."""
    k2 = lattice_k2(lat_shape, dtype, device)
    return k2[..., : (1 + lat_shape[-1] // 2)]
