"""Checkerboard partitioner with packed partitions.

Counterpart of ``normflow__tpu/models/masks.py:261-317``.  ``split``
returns the even and odd sublattices as dense ``(B, L1, L2/2)`` arrays,
packed with the same row-parity skew as the JAX package, so conditioner
weights transplant exactly.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PackedEvenOddMask"]


@dataclasses.dataclass(frozen=True)
class PackedEvenOddMask:
    """Row ``r`` of a packed partition holds the sites ``(r, c)`` with
    ``c = (r + parity) % 2 + 2j``.  2-D, even extents only."""

    shape: tuple
    parity: int = 0

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        l1, l2 = self.shape
        if l1 % 2 or l2 % 2:
            raise ValueError("packed mask needs even dims")

    def _pack(self, x, parity):
        b = x.shape[0]
        l1, l2 = self.shape
        e = x[:, 0::2, parity::2]
        o = x[:, 1::2, (1 - parity)::2]
        return torch.stack([e, o], dim=2).reshape(b, l1, l2 // 2)

    def _unpack_into(self, out, packed, parity):
        b = packed.shape[0]
        l1, l2 = self.shape
        rows = packed.reshape(b, l1 // 2, 2, l2 // 2)
        out[:, 0::2, parity::2] = rows[:, :, 0]
        out[:, 1::2, (1 - parity)::2] = rows[:, :, 1]

    def split(self, x):
        p = self.parity
        return self._pack(x, p), self._pack(x, 1 - p)

    def cat(self, x0, x1):
        out = torch.empty((x0.shape[0], *self.shape), dtype=x0.dtype,
                          device=x0.device)
        self._unpack_into(out, x0, self.parity)
        self._unpack_into(out, x1, 1 - self.parity)
        return out

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl
