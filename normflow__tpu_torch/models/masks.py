"""Masks and partitioners for coupling layers.

Counterpart of ``normflow__tpu/models/masks.py``.  The contract:
``split(x) -> (x0, x1, *extra)``, ``cat(x0, x1, *extra) -> x`` and
``purify(x_chnl, channel)``, which zeroes what the other partition left.
Data is ``(B, *lat, *extra)``: the multiplicative masks are ``(*lat)``
tensors that broadcast over any trailing channel axes.  Each mask tensor is
built once per device and dtype and kept, so a CUDA graph that applies it
holds no copy from the host (the first, eager call builds it).

``PackedEvenOddMask`` returns the even and odd sublattices as dense
``(B, L1, L2/2)`` arrays, packed with the same row-parity skew as the JAX
package, so conditioner weights transplant exactly.

Under a space axis (``parallel/space.py``) the multiplicative masks take
the slab's rows of their tensor and ``PackedEvenOddMask`` packs the slab.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..parallel import space

__all__ = ["Mask", "EvenOddMask", "AlongAxesEvenOddMask", "DummyMask",
           "DoubleMask", "PackedEvenOddMask", "GaugeLinksDoubleMask",
           "ZebraPlanarMask", "MatrixMask", "ListPartitioner",
           "ChunkCatPartitioner", "AlongAxisEvenOddPartitioner"]


def _index_sum_grid(shape, exclude_mu=None):
    """The sum of the site's indices (without index ``exclude_mu``)."""
    total = np.zeros(shape, dtype=np.int64)
    for mu, n in enumerate(shape):
        if mu != exclude_mu:
            total = total + np.arange(n).reshape(
                [-1 if k == mu else 1 for k in range(len(shape))])
    return total


def _cache_field():
    return dataclasses.field(default_factory=dict, init=False, repr=False,
                             compare=False)


def _cached(cache, key, make):
    if key not in cache:
        cache[key] = make()
    return cache[key]


@dataclasses.dataclass(frozen=True)
class _MultiplicativeMask:
    """0/1 masks applied by multiplication; exported as ``Mask``."""

    shape: tuple
    _cache: dict = _cache_field()

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))

    def make_mask(self) -> np.ndarray:
        raise NotImplementedError

    def _pair(self, x):
        """``(m, 1 - m)`` on ``x``'s device and dtype, with singleton axes
        for ``x``'s trailing channel axes; on a slab (``parallel/space.py``)
        the slab's rows of the mask."""
        extra = x.dim() - 1 - len(self.shape)
        slab = space.current()
        rows = None if slab is None else (slab.row0, slab.rows)

        def make():
            m = self.make_mask()
            if rows is not None:
                m = m[rows[0]:rows[0] + rows[1]]
            m = torch.as_tensor(m, dtype=x.dtype, device=x.device)
            m = m.reshape(m.shape + (1,) * max(extra, 0))
            return m, 1 - m

        return _cached(self._cache, (x.device, x.dtype, extra, rows), make)

    def split(self, x):
        m, mc = self._pair(x)
        return m * x, mc * x

    def cat(self, x0, x1):
        return x0 + x1

    def purify(self, x_chnl, channel: int):
        return x_chnl * self._pair(x_chnl)[channel != 0]


Mask = _MultiplicativeMask


@dataclasses.dataclass(frozen=True)
class EvenOddMask(_MultiplicativeMask):
    """Checkerboard by the parity of the index sum; ``exclude_mu`` makes
    it constant along direction ``mu``."""

    parity: int = 0
    exclude_mu: int | None = None

    def make_mask(self):
        s = _index_sum_grid(self.shape, self.exclude_mu)
        return ((1 - self.parity + s) % 2).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class AlongAxesEvenOddMask(_MultiplicativeMask):
    """Stripes alternating along direction ``mu``."""

    parity: int = 0
    mu: int = 0

    def make_mask(self):
        idx = np.arange(self.shape[self.mu]).reshape(
            [-1 if k == self.mu else 1 for k in range(len(self.shape))])
        return np.broadcast_to((1 - self.parity + idx) % 2,
                               self.shape).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class DummyMask:
    """Pass-through: one partition is the whole input, the other empty."""

    parity: int = 0

    def split(self, x):
        return (x, None) if self.parity == 0 else (None, x)

    def cat(self, x0, x1):
        return x0 if self.parity == 0 else x1

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl


@dataclasses.dataclass(frozen=True)
class DoubleMask:
    """An outer mask inside an invisibility mask: ``split`` returns the
    invisible partition as a third part, which a coupling passes through
    to ``cat`` untouched."""

    invisibility_mask: Any
    outer_mask: Any

    def split(self, x):
        x, x_invisible = self.invisibility_mask.split(x)
        x0, x1 = self.outer_mask.split(x)
        return x0, x1, x_invisible

    def cat(self, x0, x1, x_invisible):
        return self.invisibility_mask.cat(self.outer_mask.cat(x0, x1),
                                          x_invisible)

    def purify(self, x_chnl, channel, **kwargs):
        return self.invisibility_mask.purify(
            self.outer_mask.purify(x_chnl, channel, **kwargs), 0)


def GaugeLinksDoubleMask(*, shape, parity, mu):
    """Hide the sites of one parity, couple along stripes in ``mu``."""
    return DoubleMask(invisibility_mask=EvenOddMask(shape=shape,
                                                    parity=parity),
                      outer_mask=AlongAxesEvenOddMask(shape=shape, mu=mu))


@dataclasses.dataclass(frozen=True)
class ZebraPlanarMask:
    """Shape-changing split into the even and odd planes along lattice
    axis ``nu`` (data axis ``1 + nu``); ``parity`` says which comes
    first."""

    mu: int
    nu: int
    parity: int = 0
    shape: tuple | None = None

    def _inds(self):
        head = (slice(None),) * (1 + self.nu)
        return (head + (slice(self.parity, None, 2),),
                head + (slice(1 - self.parity, None, 2),))

    def split(self, x):
        white, black = self._inds()
        return x[white], x[black]

    def cat(self, x_white, x_black):
        white, black = self._inds()
        ax = 1 + self.nu
        shape = list(x_white.shape)
        shape[ax] = x_white.shape[ax] + x_black.shape[ax]
        x = x_white.new_zeros(shape)
        x[white] = x_white
        x[black] = x_black
        return x

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl

    @property
    def subshape(self):
        """Shape of the ``parity`` partition (the larger one when the
        striped extent is odd)."""
        if self.shape is None:
            raise ValueError("shape of the underlying lattice is not defined.")
        sub = list(self.shape)
        sub[self.nu] = (sub[self.nu] - self.parity + 1) // 2
        return sub


@dataclasses.dataclass(frozen=True)
class MatrixMask:
    """Even-odd mask over ``(*lat_shape, nc, nc)`` matrix fields; the other
    partition is filled with the identity matrix."""

    lat_shape: tuple
    nc: int = 2
    parity: int = 0
    anisotropic_dir: int | None = None
    _cache: dict = _cache_field()

    def _mask_eye(self, x):
        def make():
            s = _index_sum_grid(tuple(self.lat_shape), self.anisotropic_dir)
            m = ((s + self.parity) % 2).reshape(*self.lat_shape, 1, 1)
            kw = dict(dtype=x.dtype, device=x.device)
            return (torch.as_tensor(m, **kw),
                    torch.eye(self.nc, **kw))

        return _cached(self._cache, (x.device, x.dtype), make)

    def split(self, x):
        m, eye = self._mask_eye(x)
        return (1 - m) * x + m * eye, m * x + (1 - m) * eye

    def cat(self, x0, x1):
        return x0 + x1 - self._mask_eye(x0)[1]

    def purify(self, x_chnl, channel: int):
        m, eye = self._mask_eye(x_chnl)
        if channel == 0:
            return (1 - m) * x_chnl + m * eye
        return m * x_chnl + (1 - m) * eye


@dataclasses.dataclass(frozen=True)
class PackedEvenOddMask:
    """Row ``r`` of a packed partition holds the sites ``(r, c)`` with
    ``c = (r + parity) % 2 + 2j``.  2-D, even extents only.  On a slab
    (``parallel/space.py``) it packs the slab's rows, of any height and
    from any first row: the slab's row ``r`` is the lattice's row ``row0 +
    r``, whose sites have ``c = (row0 + r + parity) % 2 + 2j``."""

    shape: tuple
    parity: int = 0

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        l1, l2 = self.shape
        if l1 % 2 or l2 % 2:
            raise ValueError("packed mask needs even dims")

    def _rows(self):
        """``(rows, row0)``: the rows this rank packs and the first one's
        global row (the lattice's, or its slab's)."""
        slab = space.current()
        if slab is None:
            return self.shape[0], 0
        return slab.rows, slab.row0

    def _pack(self, x, parity):
        (l1, row0), l2 = self._rows(), self.shape[1]
        parity = (parity + row0) % 2  # the parity of the slab's row 0
        out = x.new_empty((x.shape[0], l1, l2 // 2))
        out[:, 0::2] = x[:, 0::2, parity::2]
        out[:, 1::2] = x[:, 1::2, (1 - parity)::2]
        return out

    def _unpack_into(self, out, packed, parity):
        parity = (parity + self._rows()[1]) % 2
        out[:, 0::2, parity::2] = packed[:, 0::2]
        out[:, 1::2, (1 - parity)::2] = packed[:, 1::2]

    def split(self, x):
        p = self.parity
        return self._pack(x, p), self._pack(x, 1 - p)

    def cat(self, x0, x1):
        out = torch.empty((x0.shape[0], self._rows()[0], self.shape[1]),
                          dtype=x0.dtype, device=x0.device)
        self._unpack_into(out, x0, self.parity)
        self._unpack_into(out, x1, 1 - self.parity)
        return out

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl


@dataclasses.dataclass(frozen=True)
class ListPartitioner:
    """The input is a list of the two partitions."""

    @staticmethod
    def split(x):
        return x[0], x[1]

    @staticmethod
    def cat(x0, x1):
        return [x0, x1]

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl


@dataclasses.dataclass(frozen=True)
class ChunkCatPartitioner:
    """The two halves along ``axis``."""

    axis: int

    def split(self, x):
        n = x.shape[self.axis]
        return (x.narrow(self.axis, 0, n // 2),
                x.narrow(self.axis, n // 2, n - n // 2))

    def cat(self, x0, x1):
        return torch.cat([x0, x1], dim=self.axis)

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl


@dataclasses.dataclass(frozen=True)
class AlongAxisEvenOddPartitioner:
    """The even and the odd slices along ``axis``."""

    axis: int

    def _inds(self):
        head = (slice(None),) * self.axis
        return head + (slice(0, None, 2),), head + (slice(1, None, 2),)

    def split(self, x):
        even, odd = self._inds()
        return x[even], x[odd]

    def cat(self, x_even, x_odd):
        even, odd = self._inds()
        shape = list(x_even.shape)
        shape[self.axis] = x_even.shape[self.axis] + x_odd.shape[self.axis]
        x = x_even.new_zeros(shape)
        x[even] = x_even
        x[odd] = x_odd
        return x

    @staticmethod
    def purify(x_chnl, *args, **kwargs):
        return x_chnl
