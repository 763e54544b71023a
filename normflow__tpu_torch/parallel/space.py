"""Lattice (``space``) sharding: the collectives XLA's SPMD partitioner
inserts for the JAX package, written out.

Under ``use_mesh(axes={"data": n, "space": m})`` the JAX package constrains
every batch to ``P(data, space, ...)``: the first lattice axis is split into
``m`` row slabs and XLA adds the convolution and stencil halos and the sums
(``normflow__tpu/parallel/mesh.py:143-171``, ``docs/DISTRIBUTED.md``).  The
port runs one process per (data, space) rank; each holds ``(B / n, L0 / m,
L1, ...)`` and the model's modules call the functions here where a result
needs more than the slab:

- :class:`Slab` describes this rank's rows: the space group, the space rank
  and size, the first global row and the number of rows;
- :func:`halo` pads the slab with its neighbours' rows along the first
  lattice axis (a convolution's halo), differentiably: its backward sends
  the halo rows' cotangents back to their owners and adds them into the
  edge rows;
- :func:`edge_rows` is the same exchange without a backward, the one row
  before and after the slab that the phi^4 action reads (see
  ``models/actions.py``);
- :func:`psum` sums a per-rank partial over the space group into a value
  every rank holds and uses in its own way (the volume mean): its backward
  sums the cotangents too;
- :func:`totals` sums per-sample partials (log-probabilities, log-Jacobians,
  actions) into totals whose cotangent is the same on every space rank (the
  loss is computed alike from the same totals): its backward is the
  identity;
- :func:`gather_rows` assembles the whole lattice of each sample on every
  rank (the FFT flow's layout, ``docs/DISTRIBUTED.md:50-52``); its backward
  sums the cotangent over the group and keeps the slab's rows;
- :func:`once` counts a per-sample term that every rank computes alike (a
  constant log-Jacobian) on space rank 0 only.

The slab is implicit: :func:`active` makes a slab current for the block it
wraps (a ``contextvars`` variable, so a thread or task sees its own), and
:func:`current` returns it, or ``None``.  The flow protocol's signature
(``forward(x, log0, density)``) stays as it is; with no slab current every
module runs exactly the code it runs unsharded.  Every exchange is a
list-form ``all_gather`` or an ``all_reduce``, which NCCL, gloo on the CPU
and gloo on CUDA tensors all take (gloo refuses CUDA tensors for
``send``/``recv``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["Slab", "slab_of", "active", "current", "halo", "edge_rows",
           "psum", "totals", "gather_rows", "once"]


@dataclasses.dataclass(frozen=True)
class Slab:
    """Rows ``[row0, row0 + rows)`` of a lattice whose first axis has
    ``rows * size`` rows, held by rank ``rank`` of the space group
    ``group`` (``size`` ranks, rank ``r`` holding the ``r``-th slab)."""

    group: Any
    rank: int
    size: int
    row0: int
    rows: int


def slab_of(group, rank: int, size: int, global_rows: int) -> Slab:
    """Rank ``rank``'s slab of ``global_rows`` rows split over ``size``
    ranks.  Raises ``ValueError`` unless the rows divide: the JAX package
    would pad, the port refuses."""
    if global_rows % size:
        raise ValueError(f"{global_rows} lattice rows do not split into "
                         f"{size} slabs of equal height")
    rows = global_rows // size
    return Slab(group, rank, size, rank * rows, rows)


_current: contextvars.ContextVar = contextvars.ContextVar(
    "normflow__tpu_torch_slab", default=None)


def current() -> Slab | None:
    """The slab of the enclosing :func:`active` block, else ``None``."""
    return _current.get()


@contextlib.contextmanager
def active(slab: Slab | None):
    """Make ``slab`` current inside the block (``None``: no slab, the whole
    lattice, also inside an enclosing block)."""
    token = _current.set(slab)
    try:
        yield slab
    finally:
        _current.reset(token)


def _all_gather(t, slab):
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(slab.size)]
    dist.all_gather(parts, t, group=slab.group)
    return parts


def _exchange(x, dim, lo, hi, slab):
    """The ``lo`` rows before the slab along ``dim`` (the previous rank's
    last rows, periodic over the ranks) and the ``hi`` rows after it."""
    n = x.shape[dim]
    if max(lo, hi) > n:
        raise ValueError(f"a halo of ({lo}, {hi}) rows over a slab of {n}")
    parts = _all_gather(torch.cat([x.narrow(dim, 0, hi),
                                   x.narrow(dim, n - lo, lo)], dim), slab)
    prev = parts[(slab.rank - 1) % slab.size]
    nxt = parts[(slab.rank + 1) % slab.size]
    return prev.narrow(dim, hi, lo), nxt.narrow(dim, 0, hi)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, dim, lo, hi):
        ctx.slab, ctx.dim, ctx.lo, ctx.hi = slab, dim, lo, hi
        before, after = _exchange(x, dim, lo, hi, slab)
        return torch.cat([before, x, after], dim)

    @staticmethod
    def backward(ctx, g):
        slab, dim, lo, hi = ctx.slab, ctx.dim, ctx.lo, ctx.hi
        n = g.shape[dim] - lo - hi
        # the cotangents of the halo rows go back to the rows they came
        # from: this rank's last lo rows fed the next rank's rows before,
        # its first hi rows the previous rank's rows after
        parts = _all_gather(torch.cat([g.narrow(dim, 0, lo),
                                       g.narrow(dim, lo + n, hi)], dim),
                            slab)
        from_next = parts[(slab.rank + 1) % slab.size].narrow(dim, 0, lo)
        from_prev = parts[(slab.rank - 1) % slab.size].narrow(dim, lo, hi)
        gx = g.narrow(dim, lo, n).clone()
        gx.narrow(dim, 0, hi).add_(from_prev)
        gx.narrow(dim, n - lo, lo).add_(from_next)
        return gx, None, None, None, None


def halo(x, dim: int, lo: int, hi: int, slab: Slab):
    """``x`` with ``lo`` rows of the previous slab before it and ``hi`` of
    the next after it along ``dim`` (the lattice is periodic over the
    slabs), differentiable in ``x``."""
    return _Halo.apply(x, slab, dim, lo, hi)


def edge_rows(x, slab: Slab):
    """``(B, 2, *rest)``: the row before and the row after the slab ``x``
    ``(B, rows, *rest)``, detached."""
    with torch.no_grad():
        before, after = _exchange(x.detach(), 1, 1, 1, slab)
        return torch.cat([before, after], 1)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, slab):
        ctx.slab = slab
        out = t.clone()
        dist.all_reduce(out, group=slab.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.slab.group)
        return g, None


def psum(t, slab: Slab):
    """The sum of ``t`` over the space group, which each rank then uses in
    its own way: the backward sums the ranks' cotangents."""
    return _Psum.apply(t, slab)


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, slab):
        out = t.clone()
        dist.all_reduce(out, group=slab.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def totals(slab: Slab | None, *partials):
    """Per-sample partial sums over the slab (each ``(B,)``) summed over
    the space group by one all-reduce; the tensors themselves with no slab.
    The backward is the identity: it holds where every space rank computes
    the same function of the totals, so that each rank's cotangent of the
    totals is already the whole one."""
    if slab is None:
        return partials
    return tuple(_Total.apply(torch.stack(partials), slab).unbind(0))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, dim):
        ctx.slab, ctx.dim = slab, dim
        return torch.cat(_all_gather(x, slab), dim)

    @staticmethod
    def backward(ctx, g):
        slab = ctx.slab
        g = g.contiguous().clone()
        dist.all_reduce(g, group=slab.group)
        return g.narrow(ctx.dim, slab.row0, slab.rows), None, None


def gather_rows(x, dim: int, slab: Slab):
    """Every slab of ``x`` concatenated along ``dim`` in rank order: the
    whole lattice, on every rank.  Each rank uses the whole lattice in its
    own way (it keeps its own rows of what it computes from it), so the
    backward sums the cotangent over the group, then keeps the slab's
    rows."""
    return _GatherRows.apply(x, slab, dim)


def once(t, slab: Slab | None):
    """``t`` on space rank 0 and ``0 t`` elsewhere (``t`` with no slab): a
    per-sample term that every rank computes alike counts once in the
    totals."""
    if slab is None or slab.rank == 0:
        return t
    return t * 0.0
