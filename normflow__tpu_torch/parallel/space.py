"""Lattice (``space``) sharding: the collectives XLA's SPMD partitioner
inserts for the JAX package, written out.

Under ``use_mesh(axes={"data": n, "space": m})`` the JAX package constrains
every batch to ``P(data, space, ...)``: the first lattice axis is split into
``m`` row slabs and XLA adds the convolution and stencil halos and the sums
(``normflow__tpu/parallel/mesh.py:143-171``, ``docs/DISTRIBUTED.md``).  The
port runs one process per (data, space) rank; each holds ``(B / n, rows,
L1, ...)`` and the model's modules call the functions here where a result
needs more than the slab.  The rows split as XLA splits them: ``ceil(L0 /
m)`` a rank, the last ranks shorter or empty (``L0 = 32`` over 3 ranks:
11, 11, 10; ``L0 = 4`` over 3: 2, 2, 0).

- :class:`Slab` describes this rank's rows: the space group, the space rank
  and size, the first global row, the number of rows, the lattice's rows
  and the rows a rank holds at most;
- :func:`halo` pads the slab with the rows before and after it along the
  first lattice axis (a convolution's halo), each from the rank that holds
  it, however deep the halo and however short the slabs, differentiably:
  its backward sends the halo rows' cotangents back to their owners and
  adds them into the rows they came from;
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
  rank (the FFT flow's layout, ``docs/DISTRIBUTED.md:50-52``), each slab
  sent padded to the longest; its backward sums the cotangent over the
  group and keeps the slab's rows;
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
    ``length`` rows, held by rank ``rank`` of the space group ``group``
    (``size`` ranks).  The rows split as XLA splits a sharded axis: ``per
    = ceil(length / size)`` rows a rank, rank ``r`` holding ``[r per,
    min((r + 1) per, length))``, so the last ranks hold fewer rows or
    none."""

    group: Any
    rank: int
    size: int
    row0: int
    rows: int
    length: int

    @property
    def per(self) -> int:
        """The rows a rank holds at most, ``ceil(length / size)``."""
        return -(-self.length // self.size)

    def bounds(self, rank: int) -> tuple[int, int]:
        """``(row0, rows)`` of rank ``rank``'s slab."""
        row0 = min(rank * self.per, self.length)
        return row0, min(self.per, self.length - row0)

    def owner(self, row: int) -> tuple[int, int]:
        """The rank that holds global row ``row`` (periodic) and the row's
        index in that rank's slab."""
        return divmod(row % self.length, self.per)


def slab_of(group, rank: int, size: int, global_rows: int) -> Slab:
    """Rank ``rank``'s slab of ``global_rows`` rows split over ``size``
    ranks as XLA splits them (:class:`Slab`)."""
    row0, rows = Slab(group, rank, size, 0, 0, global_rows).bounds(rank)
    return Slab(group, rank, size, row0, rows, global_rows)


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


def _halo_sources(slab, rank, lo, hi):
    """Where rank ``rank``'s halo rows come from, in the halo's order (the
    ``lo`` rows before its slab, then the ``hi`` rows after it): ``(owner,
    row)`` pairs, ``row`` the index in the owner's slab.  The rows before
    a slab end where a slab starts, so each is among its owner's last
    ``lo`` rows; the rows after start where a slab starts, so each is among
    its owner's first ``hi`` (:func:`_edge_parts` sends those)."""
    row0, rows = slab.bounds(rank)
    return [slab.owner(g) for g in range(row0 - lo, row0 + rows + hi)
            if not row0 <= g < row0 + rows]


def _edge_parts(x, dim, lo, hi):
    """This slab's edge rows for the neighbours' halos, ``hi + lo`` rows
    along ``dim``: its first ``hi`` rows, then its last ``lo``, zeros
    standing in where the slab is shorter."""
    n = x.shape[dim]
    first, last = min(hi, n), min(lo, n)
    parts = [x.narrow(dim, 0, first)]
    gap = hi + lo - first - last
    if gap:
        shape = list(x.shape)
        shape[dim] = gap
        parts.append(x.new_zeros(shape))
    parts.append(x.narrow(dim, n - last, last))
    return torch.cat(parts, dim)


def _exchange(x, dim, lo, hi, slab):
    """The ``lo`` rows before the slab along ``dim`` and the ``hi`` rows
    after it (the lattice periodic), each from the rank that holds it, as
    one tensor of ``lo + hi`` rows."""
    if max(lo, hi) > slab.length:
        raise ValueError(f"a halo of ({lo}, {hi}) rows over a lattice of "
                         f"{slab.length}")
    edges = torch.cat(_all_gather(_edge_parts(x, dim, lo, hi), slab), dim)
    rows = []
    for j, (q, r) in enumerate(_halo_sources(slab, slab.rank, lo, hi)):
        # the first hi edge rows are the owner's first, the last lo its last
        i = r if j >= lo else hi + lo - (slab.bounds(q)[1] - r)
        rows.append(edges.narrow(dim, q * (lo + hi) + i, 1))
    return torch.cat(rows, dim)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, dim, lo, hi):
        ctx.slab, ctx.dim, ctx.lo, ctx.hi = slab, dim, lo, hi
        rows = _exchange(x, dim, lo, hi, slab)
        return torch.cat([rows.narrow(dim, 0, lo), x,
                          rows.narrow(dim, lo, hi)], dim)

    @staticmethod
    def backward(ctx, g):
        slab, dim, lo, hi = ctx.slab, ctx.dim, ctx.lo, ctx.hi
        n = g.shape[dim] - lo - hi
        # every rank's halo cotangents, each added into the row it came
        # from: a row may feed several halos, or one halo twice
        parts = _all_gather(torch.cat([g.narrow(dim, 0, lo),
                                       g.narrow(dim, lo + n, hi)], dim),
                            slab)
        gx = g.narrow(dim, lo, n).clone()
        for r, part in enumerate(parts):
            for j, (q, row) in enumerate(_halo_sources(slab, r, lo, hi)):
                if q == slab.rank:
                    gx.narrow(dim, row, 1).add_(part.narrow(dim, j, 1))
        return gx, None, None, None, None


def halo(x, dim: int, lo: int, hi: int, slab: Slab):
    """``x`` with the ``lo`` lattice rows before it and the ``hi`` rows
    after it along ``dim`` (the lattice periodic), differentiable in
    ``x``.  Raises ``ValueError`` for a halo deeper than the lattice, as
    a circular pad does."""
    return _Halo.apply(x, slab, dim, lo, hi)


def edge_rows(x, slab: Slab):
    """``(B, 2, *rest)``: the row before and the row after the slab ``x``
    ``(B, rows, *rest)``, detached."""
    with torch.no_grad():
        return _exchange(x.detach(), 1, 1, 1, slab)


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
        if slab.rows < slab.per:  # every rank sends per rows
            shape = list(x.shape)
            shape[dim] = slab.per - slab.rows
            x = torch.cat([x, x.new_zeros(shape)], dim)
        parts = _all_gather(x, slab)
        return torch.cat([p.narrow(dim, 0, slab.bounds(q)[1])
                          for q, p in enumerate(parts)], dim)

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
