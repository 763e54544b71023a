"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``normflow__tpu/parallel/mesh.py``, with the same public
names.  The JAX package is SPMD: one process drives a mesh over every
device and XLA inserts the gradient psum into the sharded step.  The port
runs one process per GPU, as the reference's DDP did: each process holds a
replica of the model, draws its share of every batch from a generator of
its own, gathers the per-sample log-densities of the whole batch to take
the global batch's loss, and sums the gradients over the group with one
explicit all-reduce (``Fitter``).  The group is NCCL for a CUDA model and
gloo for a CPU one.

- :func:`init_distributed` forms the default process group from
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``, ``LOCAL_RANK``) or from the arguments, and raises when it
  cannot; a second call in a process that has a group is a no-op.
- :func:`fold_key` is the per-rank generator: seed ``s`` on rank ``r``
  becomes ``s + r * 2**32`` (:func:`fold_seed`; rank 0 keeps ``s``).
- :class:`ModelDeviceHandler` attaches the group to a model
  (``use_mesh`` / ``distribute``), shards a global batch size
  (``batch_sharder``), broadcasts rank 0's weights (``replicate_params``),
  gathers along axis 0 (``all_gather_into_tensor``) and spawns one process
  per rank (``spawnprocesses``).

Lattice (``space``) sharding: ``make_mesh(axes={"data": n, "space": m})``
lays the default group's ``n m`` ranks out as a :class:`Mesh`, row-major
in the dict's order as the JAX package's device grid is, and forms one
``torch.distributed`` subgroup per row and column (every rank calls
``new_group`` for every one, in the same order).  Attached with
``use_mesh(axes=...)``, a batch is sharded over the data axis and the
first lattice axis over ``space``: each rank holds ``(B / n, L0 / m, L1,
...)``, its :class:`~.space.Slab`, and the model's entry points run their
bodies with that slab current (``parallel/space.py`` has the collectives).
The batch axis follows JAX's rule (``normflow__tpu/parallel/mesh.py:
121-135``): ``axis`` where ``axes`` names it, else the first axis that is
not ``space``; ``{"space": 8}`` raises.  Every other axis replicates, as
in JAX (``normflow__tpu/parallel/mesh.py:106-137``): ranks that differ
only on such an axis hold the same rows of the batch, the same slab, the
same streams and the same gradients, so ``{"data": 2, "replica": 2}``
computes what ``{"data": 2}`` does.  The space ranks of one data rank
draw their prior slabs from generators of their own (:func:`fold_seed` of
the rank's :attr:`ModelDeviceHandler.stream_rank`, its rank among the data
and space axes' ranks) and the Metropolis uniforms, which must agree over
the slabs of one sample, from one generator per data rank.  The first lattice
axis splits as XLA splits it (``space.slab_of``): the last slabs may be
shorter or empty.  The training step gathers the per-sample log-densities
of every data rank (:meth:`ModelDeviceHandler.gather_rows`), so that
every rank computes the loss of the global batch, and sums the gradients
over the data and space axes' ranks in its one flat bucket.  A space axis
on CUDA tensors captures the step and the samplers' rounds in CUDA graphs
only over NCCL: a gloo collective cannot sit in a graph, so over gloo the
bodies run eagerly (``captures``).
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import space

__all__ = ["ModelDeviceHandler", "Mesh", "make_mesh", "init_distributed",
           "fold_key", "fold_seed", "free_port", "batch_axis"]

RANK_SEED_STRIDE = 1 << 32


def free_port() -> int:
    """A TCP port on ``localhost`` that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(*, rank=None, world_size=None, init_method=None,
                     device=None):
    """Form the default process group and return it.

    ``rank``, ``world_size`` and ``init_method`` (``tcp://host:port``)
    default to ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and ``env://``.  The
    backend is NCCL for ``device`` ``cuda`` (the default; each process then
    takes the card ``LOCAL_RANK``, or ``rank`` modulo the cards) and gloo
    for the CPU.  Raises ``ValueError`` for a missing or impossible rank,
    size or address, and lets every error of forming the group through: a
    misconfigured group never turns into independent single-process runs.
    A process that already has a group keeps it."""
    if dist.is_initialized():
        return dist.group.WORLD
    device = resolve_device(device)
    env = os.environ
    rank = int(env["RANK"]) if rank is None and "RANK" in env else rank
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs rank and world_size, or "
                         "torchrun's RANK and WORLD_SIZE")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in a group of {world_size}")
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("init_distributed needs init_method, or "
                             "MASTER_ADDR and MASTER_PORT")
        init_method = "env://"
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dist.group.WORLD


def batch_axis(axes, axis="data") -> str:
    """The batch axis of a mesh with axes ``axes`` (names or a dict): JAX's
    rule, ``axis`` where ``axes`` names it, else the first axis that is not
    ``space``.  Raises ``ValueError`` where there is none.  Every axis that
    is neither the batch axis nor ``space`` replicates."""
    names = tuple(axes)
    if axis in names:
        return axis
    others = [k for k in names if k != "space"]
    if not others:
        raise ValueError("axes needs a batch axis besides 'space'")
    return others[0]


class Mesh:
    """The default group's ranks on a grid of named axes (``axes``, e.g.
    ``{"data": 2, "space": 2}``), row-major in the dict's order: rank
    ``r`` has the coordinates ``unravel(r, sizes)``.  ``groups[name]`` is
    this rank's subgroup along ``name`` (the ranks that share every other
    coordinate, :meth:`subgroup`), ``coords[name]`` its coordinate there;
    ``group`` is the default group."""

    def __init__(self, axes: dict):
        self.axis_names = tuple(axes)
        self.shape = {k: int(v) for k, v in axes.items()}
        sizes = tuple(self.shape.values())
        self.size = math.prod(sizes)
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"a mesh of {self.shape} ({self.size} ranks) "
                             f"in a group of {world} processes: the port "
                             "runs one process per device")
        self.group = dist.group.WORLD
        rank = dist.get_rank()
        self.coords = {k: int(c) for k, c in zip(
            self.axis_names, np.unravel_index(rank, sizes))}
        self._subgroups = {}
        self.groups = {name: self.subgroup((name,))
                       for name in self.axis_names}

    def subgroup(self, names):
        """This rank's subgroup of the ranks that share its coordinate on
        every axis not in ``names``, its rank there their row-major index
        over ``names`` in the mesh's order.  The first call with ``names``
        forms one group per such set of ranks, on every rank in the same
        order (so every rank must make the same calls); later calls return
        it."""
        keep = [a for a, n in enumerate(self.axis_names) if n in names]
        key = tuple(self.axis_names[a] for a in keep)
        if key not in self._subgroups:
            sizes = tuple(self.shape.values())
            rest = [a for a in range(len(sizes)) if a not in keep]
            grid = np.arange(self.size).reshape(sizes).transpose(rest + keep)
            rank = dist.get_rank()
            for ranks in grid.reshape(
                    -1, math.prod(sizes[a] for a in keep)).tolist():
                group = dist.new_group(ranks)  # on every rank, in order
                if rank in ranks:
                    self._subgroups[key] = group
        return self._subgroups[key]


def make_mesh(n_devices=None, axes=None):
    """The process group that carries the ``data`` axis: the default
    group, which must have ``n_devices`` ranks where that is given; with
    ``axes``, a :class:`Mesh` of the default group's ranks."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first "
                           "(or run under torchrun)")
    if axes:
        return Mesh(axes)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a data axis of {n_devices} devices in a group of "
                         f"{size} processes: the port runs one process per "
                         "device")
    return dist.group.WORLD


def fold_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s seed for the model seed ``seed``."""
    return (int(seed) + RANK_SEED_STRIDE * int(rank)) % (1 << 64)


def uniform_seed(seed: int, data_rank: int) -> int:
    """The seed of data rank ``data_rank``'s Metropolis uniforms under a
    space axis: :func:`fold_seed` moved by 2**63, so that it meets no
    rank's prior stream."""
    return (fold_seed(seed, data_rank) + (1 << 63)) % (1 << 64)


def fold_key(generator: torch.Generator, rank=None) -> torch.Generator:
    """A new generator on ``generator``'s device seeded with
    :func:`fold_seed` of its initial seed and ``rank`` (default: this
    process's rank)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    g = torch.Generator(device=generator.device)
    g.manual_seed(fold_seed(generator.initial_seed(), rank))
    return g


class ModelDeviceHandler:
    """Data parallelism of one model over a process group (see the module
    docstring).  Nothing is sharded until :meth:`use_mesh` attaches the
    group; from then on the ``Fitter`` trains on ``batch_size / n_data``
    draws per rank, the loss of the gathered global batch and the
    gradients summed over the data and space axes' ranks, the posterior
    draws this rank's share, and the production samplers split their
    proposals or chains over the data ranks."""

    def __init__(self, model):
        self._model = model
        self.group = None       # the group of the whole mesh
        self.mesh = None        # a Mesh, where use_mesh had axes
        self.data_axis = "data"
        self.space_axis = None
        self.data_group = None  # the batch axis's group
        # the data and space axes' ranks, which the gradients sum over
        self.reduce_group = None
        self.slab = None        # this rank's space.Slab under a space axis
        self._uniform = None    # the data rank's generator of uniforms

    # -- topology ------------------------------------------------------ #
    @property
    def rank(self) -> int:
        if self.group is not None:
            return dist.get_rank(self.group)
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def nranks(self) -> int:
        if self.group is not None:
            return dist.get_world_size(self.group)
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def n_devices(self) -> int:
        if self.group is not None:
            return self.nranks
        return torch.cuda.device_count() if torch.cuda.is_available() else 1

    @property
    def n_data(self) -> int:
        """The ranks along the batch axis (1 with no group)."""
        if self.data_group is None:
            return 1
        return dist.get_world_size(self.data_group)

    @property
    def data_rank(self) -> int:
        if self.data_group is None:
            return 0
        return dist.get_rank(self.data_group)

    @property
    def stream_rank(self) -> int:
        """This rank's rank among the data and space axes' ranks, the rank
        it has in the mesh without its replica axes: it keys the rank's
        prior stream (``Model.seed``), so replicas draw alike."""
        if self.reduce_group is None:
            return self.rank
        return dist.get_rank(self.reduce_group)

    # -- setup --------------------------------------------------------- #
    def use_mesh(self, mesh=None, n_devices=None, axis="data", axes=None):
        """Attach the process group or :class:`Mesh` ``mesh`` (default:
        :func:`make_mesh` of ``n_devices`` or ``axes``); rank ``r > 0``
        reseeds the model's generator with :func:`fold_seed` of the
        model's seed and its :attr:`stream_rank`; stream rank 0 keeps its
        stream.  ``axes={"data": n,
        "space": m}`` also splits the first lattice axis into ``m`` slabs
        (module docstring); the batch axis is ``axis`` where ``axes`` names
        it, else its first axis other than ``space``, and any other axis
        replicates.  The model's graphs are captured anew at their next
        use."""
        if axes:
            batch_axis(axes, axis)  # raises before any group is formed
        if mesh is None:
            mesh = make_mesh(n_devices, axes=axes)
        model = self._model
        self.slab = None
        if isinstance(mesh, Mesh):
            self.data_axis = batch_axis(mesh.axis_names, axis)
            self.space_axis = ("space" if "space" in mesh.axis_names
                               else None)
            self.group, self.mesh = mesh.group, mesh
            self.data_group = mesh.groups[self.data_axis]
            kept = (self.data_axis, "space")
            self.reduce_group = (
                mesh.group if set(mesh.axis_names) <= set(kept)
                else mesh.subgroup(kept))
            m = mesh.shape.get("space", 1)
            if m > 1:
                self.slab = space.slab_of(
                    mesh.groups["space"], mesh.coords["space"], m,
                    model.prior.shape[0])
                self._uniform = torch.Generator(device=model.device)
        else:
            self.data_axis, self.space_axis = axis, None
            self.group = self.data_group = self.reduce_group = mesh
            self.mesh = None
        if self.stream_rank:
            model.seed(model.base_seed)
        else:
            self.seed_uniforms(model.base_seed)
        for service in (model.posterior, model.mcmc, model.blocked_mcmc,
                        model.fit):
            service._graphs.clear()
        return mesh

    def distribute(self):
        """Shorthand: attach the default group."""
        return self.use_mesh()

    def seed_uniforms(self, seed):
        """Seed the data rank's generator of Metropolis uniforms
        (:func:`uniform_seed`), where a space axis has one."""
        if self.slab is not None:
            self._uniform.manual_seed(uniform_seed(seed, self.data_rank))

    def batch_sharder(self):
        """A function from a global batch size to this rank's share.
        Raises ``ValueError`` unless the size divides by the data ranks
        (``docs/DISTRIBUTED.md``'s rule); the identity with no group."""
        n = self.n_data if self.group is not None else 1

        def shard(batch_size):
            if batch_size % n:
                raise ValueError(f"batch size {batch_size} does not divide "
                                 f"over {n} ranks")
            return batch_size // n

        return shard

    def replicate_params(self):
        """Broadcast rank 0's parameters to every rank of the group."""
        if self.group is None:
            return
        src = dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for p in self._model.net_.parameters():
                dist.broadcast(p.data, src, group=self.group)

    # -- the space axis ------------------------------------------------- #
    def sharded(self):
        """A context in which this rank's slab is current
        (``space.active``); no slab with no space axis."""
        return space.active(self.slab)

    def local_rows(self, x, dim=1):
        """This rank's slab of the whole lattices ``x`` (lattice axis 0 at
        ``dim``); ``x`` with no space axis."""
        if self.slab is None:
            return x
        return x.narrow(dim, self.slab.row0, self.slab.rows)

    def whole_rows(self, x, dim=1):
        """The whole lattices from this rank's slabs ``x`` (lattice axis 0
        at ``dim``), gathered over the space axis; ``x`` with no space
        axis."""
        if self.slab is None:
            return x
        return space.gather_rows(x, dim, self.slab)

    def uniform_generator(self, generator):
        """The generator of a round's Metropolis uniforms: ``generator``,
        or under a space axis the data rank's own, so that every slab of a
        sample accepts alike."""
        return generator if self.slab is None else self._uniform

    def captures(self) -> bool:
        """Whether the model's bodies run as CUDA graphs: on a CUDA model,
        except under a space axis whose group is not NCCL (a gloo
        collective cannot sit in a graph; the bodies then run eagerly)."""
        if self._model.device.type != "cuda":
            return False
        return self.slab is None or dist.get_backend(self.group) == "nccl"

    # -- collectives ---------------------------------------------------- #
    def reduce_step(self, grads):
        """A training step's gradients summed in one flat bucket by one
        all-reduce (a copy with no group): each rank holds its samples'
        part of the global loss's gradient (:meth:`gather_rows`), and under
        a space axis its slab's part of that.  The sum runs over the data
        and space axes' ranks alone (``reduce_group``, one subgroup of
        them where the mesh has replica axes, else the whole group): the
        replicas hold the same parts, which a sum over them would count
        once per replica.  So the replicas sum alike, in the order a mesh
        without them sums, and keep the same bits."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        if self.group is not None:
            dist.all_reduce(flat, group=self.reduce_group)
        return [part.view_as(g) for part, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def all_gather_into_tensor(self, x, dim=0):
        """``x`` of every rank of the batch axis concatenated along ``dim``
        in rank order (``x`` itself with no group)."""
        if self.group is None:
            return x
        n = self.n_data
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
        dist.all_gather(list(out.chunk(n)), xs, group=self.data_group)
        return out.movedim(0, dim)

    def gather_rows(self, *tensors):
        """Each of ``tensors`` (one dtype, batch axis first) of every rank
        of the batch axis concatenated along axis 0 in rank order, by one
        gather of the rows packed side by side, each returned contiguous,
        differentiably: the backward keeps this rank's rows of the
        cotangent, which is the gradient where every data rank computes the
        same loss from the same gathered tensors (the training step sums
        the ranks' gradients, :meth:`reduce_step`).  The tensors themselves
        with one data rank."""
        if self.n_data == 1:
            return tensors
        b = tensors[0].shape[0]
        packed = torch.cat([t.reshape(b, -1) for t in tensors], dim=1)
        rows = _GatherRows.apply(packed, self)
        parts = rows.split([t.numel() // b for t in tensors], dim=1)
        return tuple(p.reshape(len(rows), *t.shape[1:]).contiguous()
                     for p, t in zip(parts, tensors))

    # -- processes ------------------------------------------------------ #
    def spawnprocesses(self, fn, nranks, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` in ``nranks`` new processes, one per
        rank (``torch.multiprocessing``, ``spawn``), each in a process group
        of ``nranks`` formed on a free ``localhost`` port (NCCL for a CUDA
        model, one card per rank; gloo for a CPU one).  ``fn`` must be
        importable by name and builds its model in each process (a
        process cannot share this model's tensors); it finds its rank with
        ``torch.distributed.get_rank()``.  Returns the ranks' results in
        rank order; raises if a rank raised."""
        ctx = torch.multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        init = f"tcp://localhost:{free_port()}"
        device = str(self._model.device.type)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nranks, init, device, args, kwargs,
                                   queue)) for r in range(nranks)]
        for p in procs:
            p.start()
        results = {}
        try:  # drain the queue before joining; a rank that dies unheard ends it
            while len(results) < nranks:
                try:
                    rank, out = queue.get(timeout=1.0)
                    results[rank] = out
                except queue_mod.Empty:
                    if any(p.exitcode for p in procs):
                        break
        finally:
            for p in procs:
                p.join(timeout=None if len(results) == nranks else 30)
                if p.is_alive():
                    p.kill()
        failed = {r: out[1] for r, out in results.items() if out[0]}
        failed.update({r: f"exit code {p.exitcode}, no result"
                       for r, p in enumerate(procs) if r not in results})
        if failed:
            raise RuntimeError("spawned ranks failed:" + "".join(
                f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(
                    failed.items())))
        return [results[r][1] for r in range(nranks)]


class _GatherRows(torch.autograd.Function):
    """``ModelDeviceHandler.all_gather_into_tensor`` of rows ``(b, ...)``,
    whose backward keeps this rank's rows
    (:meth:`ModelDeviceHandler.gather_rows`)."""

    @staticmethod
    def forward(ctx, t, handler):
        ctx.rows = (handler.data_rank * t.shape[0], t.shape[0])
        return handler.all_gather_into_tensor(t)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, *ctx.rows), None


def _rank_main(fn, rank, nranks, init_method, device, args, kwargs, queue):
    """One rank of :meth:`ModelDeviceHandler.spawnprocesses`."""
    try:
        init_distributed(rank=rank, world_size=nranks,
                         init_method=init_method, device=device)
        try:
            queue.put((rank, (False, fn(*args, **kwargs))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, (True, traceback.format_exc())))
        raise
