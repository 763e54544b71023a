"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``normflow__tpu/parallel/mesh.py``, with the same public
names.  The JAX package is SPMD: one process drives a mesh over every
device and XLA inserts the gradient psum into the sharded step.  The port
runs one process per GPU, as the reference's DDP did: each process holds a
replica of the model, draws its share of every batch from a generator of
its own, and the training step sums the gradients over the group with one
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

Lattice (``space``) sharding with halo exchange is not ported.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import traceback

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["ModelDeviceHandler", "make_mesh", "init_distributed",
           "fold_key", "fold_seed", "free_port"]

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


def make_mesh(n_devices=None):
    """The process group that carries the ``data`` axis: the default
    group, which must have ``n_devices`` ranks where that is given."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first "
                           "(or run under torchrun)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a data axis of {n_devices} devices in a group of "
                         f"{size} processes: the port runs one process per "
                         "device")
    return dist.group.WORLD


def fold_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s seed for the model seed ``seed``."""
    return (int(seed) + RANK_SEED_STRIDE * int(rank)) % (1 << 64)


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
    group; from then on the ``Fitter`` trains on ``batch_size / nranks``
    draws per rank with the gradients averaged over the group, the
    posterior draws this rank's share, and the production samplers split
    their proposals or chains over the ranks."""

    def __init__(self, model):
        self._model = model
        self.group = None

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

    # -- setup --------------------------------------------------------- #
    def use_mesh(self, mesh=None, n_devices=None):
        """Attach the process group ``mesh`` (default: :func:`make_mesh`
        of ``n_devices``); rank ``r > 0`` reseeds the model's generator
        with :func:`fold_seed` of the model's seed, rank 0 keeps its
        stream.  The model's graphs are captured anew at their next use."""
        self.group = mesh if mesh is not None else make_mesh(n_devices)
        model = self._model
        if self.rank:
            model.seed(model.base_seed)
        for service in (model.posterior, model.mcmc, model.blocked_mcmc,
                        model.fit):
            service._graphs.clear()
        return self.group

    def distribute(self):
        """Shorthand: attach the default group."""
        return self.use_mesh()

    def batch_sharder(self):
        """A function from a global batch size to this rank's share.
        Raises ``ValueError`` unless the size divides by the ranks
        (``docs/DISTRIBUTED.md``'s rule); the identity with no group."""
        n = self.nranks if self.group is not None else 1

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

    # -- collectives ---------------------------------------------------- #
    def all_reduce_mean(self, tensors):
        """The mean over the group of each tensor of ``tensors``, summed in
        one flat bucket by one all-reduce (a copy with no group)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if self.group is not None:
            dist.all_reduce(flat, group=self.group)
            flat = flat / self.nranks
        return [part.view_as(t) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def all_gather_into_tensor(self, x, dim=0):
        """``x`` of every rank concatenated along ``dim`` in rank order
        (``x`` itself with no group)."""
        if self.group is None:
            return x
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((self.nranks * xs.shape[0], *xs.shape[1:]))
        dist.all_gather(list(out.chunk(self.nranks)), xs, group=self.group)
        return out.movedim(0, dim)

    def gather_rows(self, *tensors):
        """Each of ``tensors`` (one dtype, batch axis first) of every rank
        concatenated along axis 0, by one gather of the rows packed side
        by side, each returned contiguous; the tensors themselves with no
        group."""
        if self.group is None:
            return tensors
        b = tensors[0].shape[0]
        packed = torch.cat([t.reshape(b, -1) for t in tensors], dim=1)
        rows = self.all_gather_into_tensor(packed)
        parts = rows.split([t.numel() // b for t in tensors], dim=1)
        return tuple(p.reshape(-1, *t.shape[1:]).contiguous()
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
