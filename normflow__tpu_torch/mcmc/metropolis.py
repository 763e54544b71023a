"""Independence-Metropolis and blocked MCMC on top of the flow posterior.

Counterpart of ``normflow__tpu/mcmc/metropolis.py``: the host utilities
(``Metropolis``, ``ModifiedMetropolis``, ``estimate_accept_rate``, numpy
in float32 as in the JAX package), one round of accept/reject with
compaction (``_accept_reject_core``, l.418-424), the samplers
``MCMCSampler`` (``sample__``, ``sample_chain``,
``sample_parallel_chains`` and the rest) and ``BlockedMCMCSampler``, and
``MCMCHistory``.

The recurrence of a round runs on the round's device
(``ops.kernels.accept_scan``: a CUDA kernel on the card), so no round
reads the device from the host.  On a CUDA model ``sample_chain`` and
``sample_parallel_chains`` replay one captured round (``utils.graphs``),
the counterparts of the JAX package's scanned ``_chain_scan`` and
``_parallel_chains_scan``: the graph holds the prior draw, the flow, the
action, the uniforms, the accept step and the carry of the chain's
reference, written in place into tensors that live as long as the graph.
The blocked sampler replays one captured block proposal, the counterpart of
``_blocked_sweep_kernel``'s scanned ``block_step``.  On the CPU the same
bodies run eagerly.

With a process group attached to ``model.device_handler`` the production
samplers split their work over the ranks (``normflow__tpu/mcmc/
metropolis.py:320-325, 361-370``).  A chain round (``sample__``,
``sample_chain``) draws ``batch_size / nranks`` proposals and their log
uniforms on each rank from the rank's generator, pushes them through the
flow and gathers the proposals, their ``logq``, ``logp`` and uniforms from
every rank in rank order, with one collective inside the round: every rank
then runs the recurrence on the same global sequence and holds the same
chain.  ``sample_parallel_chains`` runs ``n_chains / nranks`` chains on each
rank with no collective inside a round and gathers its outputs along the
chains' axis after the last round.  The blocked sampler is not sharded, as
in the JAX package.

Under a space axis (``parallel/space.py``) each rank draws its slab of its
share and runs the flow and the action on it with its slab current; the
proposals' ``logq`` and ``logp`` are the totals over the space ranks, and
the log uniforms come from the data rank's own generator
(``ModelDeviceHandler.uniform_generator``), so every space rank of a data
rank takes the same decisions and holds the slab of the same chain.  The
samplers return the whole lattices, gathered over both axes, and keep the
chain's reference ``_ref`` whole.  Rounds are captured only where the group
is NCCL (``ModelDeviceHandler.captures``).  The blocked sampler runs on the
whole lattice on every rank with no slab current and no collective, and
replays its captured step on any CUDA model.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels.accept_scan import accept_scan
from ..ops.stats import Resampler, estimate_logz, fmt_val_err
from ..parallel import space
from ..utils.graphs import GraphCache, capture

__all__ = [
    "MCMCSampler", "BlockedMCMCSampler", "MCMCHistory", "Metropolis",
    "ModifiedMetropolis", "accept_scan", "accept_scan_core",
    "accept_reject", "estimate_accept_rate",
]


# ===================================================================== #
# Host-side utilities: numpy, float32 as in the JAX package
# ===================================================================== #
def accept_scan_core(lrand, logqp, logqp_ref, tau=None):
    """The accept/reject recurrence over a chain of proposals in numpy, in
    the dtype of ``logqp``: proposal ``i`` is accepted iff ``lrand[i] <
    rule(ref - logqp[i])``, ``ref`` being ``logqp`` of the last accepted
    proposal (``logqp_ref`` at the start); ``rule(x) = x`` (``tau=None``)
    or ``-(tau x^2 + relu(-x))``.  Returns ``(accept_seq, indices)``:
    ``indices[i]`` is 0 for "keep the incoming reference" or ``j + 1`` for
    "proposal j"."""
    lrand = np.asarray(lrand)
    logqp = np.asarray(logqp)
    real = logqp.dtype.type
    ref = real(logqp_ref)
    if tau is None:
        rule = lambda x: x  # noqa: E731
    else:
        tau, zero = real(tau), real(0)
        rule = lambda x: -(tau * x * x + np.maximum(-x, zero))  # noqa: E731
    n = logqp.shape[0]
    accept = np.empty(n, dtype=bool)
    indices = np.empty(n, dtype=np.int64)
    idx = 0
    for i in range(n):
        accept[i] = lrand[i] < rule(ref - logqp[i])
        if accept[i]:
            ref = logqp[i]
            idx = i + 1
        indices[i] = idx
    return accept, indices


class Metropolis:
    """Host-side Metropolis statistics on float32 ``logqp`` chains."""

    _tau = None  # the standard rule; ModifiedMetropolis overrides

    @classmethod
    def calc_accept_status(cls, logqp, logqp_ref=None, rng=None, tau=None):
        """Accept/reject status over a proposal chain, with uniforms from a
        (seedable) numpy ``rng``; float32 as in the JAX package."""
        logqp = np.asarray(logqp, dtype=np.float32)
        rng = np.random.default_rng() if rng is None else rng
        ref = logqp[0] if logqp_ref is None else np.float32(logqp_ref)
        # log U with U in (0, 1]: 1 - U avoids log(0)
        lrand = np.log1p(-rng.random(logqp.shape[0], dtype=np.float32))
        tau = cls._tau if tau is None else float(tau)
        status, _ = accept_scan_core(lrand, logqp, ref, tau)
        return status

    @staticmethod
    def calc_accept_indices(accept_seq):
        """``indices[i]`` = position of the last accepted proposal at or
        before ``i`` (0 when none yet)."""
        accept_seq = np.asarray(accept_seq)
        n = len(accept_seq)
        return np.maximum.accumulate(
            np.where(accept_seq, np.arange(n), 0))

    @staticmethod
    def calc_accept_count(accept_seq):
        """Gaps between consecutive accepted positions."""
        return np.diff(np.flatnonzero(accept_seq))

    @staticmethod
    def calc_tau_rejections_prob(accept_seq, max_tau=100):
        """P(tau + 1 rejections in a row), tau = 0 .. max_tau - 1, from
        windowed counts on the rejections' prefix sums."""
        rej = np.asarray(accept_seq) == False  # noqa: E712 (bool arrays)
        csum = np.concatenate([[0], np.cumsum(rej)])
        p_tau = np.zeros(max_tau)
        for tau in range(min(max_tau, len(rej))):
            length = tau + 1
            p_tau[tau] = np.mean((csum[length:] - csum[:-length]) == length)
        return p_tau


class ModifiedMetropolis(Metropolis):
    """The acceptance rule ``exp(-(tau x^2 + relu(-x)))``; its ``tau``
    sits before ``rng``, as in the JAX package."""

    _tau = 0.0

    @classmethod
    def calc_accept_status(cls, logqp, logqp_ref=None, tau=0, rng=None):
        return super().calc_accept_status(logqp, logqp_ref=logqp_ref,
                                          rng=rng, tau=float(tau))


def estimate_accept_rate(logqp, n_resamples=10, method="shuffling",
                         seed=None):
    """Metropolis acceptance rate estimated by resampling ``logqp``.
    Returns ``(mean, std)``."""
    rng = np.random.default_rng(seed)
    calc_rate = lambda x: float(np.mean(Metropolis.calc_accept_status(  # noqa: E731
        np.asarray(x).ravel(), rng=rng)))
    resampler = Resampler(method, seed=seed)
    return resampler.eval(_to_numpy(logqp).ravel(), fn=calc_rate,
                          n_resamples=n_resamples)


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ===================================================================== #
# One round, on the round's device
# ===================================================================== #
def accept_reject(y, logq, logp, lrand, ref):
    """Accept/reject of one batch of proposals against the chain's
    reference ``ref = (ref_y, ref_logq, ref_logp)``, and compaction: a
    rejected proposal is replaced by the last accepted one (or the
    reference).  ``lrand`` are the log uniforms, one per proposal.
    Returns ``(y, logq, logp, accept_seq)``."""
    ref_y, ref_logq, ref_logp = ref
    accept, indices = accept_scan(lrand, logq - logp, ref_logq - ref_logp)

    def take(r, a):
        return torch.cat([r[None], a]).index_select(0, indices)

    return (take(ref_y, y), take(ref_logq, logq), take(ref_logp, logp),
            accept)


class _Rows(dict):
    """Per-round outputs on the device, ``(n, *shape)`` for each name, each
    allocated at its first round."""

    def __init__(self, n):
        super().__init__()
        self.n = n

    def put(self, i, **outs):
        for name, t in outs.items():
            if name not in self:
                self[name] = t.new_empty((self.n, *t.shape))
            self[name][i].copy_(t)


# ===================================================================== #
# Samplers
# ===================================================================== #
class MCMCSampler:
    """Independence-Metropolis sampler: draws a batch of flow proposals,
    runs the accept/reject chain (carrying the ``_ref`` state across calls)
    and replaces rejected entries by the last accepted sample."""

    def __init__(self, model):
        self._model = model
        self.history = MCMCHistory()
        self._ref = None
        self._graphs = GraphCache()

    def reset(self):
        self._ref = None
        self.history.reset_history()

    def sample(self, batch_size=1, **kwargs):
        return self.sample__(batch_size=batch_size, **kwargs)[0]

    def sample_(self, batch_size=1, **kwargs):
        return self.sample__(batch_size=batch_size, **kwargs)[:2]

    def _draws(self, batch_size, generator):
        """A round's random numbers, in this order: the prior's draw ``(x,
        log r(x))``, then ``batch_size`` log uniforms (``log u`` with ``u``
        in [0, 1): ``-inf`` accepts, as JAX's ``log(uniform)``; under a
        space axis from the data rank's generator)."""
        x, logr = self._model.prior.sample_(batch_size, generator)
        ugen = self._model.device_handler.uniform_generator(generator)
        lrand = torch.log(torch.rand(batch_size, generator=ugen,
                                     dtype=logr.dtype, device=logr.device))
        return x, logr, lrand

    def _propose(self, x, logr):
        """``(y, logq, logp)`` of the flow's proposals for ``x`` (on a
        slab: the slab's ``y`` and the totals)."""
        m = self._model
        y, logj = m.net_.forward(x)
        return (y, *space.totals(m.device_handler.slab, logr - logj,
                                 -m.action(y)))

    def _proposals(self, batch_size, generator):
        """A chain round's proposals ``(y, logq, logp)`` and log uniforms:
        this rank's share drawn and pushed through the flow, then gathered
        from every rank of the batch axis
        (``ModelDeviceHandler.gather_rows``)."""
        dh = self._model.device_handler
        with dh.sharded():
            x, logr, lrand = self._draws(dh.batch_sharder()(batch_size),
                                         generator)
            return dh.gather_rows(*self._propose(x, logr), lrand)

    def _generators(self, generator):
        """The generators a round draws from, for its capture."""
        ugen = self._model.device_handler.uniform_generator(generator)
        return (generator,) if ugen is generator else (generator, ugen)

    def _local_ref(self):
        """``_ref`` with this rank's slab of its sample."""
        ref_y, ref_logq, ref_logp = self._ref
        return (self._model.device_handler.local_rows(ref_y, 0), ref_logq,
                ref_logp)

    def _keep_ref(self, ref_y, ref_logq, ref_logp):
        """Keep a chain's reference (``ref_y`` a slab) whole in ``_ref``."""
        dh = self._model.device_handler
        self._ref = (dh.whole_rows(ref_y, 0).clone(), ref_logq.clone(),
                     ref_logp.clone())

    @torch.no_grad()
    def sample__(self, batch_size=1, generator=None, bookkeeping=False):
        """Return ``(y, logq, logp)`` after the Metropolis correction.  A
        first call seeds the chain from proposal 0."""
        m = self._model
        gen = m.generator if generator is None else generator
        y, logq, logp, lrand = self._proposals(batch_size, gen)
        if bookkeeping:
            self.history.bookkeeping(raw_logq=logq, raw_logp=logp)
        if self._ref is None:
            self._keep_ref(y[0], logq[0], logp[0])
        y, logq, logp, accept = accept_reject(y, logq, logp, lrand,
                                              self._local_ref())
        self._keep_ref(y[-1], logq[-1], logp[-1])
        y = m.device_handler.whole_rows(y)

        self.history.bookkeeping(
            accept_rate=float(accept.to(logq.dtype).mean()))
        if bookkeeping:
            accept_np = _to_numpy(accept)
            self.history.bookkeeping(
                accept_seq=accept_np,
                accept_ind=Metropolis.calc_accept_indices(accept_np),
                logq=logq, logp=logp)
        return y, logq, logp

    # ------------------------------------------------------------------ #
    # sample_chain: one chain through n_batches rounds
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def chain_body(self, batch_size, generator, carry):
        """One round of :meth:`sample_chain`, the body its graph captures:
        draws, the flow, the action, the accept/reject against ``carry =
        (ref_y, ref_logq, ref_logp)``, and the new reference written into
        ``carry`` in place.  Returns ``(y, logq, logp, accept_rate,
        raw_logq, raw_logp, accept_seq)``."""
        y, logq, logp, lrand = self._proposals(batch_size, generator)
        yn, lqn, lpn, accept = accept_reject(y, logq, logp, lrand, carry)
        for t, v in zip(carry, (yn[-1], lqn[-1], lpn[-1])):
            t.copy_(v)
        return yn, lqn, lpn, accept.to(lqn.dtype).mean(), logq, logp, accept

    @torch.no_grad()
    def chain_graph(self, batch_size, generator=None):
        """The captured round of :meth:`sample_chain` on a CUDA model, a
        ``utils.graphs.Captured`` whose outputs are :meth:`chain_body`'s
        followed by its carry ``(ref_y, ref_logq, ref_logp)``, tensors that
        live as long as the graph.  Captured at first use for each batch
        size, dtype and generator (``Model.graph_stamp``)."""
        m = self._model
        gen = m.generator if generator is None else generator

        def make():
            carry = self._zero_carry(())
            return capture(
                lambda: (*self.chain_body(batch_size, gen, carry), *carry),
                generators=self._generators(gen), keep=carry)

        return self._graphs.get(("chain", batch_size, m.prior.dtype, gen),
                                m.graph_stamp(), make)

    def _zero_carry(self, batch):
        """Zero ``(ref_y, ref_logq, ref_logp)`` of batch shape ``batch``;
        ``ref_y`` has the prior's shape, which every flow of the port
        keeps (its slab's under a space axis)."""
        m = self._model
        kw = dict(dtype=m.prior.dtype, device=m.device)
        shape = m.prior.shape
        slab = m.device_handler.slab
        if slab is not None:
            shape = (slab.rows, *shape[1:])
        return (torch.zeros((*batch, *shape), **kw),
                torch.zeros(batch, **kw), torch.zeros(batch, **kw))

    @torch.no_grad()
    def sample_chain(self, n_batches, batch_size, generator=None,
                     collect_samples=False, bookkeeping=False):
        """Run ``n_batches`` Metropolis rounds of ``batch_size`` proposals
        through one chain.

        Returns a dict with the per-round ``accept_rate`` ``(n_batches,)``,
        the corrected ``logq``/``logp`` ``(n_batches, batch_size)`` and,
        with ``collect_samples``, the corrected ``samples``.  The chain's
        ``_ref`` is consumed and updated as :meth:`sample__` does; a first
        call starts from a zero sample with a ``+inf`` reference ``logq``,
        so proposal 0 is accepted.  ``bookkeeping=True`` records each
        round's raw and corrected streams and accept sequence in
        :attr:`history`.

        On a CUDA model every round is a replay of :meth:`chain_graph`; the
        host copies the seed into the graph's carry before the first
        replay, each round's outputs into a row of the output tensors
        (allocated at the first round) after it, and reads the device once
        at the end for :attr:`history`.  On the CPU (and under a space
        axis over gloo) :meth:`chain_body` runs eagerly.  With a process
        group each rank draws its share of every round's proposals (module
        docstring)."""
        m = self._model
        dh = m.device_handler
        gen = m.generator if generator is None else generator
        if dh.captures():
            graph, outs = self.chain_graph(batch_size, gen)
            carry = outs[-3:]
        else:
            graph, carry = None, self._zero_carry(())
        if self._ref is None:
            carry[0].zero_()
            carry[1].fill_(math.inf)
            carry[2].zero_()
        else:
            for t, v in zip(carry, self._local_ref()):
                t.copy_(v)
        rows = _Rows(n_batches)
        for i in range(n_batches):
            if graph is not None:
                graph.replay()
            else:
                outs = self.chain_body(batch_size, gen, carry)
            yn, lqn, lpn, rate, raw_logq, raw_logp, accept = outs[:7]
            rows.put(i, logq=lqn, logp=lpn, accept_rate=rate)
            if collect_samples:
                rows.put(i, samples=yn)
            if bookkeeping:
                rows.put(i, raw_logq=raw_logq, raw_logp=raw_logp,
                         accept_seq=accept)
        self._keep_ref(*carry)

        for r in rows["accept_rate"].tolist():
            self.history.bookkeeping(accept_rate=r)
        if bookkeeping:
            self._book_rounds(rows, n_batches, indices=True)
        out = {k: rows[k] for k in ("logq", "logp", "accept_rate")}
        if collect_samples:
            out["samples"] = dh.whole_rows(rows["samples"], 2)
        return out

    def _book_rounds(self, rows, n, indices):
        """Record each round's streams in :attr:`history` (one copy of
        each to the host)."""
        host = {k: _to_numpy(rows[k]) for k in
                ("raw_logq", "raw_logp", "logq", "logp", "accept_seq")}
        for i in range(n):
            self.history.bookkeeping(
                raw_logq=host["raw_logq"][i], raw_logp=host["raw_logp"][i],
                logq=host["logq"][i], logp=host["logp"][i],
                accept_seq=host["accept_seq"][i])
            if indices:
                self.history.bookkeeping(accept_ind=Metropolis
                                         .calc_accept_indices(
                                             host["accept_seq"][i]))

    # ------------------------------------------------------------------ #
    # sample_parallel_chains: n_chains independent chains
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def parallel_body(self, n_chains, generator, carry):
        """One round of :meth:`sample_parallel_chains`, the body its graph
        captures: one proposal per chain, accepted elementwise against the
        chain's own reference in ``carry = (ref_y, ref_logq, ref_logp)``
        (``(n_chains, ...)``), which is updated in place and holds the
        round's corrected states.  Returns ``(accept_seq, raw_logq,
        raw_logp)``."""
        ref_y, ref_lq, ref_lp = carry
        with self._model.device_handler.sharded():
            x, logr, lrand = self._draws(n_chains, generator)
            y, logq, logp = self._propose(x, logr)
        accept = lrand < (ref_lq - ref_lp) - (logq - logp)
        torch.where(accept.view((-1,) + (1,) * (y.dim() - 1)), y, ref_y,
                    out=ref_y)
        torch.where(accept, logq, ref_lq, out=ref_lq)
        torch.where(accept, logp, ref_lp, out=ref_lp)
        return accept, logq, logp

    @torch.no_grad()
    def parallel_graph(self, n_chains, generator=None):
        """The captured round of :meth:`sample_parallel_chains` on a CUDA
        model: its outputs are the carry ``(ref_y, ref_logq, ref_logp)``
        followed by :meth:`parallel_body`'s."""
        m = self._model
        gen = m.generator if generator is None else generator

        def make():
            carry = self._zero_carry((n_chains,))
            return capture(
                lambda: (*carry, *self.parallel_body(n_chains, gen, carry)),
                generators=self._generators(gen), keep=carry)

        return self._graphs.get(("parallel", n_chains, m.prior.dtype, gen),
                                m.graph_stamp(), make)

    @torch.no_grad()
    def sample_parallel_chains(self, n_rounds, n_chains, generator=None,
                               collect_samples=False, bookkeeping=False):
        """Run ``n_chains`` independent Metropolis chains for ``n_rounds``
        rounds, one proposal per chain and round, each chain accepting
        against its own reference (no recurrence over the batch).  Every
        call starts from zero samples with a ``+inf`` reference ``logq``
        and leaves ``_ref`` alone.

        Returns a dict with the per-round ``accept_rate`` ``(n_rounds,)``
        (numpy, reduced on the host after the run), the corrected
        ``logq``/``logp`` ``(n_rounds, n_chains)``, the ``final_samples``
        and, with ``collect_samples``, every round's ``samples``.  On a
        CUDA model every round is a replay of :meth:`parallel_graph`; on
        the CPU (and under a space axis over gloo) :meth:`parallel_body`
        runs eagerly.  With a process group each rank runs ``n_chains /
        n_data`` of the chains and the outputs are gathered along the
        chains' axis (and the samples over the space axis) after the
        run."""
        m = self._model
        gen = m.generator if generator is None else generator
        dh = m.device_handler
        n_chains = dh.batch_sharder()(n_chains)
        if dh.captures():
            graph, outs = self.parallel_graph(n_chains, gen)
            carry = outs[:3]
        else:
            graph, carry = None, self._zero_carry((n_chains,))
        carry[0].zero_()
        carry[1].fill_(math.inf)
        carry[2].zero_()
        rows = _Rows(n_rounds)
        for i in range(n_rounds):
            if graph is not None:
                graph.replay()
                accept, raw_logq, raw_logp = outs[3:]
            else:
                accept, raw_logq, raw_logp = self.parallel_body(
                    n_chains, gen, carry)
            rows.put(i, logq=carry[1], logp=carry[2], accept_seq=accept)
            if collect_samples:
                rows.put(i, samples=carry[0])
            if bookkeeping:
                rows.put(i, raw_logq=raw_logq, raw_logp=raw_logp)
        if collect_samples:  # (rounds, chains, rows, ...): whole lattices
            rows["samples"] = dh.whole_rows(rows["samples"], 2)
        for k in rows:  # (rounds, chains, ...): every rank's chains
            rows[k] = dh.all_gather_into_tensor(rows[k], dim=1)
        final = dh.all_gather_into_tensor(dh.whole_rows(carry[0], 1).clone())

        accept_rate = np.mean(_to_numpy(rows["accept_seq"]), axis=1)
        for r in accept_rate:
            self.history.bookkeeping(accept_rate=float(r))
        if bookkeeping:
            self._book_rounds(rows, n_rounds, indices=False)
        out = dict(logq=rows["logq"], logp=rows["logp"],
                   accept_rate=accept_rate, final_samples=final)
        if collect_samples:
            out["samples"] = rows["samples"]
        return out

    # ------------------------------------------------------------------ #
    def serial_sample_generator(self, n_samples, batch_size=16,
                                generator=None):
        """Yield chain samples one by one, ``(y, logq, logp)`` each with a
        batch axis of 1, drawing a batch of ``batch_size`` at a time."""
        for i in range(n_samples):
            ind = i % batch_size
            if ind == 0:
                y, logq, logp = self.sample__(batch_size, generator=generator)
            yield y[ind][None], logq[ind][None], logp[ind][None]

    def calc_accept_rate(self, n_samples=1024, batch_size=None,
                         n_resamples=10, method="shuffling", generator=None):
        """Acceptance rate from freshly drawn raw samples, ``(mean,
        std)``: ``logq - logp`` of ``ceil(n_samples / batch_size)``
        batches from ``Posterior.logqp_stream`` (the same draws and values
        as the posterior's ``sample__``), resampled on the host."""
        if batch_size is None or batch_size > n_samples:
            batch_size = n_samples
        n_batches = int(np.ceil(n_samples / batch_size))
        logqp = self._model.posterior.logqp_stream(n_batches, batch_size,
                                                   generator=generator)
        return estimate_accept_rate(logqp, n_resamples, method)

    estimate_accept_rate = staticmethod(estimate_accept_rate)

    def log_prob(self, y, action_logz=0.0):
        return -self._model.action(y) - action_logz


class _BlockGraphs(NamedTuple):
    """The captured start and block step of :class:`BlockedMCMCSampler`,
    and the tensors they read and write in place: ``state = (x_flat, ref,
    has, y_acc, logq_acc, logp_acc, accepts)`` and ``inputs = (proposal,
    lrand, b)``."""

    start: "torch.cuda.CUDAGraph"
    step: "torch.cuda.CUDAGraph"
    state: tuple
    inputs: tuple


class BlockedMCMCSampler(MCMCSampler):
    """Block-Gibbs MCMC in latent space.

    The latent configuration is updated block by block with proposals from
    the prior chopped to one block (``prior.chopped``, which requires a
    homogeneous prior); each block proposal costs one flow forward on one
    sample.  One block proposal is :meth:`block_step`, a body of
    preallocated tensors with the block index a device tensor, as
    ``_blocked_sweep_kernel``'s ``block_step`` takes a traced index
    (``normflow__tpu/mcmc/metropolis.py:585-596``): so one captured step
    serves every block.  On a CUDA model :meth:`sample__` replays it (and
    a captured :meth:`block_start`, the first flow forward), ``batch_size
    x n_blocks`` times; on the CPU the same bodies run eagerly.  Every
    proposal and log uniform is drawn before the sweeps, outside the
    graphs, so both paths consume the generator alike and give the same
    bits; no read from the host sits inside the loop: each accept is a
    device bool applied with ``torch.where``.  As in the JAX package it is
    not sharded: each block update conditions on the current state of
    every other block.  Under a space axis every rank runs it on the whole
    lattice with no slab current and no collective, so the steps are
    captured there too, over gloo as well (where the other samplers run
    eagerly); ``chip_smoke.py``'s space phase holds those replays on two
    gloo ranks bit for bit against the eager sweep and the unsharded
    model."""

    @torch.no_grad()
    @space.active(None)
    def sample__(self, batch_size=1, n_blocks=1, generator=None,
                 bookkeeping=False):
        """``(cfgs, logq, logp)`` of ``batch_size`` samples, each after a
        sweep over ``n_blocks`` blocks (``n_blocks`` must divide the
        prior's ``nvar``; not a positive int: one block)."""
        m = self._model
        prior = m.prior
        gen = m.generator if generator is None else generator
        nvar = prior.nvar
        if isinstance(n_blocks, int) and n_blocks > 0:
            block_len = nvar // n_blocks
            if block_len * n_blocks != nvar:
                raise ValueError(f"{n_blocks} blocks do not divide "
                                 f"{nvar} variables")
        else:
            block_len, n_blocks = nvar, 1
        chopped = prior.chopped(block_len)  # raises for a per-site prior

        if self._ref is None:
            x = prior.sample(1, gen)
            logqp_ref, has_ref = 0.0, False
        else:
            x = m.net_.backward(self._ref[0][None])[0]
            logqp_ref, has_ref = self._ref[1] - self._ref[2], True
        proposals, lrand = self._block_draws(chopped, batch_size, n_blocks,
                                             gen)
        cfgs, logq, logp, accept = self.sweep(
            x, logqp_ref, has_ref, proposals, lrand,
            graphed=m.device.type == "cuda")

        self._ref = (cfgs[-1], logq[-1], logp[-1])
        self.history.bookkeeping(
            accept_rate=float(accept.to(logq.dtype).mean()))
        if bookkeeping:
            self.history.bookkeeping(logq=logq, logp=logp)
            self.history.bookkeeping(accept_seq=_to_numpy(accept).ravel())
        return cfgs, logq, logp

    @staticmethod
    def _block_draws(chopped, batch_size, n_blocks, generator):
        """Every sweep's block proposals ``(batch_size, n_blocks,
        block_len)``, then their log uniforms ``(batch_size, n_blocks)``."""
        proposals = chopped.sample(batch_size * n_blocks, generator)
        lrand = torch.log(torch.rand((batch_size, n_blocks),
                                     generator=generator,
                                     dtype=proposals.dtype,
                                     device=proposals.device))
        return proposals.reshape(batch_size, n_blocks, -1), lrand

    def _evaluate(self, x_flat):
        """``(y, logq, logp)`` of the flattened latent state, one sample."""
        m = self._model
        xs = x_flat.reshape(1, *m.prior.shape)
        y, logj = m.net_.forward(xs)
        return y[0], (m.prior.log_prob(xs) - logj)[0], -m.action(y)[0]

    def _block_tensors(self, block_len):
        """Zero ``state`` and ``inputs`` (:class:`_BlockGraphs`) for blocks
        of ``block_len`` variables."""
        m = self._model
        kw = dict(dtype=m.prior.dtype, device=m.device)
        flag = dict(dtype=torch.bool, device=m.device)
        nvar = m.prior.nvar
        state = (torch.zeros(nvar, **kw), torch.zeros((), **kw),
                 torch.zeros((), **flag), torch.zeros(m.prior.shape, **kw),
                 torch.zeros((), **kw), torch.zeros((), **kw),
                 torch.zeros(nvar // block_len, **flag))
        inputs = (torch.zeros(block_len, **kw), torch.zeros((), **kw),
                  torch.zeros((), dtype=torch.int64, device=m.device))
        return state, inputs

    @torch.no_grad()
    def block_start(self, state):
        """The first flow forward of a sweep: ``(y, logq, logp)`` of the
        latent state ``x_flat`` into ``(y_acc, logq_acc, logp_acc)``, in
        place.  Returns ``state``."""
        x_flat, _, _, *acc, _ = state
        for t, v in zip(acc, self._evaluate(x_flat)):
            t.copy_(v)
        return state

    @torch.no_grad()
    def block_step(self, state, proposal, lrand, b):
        """One block proposal, the body that the card replays: ``proposal``
        ``(block_len,)`` written over block ``b`` (a device int64 scalar) of
        ``x_flat`` at ``b * block_len + arange(block_len)``, the flow on the
        one sample, the accept against ``ref`` with the log uniform
        ``lrand`` (always, while ``has`` is false), and the carry updated in
        place with ``torch.where``; the accept is written to ``accepts[b]``.
        Returns ``state``."""
        x_flat, ref, has, y_acc, logq_acc, logp_acc, accepts = state
        n = proposal.shape[0]
        x_new = x_flat.index_copy(
            0, b * n + torch.arange(n, device=b.device), proposal)
        y, logq, logp = self._evaluate(x_new)
        logqp = logq - logp
        accept = (lrand < ref - logqp) | ~has
        torch.where(accept, x_new, x_flat, out=x_flat)
        torch.where(accept, logqp, ref, out=ref)
        torch.logical_or(has, accept, out=has)
        torch.where(accept, y, y_acc, out=y_acc)
        torch.where(accept, logq, logq_acc, out=logq_acc)
        torch.where(accept, logp, logp_acc, out=logp_acc)
        accepts.index_copy_(0, b.reshape(1), accept.reshape(1))
        return state

    @torch.no_grad()
    @space.active(None)
    def block_graphs(self, block_len):
        """The captured :meth:`block_start` and :meth:`block_step` of a CUDA
        model for blocks of ``block_len`` variables (:class:`_BlockGraphs`),
        sharing their tensors, which live as long as the graphs.  Captured
        at first use for each block length and dtype (``Model
        .graph_stamp``)."""
        m = self._model

        def make():
            state, inputs = self._block_tensors(block_len)
            start = capture(lambda: self.block_start(state), keep=state)
            step = capture(lambda: self.block_step(state, *inputs),
                           keep=state)
            return _BlockGraphs(start.graph, step.graph, state, inputs)

        return self._graphs.get(("blocked", block_len, m.prior.dtype),
                                m.graph_stamp(), make)

    @torch.no_grad()
    @space.active(None)
    def sweep(self, x, logqp_ref, has_ref, proposals, lrand, graphed=False):
        """The sweeps of :meth:`sample__` from the latent state ``x``
        ``(1, *shape)`` given every block proposal ``(batch, n_blocks,
        block_len)`` and log uniform ``(batch, n_blocks)``: block ``b`` of
        the flattened state is replaced by its proposal and the flow is
        run on the one sample; without a reference yet (``has_ref``
        false) the first proposal is accepted.  Returns ``(cfgs, logq,
        logp, accept_seq)`` of the accepted state after each sweep.

        Each block proposal copies its draws and its index into the step's
        inputs and runs :meth:`block_step`: eagerly, or with ``graphed`` a
        replay of :meth:`block_graphs`' step (on a CUDA model); each
        sweep's accepted state is copied into preallocated rows."""
        batch, n_blocks, block_len = proposals.shape
        if graphed:
            g = self.block_graphs(block_len)
            state, inputs = g.state, g.inputs
            start, step = g.start.replay, g.step.replay
        else:
            state, inputs = self._block_tensors(block_len)
            start = lambda: self.block_start(state)  # noqa: E731
            step = lambda: self.block_step(state, *inputs)  # noqa: E731
        x_flat, ref, has, y_acc, logq_acc, logp_acc, accepts = state
        proposal, lr, b = inputs
        x_flat.copy_(x.reshape(-1))
        ref.copy_(torch.as_tensor(logqp_ref))
        has.fill_(bool(has_ref))
        start()
        rows = _Rows(batch)
        for i in range(batch):
            for j in range(n_blocks):
                proposal.copy_(proposals[i, j])
                lr.copy_(lrand[i, j])
                b.fill_(j)
                step()
            rows.put(i, cfgs=y_acc, logq=logq_acc, logp=logp_acc,
                     accept=accepts)
        return rows["cfgs"], rows["logq"], rows["logp"], rows["accept"]


class MCMCHistory:
    """Records of the samplers: ``accept_rate`` always; the raw and
    corrected ``logq``/``logp`` streams, the accept sequences and their
    indices on request (host numpy)."""

    def __init__(self):
        self.reset_history()

    def reset_history(self):
        self.logq = []
        self.logp = []
        self.raw_logq = []
        self.raw_logp = []
        self.accept_seq = []
        self.accept_ind = []
        self.accept_rate = []

    def report_summary(self, since=0, asstr=False):
        """``logqp`` and ``logz`` of the last corrected stream (when one is
        recorded) and the mean and spread of ``accept_rate``, as ``(mean,
        std)`` pairs or, with ``asstr``, strings ``value(err)``."""
        if asstr:
            fmt = lambda mean, std: fmt_val_err(mean, std, err_digits=2)  # noqa: E731
        else:
            fmt = lambda mean, std: (mean, std)  # noqa: E731
        mean_std = lambda t: (float(np.mean(t)), float(np.std(t)))  # noqa: E731
        out = {}
        if self.logq and self.logp:
            logqp = np.asarray(self.logq[-1]) - np.asarray(self.logp[-1])
            out["logqp"] = fmt(*mean_std(logqp))
            out["logz"] = fmt(*estimate_logz(logqp))
        if self.accept_rate:
            out["accept_rate"] = fmt(*mean_std(np.asarray(self.accept_rate)))
        return out

    def bookkeeping(self, logq=None, logp=None, raw_logq=None, raw_logp=None,
                    accept_seq=None, accept_rate=None, accept_ind=None):
        if raw_logq is not None:
            self.raw_logq.append(np.array(_to_numpy(raw_logq)))
        if raw_logp is not None:
            self.raw_logp.append(np.array(_to_numpy(raw_logp)))
        if logq is not None:
            self.logq.append(_to_numpy(logq))
        if logp is not None:
            self.logp.append(_to_numpy(logp))
        if accept_rate is not None:
            self.accept_rate.append(accept_rate)
        if accept_seq is not None:
            self.accept_seq.append(accept_seq)
        if accept_ind is not None:
            self.accept_ind.append(accept_ind)

    @property
    def logqp(self):
        return [lq - lp for lq, lp in zip(self.logq, self.logp)]

    @property
    def raw_logqp(self):
        return [lq - lp for lq, lp in zip(self.raw_logq, self.raw_logp)]
