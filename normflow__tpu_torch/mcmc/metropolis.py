"""Independence Metropolis on top of the flow posterior.

Counterpart of ``normflow__tpu/mcmc/metropolis.py``: the chain recurrence
``_accept_scan_core`` (l.31-58), ``Metropolis.calc_accept_status`` /
``calc_accept_indices`` (l.83-135), ``estimate_accept_rate`` (l.210-218)
and ``MCMCSampler.sample__`` with its ``_ref`` carry (l.224-281).

The recurrence is sequential over the proposals of a batch and was never a
Pallas kernel: the port copies ``logq - logp`` to the host once per batch,
runs the recurrence in numpy in the model's dtype, and gathers the kept
samples on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.stats import Resampler

__all__ = ["accept_scan_core", "Metropolis", "estimate_accept_rate",
           "MCMCSampler", "MCMCHistory"]


def accept_scan_core(lrand, logqp, logqp_ref):
    """The standard-rule accept/reject recurrence over a chain of proposals.

    Proposal ``i`` is accepted iff ``lrand[i] < ref - logqp[i]``, ``ref``
    being ``logqp`` of the last accepted proposal (``logqp_ref`` at the
    start).  Arithmetic is in the dtype of ``logqp``.  Returns
    ``(accept_seq, indices)``: ``indices[i]`` is 0 for "keep the incoming
    reference" or ``j + 1`` for "proposal j"."""
    lrand = np.asarray(lrand)
    logqp = np.asarray(logqp)
    ref = logqp.dtype.type(logqp_ref)
    n = logqp.shape[0]
    accept = np.empty(n, dtype=bool)
    indices = np.empty(n, dtype=np.int64)
    idx = 0
    for i in range(n):
        accept[i] = lrand[i] < ref - logqp[i]
        if accept[i]:
            ref = logqp[i]
            idx = i + 1
        indices[i] = idx
    return accept, indices


class Metropolis:
    """Host-side Metropolis statistics on float32 ``logqp`` chains."""

    @staticmethod
    def calc_accept_status(logqp, logqp_ref=None, rng=None):
        """Accept/reject status over a proposal chain, with uniforms from a
        (seedable) numpy ``rng``; float32 as in the JAX package."""
        logqp = np.asarray(logqp, dtype=np.float32)
        rng = np.random.default_rng() if rng is None else rng
        ref = logqp[0] if logqp_ref is None else np.float32(logqp_ref)
        # log U with U in (0, 1]: 1 - U avoids log(0)
        lrand = np.log1p(-rng.random(logqp.shape[0], dtype=np.float32))
        status, _ = accept_scan_core(lrand, logqp, ref)
        return status

    @staticmethod
    def calc_accept_indices(accept_seq):
        """``indices[i]`` = position of the last accepted proposal at or
        before ``i`` (0 when none yet)."""
        accept_seq = np.asarray(accept_seq)
        n = len(accept_seq)
        return np.maximum.accumulate(
            np.where(accept_seq, np.arange(n), 0))


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


class MCMCHistory:
    """Per-call records of the sampler (``accept_rate`` always; raw and
    corrected ``logq``/``logp`` and the accept sequence on request)."""

    def __init__(self):
        self.reset_history()

    def reset_history(self):
        self.logq, self.logp = [], []
        self.raw_logq, self.raw_logp = [], []
        self.accept_rate, self.accept_seq, self.accept_ind = [], [], []

    def bookkeeping(self, **records):
        for name, value in records.items():
            getattr(self, name).append(value)


class MCMCSampler:
    """Independence-Metropolis sampler: draws a batch of flow proposals,
    runs the accept/reject chain (carrying the ``_ref`` state across calls)
    and replaces rejected entries by the last accepted sample."""

    def __init__(self, model):
        self._model = model
        self.history = MCMCHistory()
        self._ref = None

    @torch.no_grad()
    def sample__(self, batch_size=1, generator=None, bookkeeping=False):
        """Return ``(y, logq, logp)`` after the Metropolis correction."""
        m = self._model
        gen = m.generator if generator is None else generator
        y, logq, logp = m.posterior.sample__(batch_size, generator=gen)
        if bookkeeping:
            self.history.bookkeeping(raw_logq=_to_numpy(logq),
                                     raw_logp=_to_numpy(logp))
        if self._ref is None:
            # no reference yet: seed the chain from the first proposal
            self._ref = (y[0], logq[0], logp[0])
        ref_y, ref_logq, ref_logp = self._ref

        lrand = torch.log(torch.rand(batch_size, generator=gen,
                                     dtype=logq.dtype, device=logq.device))
        accept_seq, indices = accept_scan_core(
            _to_numpy(lrand), _to_numpy(logq - logp),
            _to_numpy(ref_logq - ref_logp))
        idx = torch.from_numpy(indices).to(y.device)

        def take(ref, arr):
            return torch.cat([ref[None], arr]).index_select(0, idx)

        y, logq, logp = (take(ref_y, y), take(ref_logq, logq),
                         take(ref_logp, logp))
        self._ref = (y[-1], logq[-1], logp[-1])

        self.history.bookkeeping(accept_rate=float(np.mean(accept_seq)))
        if bookkeeping:
            self.history.bookkeeping(
                accept_seq=accept_seq,
                accept_ind=Metropolis.calc_accept_indices(accept_seq),
                logq=_to_numpy(logq), logp=_to_numpy(logp))
        return y, logq, logp
