"""Statistics: resampling and the effective sample size.

``Resampler`` is the numpy code of ``normflow__tpu/ops/stats.py:21-70``,
copied as it is so that the same seed gives the same numbers; ``calc_ess``
(l.95-106) is computed with PyTorch on the tensor's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["Resampler", "calc_ess"]


class Resampler:
    """Bootstrap / jackknife / shuffling resampler with binning.

    ``__call__`` yields resampled arrays; :meth:`eval` maps a statistic over
    the resamples and returns ``(mean, std)``.
    """

    def __init__(self, method: str = "bootstrap", seed=None):
        assert method in ("bootstrap", "jackknife", "shuffling")
        self.method = method
        self._rng = np.random.default_rng(seed)

    def __call__(self, samples, n_resamples: int = 100, binsize: int = 1,
                 batch_size: int | None = None):
        samples = np.asarray(samples)
        l_b = samples.shape[0] // binsize
        binned = samples[: l_b * binsize].reshape(l_b, binsize, -1)

        if self.method == "jackknife":
            n_resamples = l_b
            idx_fn = lambda i: np.delete(np.arange(l_b), i)
            out_len = (l_b - 1) * binsize
        elif self.method == "bootstrap":
            bs = l_b if batch_size is None else batch_size
            idx_fn = lambda i: self._rng.integers(l_b, size=bs)
            out_len = bs * binsize
        else:  # shuffling
            idx_fn = lambda i: self._rng.permutation(l_b)
            out_len = l_b * binsize

        tail = samples.shape[1:]
        for i in range(n_resamples):
            yield binned[idx_fn(i)].reshape(out_len, *tail)

    def eval(self, samples, fn: Callable = np.mean, **kwargs):
        vals = [fn(q) for q in self(samples, **kwargs)]
        return float(np.mean(vals)), self._std(vals)

    def _std(self, vals):
        """Resample spread -> standard error; jackknife spreads are
        inflated by sqrt(n-1)."""
        n = len(vals)
        std = float(np.std(vals))
        if self.method == "jackknife" and n > 1:
            std *= np.sqrt(n - 1.0)
        return std


def calc_ess(logq, logp=0.0):
    """Normalized effective sample size ``(sum w)^2 / (N sum w^2)`` of the
    importance weights ``w = p/q``, as a 0-d tensor."""
    logqp = torch.as_tensor(logq) - logp
    log_ess = (2 * torch.logsumexp(-logqp, dim=0)
               - torch.logsumexp(-2 * logqp, dim=0))
    return torch.exp(log_ess) / logqp.shape[0]
