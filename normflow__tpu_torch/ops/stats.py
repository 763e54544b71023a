"""Statistics: resampling, log(z), the effective sample size, formatting.

``Resampler``, ``estimate_logz`` and ``fmt_val_err`` are the numpy code of
``normflow__tpu/ops/stats.py:21-113``, copied as it is so that the same
seed gives the same numbers; ``calc_ess`` (l.95-106) is computed with
PyTorch on the tensor's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["Resampler", "estimate_logz", "calc_ess", "fmt_val_err"]


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


def estimate_logz(logqp, n_resamples: int = 10, method: str = "bootstrap",
                  seed=None):
    """Estimate ``log z`` from ``logqp = log q - log(p z)``:
    ``logsumexp(-logqp) - log N`` with a resampled error bar.  Returns
    ``(mean, std)``."""
    if isinstance(logqp, torch.Tensor):
        logqp = logqp.detach().cpu().numpy()
    logqp = np.asarray(logqp).ravel()
    n = logqp.shape[0]

    def calc_logz(x):
        x = np.asarray(x).ravel()
        m = np.max(x)
        return float(m + np.log(np.sum(np.exp(x - m))) - np.log(n))

    mean = calc_logz(-logqp)
    resampler = Resampler(method, seed=seed)
    std = resampler._std(
        [calc_logz(x) for x in resampler(-logqp, n_resamples)])
    return mean, std


def calc_ess(logq, logp=0.0):
    """Normalized effective sample size ``(sum w)^2 / (N sum w^2)`` of the
    importance weights ``w = p/q``, as a 0-d tensor."""
    logqp = torch.as_tensor(logq) - logp
    log_ess = (2 * torch.logsumexp(-logqp, dim=0)
               - torch.logsumexp(-2 * logqp, dim=0))
    return torch.exp(log_ess) / logqp.shape[0]


def fmt_val_err(value, error, err_digits: int = 1) -> str:
    """Format as ``value(err)``, e.g. ``0.914(9)``."""
    if not np.isfinite(error) or error <= 0 or not np.isfinite(value):
        return f"{value}+-{error}"
    digits = max(-int(np.floor(np.log10(error))) + err_digits - 1, 0)
    return "{0:.{2}f}({1:.0f})".format(value, error * 10**digits, digits)
