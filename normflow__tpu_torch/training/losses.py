"""Loss zoo for flow training (``normflow__tpu/training/losses.py``).

Every loss takes the per-sample ``(logq, logp)`` tensors of one batch and
returns a 0-d tensor on their device, differentiable where the JAX
function is.
"""

from __future__ import annotations

import math

import torch

from ..ops.stats import calc_ess as _calc_ess

__all__ = [
    "calc_kl_mean", "calc_kl_var", "calc_corrcoef", "calc_direct_kl_mean",
    "calc_kl_mean_includelogz", "calc_least_squares", "calc_minus_logz",
    "calc_ess", "calc_minus_ess",
]


def _log_n(x):
    return math.log(x.shape[0])


def calc_kl_mean(logq, logp):
    """Reverse KL estimated from samples of q (the default training loss)."""
    return torch.mean(logq - logp)


def calc_kl_var(logq, logp):
    return torch.var(logq - logp, correction=0)


def calc_corrcoef(logq, logp):
    """Pearson correlation of logq and logp."""
    return torch.corrcoef(torch.stack([logq, logp]))[0, 1]


def calc_direct_kl_mean(logq, logp):
    """Forward ("direct") KL via self-normalized importance weights."""
    logpq = logp - logq
    logz = torch.logsumexp(logpq, dim=0) - _log_n(logp)
    logpq = logpq - logz
    p_by_q = torch.exp(logpq)
    return torch.mean(p_by_q * logpq)


def calc_kl_mean_includelogz(logq, logp):
    logqp = logq - logp
    logz = torch.logsumexp(-logqp, dim=0) - _log_n(logp)
    return torch.mean(logqp) + logz


def calc_least_squares(logq, logp):
    logqp = logq - logp
    logz = torch.logsumexp(-logqp, dim=0) - _log_n(logp)
    return torch.mean((logqp + logz) ** 2)


def calc_minus_logz(logq, logp):
    logz = torch.logsumexp(logp - logq, dim=0) - _log_n(logp)
    return -logz


def calc_ess(logq, logp):
    """Normalized effective sample size (``ops.stats.calc_ess``)."""
    return _calc_ess(logq, logp)


def calc_minus_ess(logq, logp):
    return -calc_ess(logq, logp)
