r"""Lattice observables and chain metrology.

Counterpart of ``normflow__tpu/ops/observables.py``: the observables are
torch functions of a ``(B, *lat)`` batch of configurations on its own
device; the autocorrelation time and the effective sample size of a chain
are host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "phi2", "abs_mean_phi", "susceptibility", "binder_cumulant",
    "two_point_function", "integrated_autocorr_time", "effective_sample_size",
]


def _dims(cfgs):
    return tuple(range(1, cfgs.dim()))


def phi2(cfgs):
    """Volume-averaged ``phi^2`` per configuration: ``(B,)``."""
    return torch.mean(cfgs ** 2, dim=_dims(cfgs))


def abs_mean_phi(cfgs):
    """``|volume mean of phi|`` per configuration: ``(B,)``."""
    return torch.abs(torch.mean(cfgs, dim=_dims(cfgs)))


def susceptibility(cfgs):
    r"""``chi = V (<m^2> - <|m|>^2)`` with ``m = mean(phi)``, over the
    batch: a 0-d tensor."""
    v = float(math.prod(cfgs.shape[1:]))
    m = torch.mean(cfgs, dim=_dims(cfgs))
    return v * (torch.mean(m ** 2) - torch.mean(torch.abs(m)) ** 2)


def binder_cumulant(cfgs):
    r"""``U = 1 - <m^4> / (3 <m^2>^2)``: a 0-d tensor."""
    m = torch.mean(cfgs, dim=_dims(cfgs))
    return 1.0 - torch.mean(m ** 4) / (3.0 * torch.mean(m ** 2) ** 2)


def two_point_function(cfgs, axis: int = 1, connected: bool = True):
    """Zero-momentum two-point function along ``axis``: ``(B, L)``.  With
    ``connected=True`` the square of the ENSEMBLE mean over the batch is
    subtracted, so the rows depend on the batch; ``connected=False`` gives
    the raw rows, independent per configuration."""
    other = tuple(d for d in _dims(cfgs) if d != axis)
    slab = torch.mean(cfgs, dim=other) if other else cfgs  # (B, L)
    n = slab.shape[1]
    fk = torch.fft.rfft(slab, dim=1)
    corr = torch.fft.irfft(fk * torch.conj(fk), n=n, dim=1) / n
    if not connected:
        return corr
    return corr - torch.mean(slab) ** 2


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def integrated_autocorr_time(series, c: float = 5.0) -> float:
    """Integrated autocorrelation time with automatic windowing (Sokal's
    ``tau_int``, window ``W >= c * tau``)."""
    x = _numpy(series).astype(np.float64).ravel()
    n = x.size
    x = x - x.mean()
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n].real
    if acf[0] == 0:
        return 1.0
    acf = acf / acf[0]
    tau = 1.0
    for w in range(1, n):
        tau = 1.0 + 2.0 * np.sum(acf[1:w + 1])
        if w >= c * tau:
            break
    return float(max(tau, 1.0))


def effective_sample_size(series) -> float:
    """Effective sample count ``N / tau_int`` of a chain's observable."""
    x = _numpy(series).ravel()
    return float(x.size / integrated_autocorr_time(x))
