r"""Spectral flows: inverse power spectral density, FFT flow, mean-field
flow and the PSD block.

Counterpart of ``normflow__tpu/models/spectral.py``: ``IPSD`` (l.26-69),
``FFTFlow`` (l.134-231), ``MeanFieldFlow`` (l.234-272), ``PSDBlock``
(l.275-311).  The FFT is ``torch.fft.rfftn``/``irfftn``; the spectral
multiply is elementwise in k-space and the exact log-Jacobian carries the
rfft redundancy correction.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.lattice import rfft_lattice_k2
from .core import Flow
from .elementwise import DistConvertor, SplineFlow

__all__ = ["IPSD", "FFTFlow", "MeanFieldFlow", "PSDBlock"]


class IPSD(nn.Module):
    """Inverse power spectral density ``y0 + y1 * spline(k^2 / k^2_max)``
    with ``(y0, y1) = exp(logy)``; ``ignore_zeromode`` pins the k = 0
    weight to 1 so the zero mode passes the FFT flow untouched."""

    # transplant order of the JAX leaves: the spline's weights, then logy
    leaf_order = ("spline", "logy")

    def __init__(self, knots_len, *, logy, ignore_zeromode=False,
                 dtype=None, device=None):
        super().__init__()
        self.spline = SplineFlow(knots_len, dtype=dtype, device=device)
        self.logy = nn.Parameter(torch.as_tensor(logy, dtype=dtype,
                                                 device=device).clone())
        self.ignore_zeromode = ignore_zeromode

    def forward(self, x):
        y = torch.exp(self.logy)
        s, _ = self.spline.forward(x, density=True)
        sigma_k2 = y[0] + y[1] * s
        if self.ignore_zeromode:
            sigma_k2 = sigma_k2.clone()  # out of place: s may need its grad
            # a fill, not a copy from a host scalar: a CUDA graph holds it
            sigma_k2[(0,) * x.dim()].fill_(1.0)
        return sigma_k2


class FFTFlow(Flow):
    r"""Linear spectral flow ``y = irfftn(rfftn(x) * w)``,
    ``w = ipsd^{-1/2}``, over the trailing ``len(lat_shape)`` axes.  The
    IPSD starts at unit effective mass and kappa: ``logy = (0, log k2_max)``
    (``FFTFlow.build`` with its defaults)."""

    def __init__(self, lat_shape, knots_len=10, *, ignore_zeromode=False,
                 dtype=None, device=None):
        super().__init__()
        self.lat_shape = tuple(lat_shape)
        max_k2 = float(torch.max(rfft_lattice_k2(self.lat_shape,
                                                 torch.float64)))
        self.ipsd_net = IPSD(knots_len, logy=[0.0, math.log(max_k2)],
                             ignore_zeromode=ignore_zeromode, dtype=dtype,
                             device=device)

    @property
    def _fft_dims(self):
        return tuple(range(-len(self.lat_shape), 0))

    def _weight(self, x):
        k2 = rfft_lattice_k2(self.lat_shape, x.dtype, x.device)
        return 1.0 / torch.sqrt(self.ipsd_net(k2 / torch.max(k2)))

    def forward(self, x, log0=0.0, *, density: bool = False):
        w = self._weight(x)
        dims = self._fft_dims
        y = torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * w,
                             s=self.lat_shape, dim=dims)
        return y, log0 + self.log_jacobian(w, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        w = self._weight(x)
        dims = self._fft_dims
        y = torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) / w,
                             s=self.lat_shape, dim=dims)
        return y, log0 - self.log_jacobian(w, density)

    def log_jacobian(self, w, density: bool = False):
        """log|det| of the spectral multiply.  Every rfft mode appears twice
        (k and -k) except the planes that are their own conjugate: the
        k_last = 0 plane always, the Nyquist plane only when the last extent
        is even."""
        dims = self._fft_dims

        def sumlog(a):
            return torch.sum(torch.log(a), dim=dims)

        logj = 2 * sumlog(w) - sumlog(w[..., 0:1])
        if self.lat_shape[-1] % 2 == 0:
            logj = logj - sumlog(w[..., -1:])
        if not density:
            return logj
        n = math.prod(self.lat_shape)
        return (logj / n).expand(self.lat_shape)


class MeanFieldFlow(Flow):
    """Distribution convertor for the volume-mean mode.  Inside the PSD
    block it receives the mean field and ``rvol = sqrt(V)``: the mean is
    scaled by ``rvol``, converted and scaled back."""

    def __init__(self, knots_len=10, *, dtype=None, device=None, **kwargs):
        super().__init__()
        self.dc = DistConvertor(knots_len, dtype=dtype, device=device,
                                **kwargs)

    def forward(self, x, log0=0.0, *, rvol, density: bool = False):
        y_scaled, log0 = self.dc.forward(x * rvol, log0, density=density)
        return y_scaled / rvol, log0

    def backward(self, x, log0=0.0, *, rvol, density: bool = False):
        y_scaled, log0 = self.dc.backward(x * rvol, log0, density=density)
        return y_scaled / rvol, log0


def _spread_density(logj, lat_shape):
    """Spread a per-sample logJ uniformly over the lattice as a density."""
    n = math.prod(lat_shape)
    logj = logj.reshape(logj.shape[0], -1).sum(dim=1)
    return (logj / n).reshape(-1, *([1] * len(lat_shape))).expand(
        -1, *lat_shape)


class PSDBlock(Flow):
    """Mean + fluctuation split: ``MeanFieldFlow`` on the mean, ``FFTFlow``
    on the fluctuation."""

    def __init__(self, mfnet, fftnet):
        super().__init__()
        if not fftnet.ipsd_net.ignore_zeromode:
            # the mean-field flow owns the zero mode
            raise ValueError(
                "PSDBlock needs an fftnet built with ignore_zeromode=True")
        self.mfnet = mfnet
        self.fftnet = fftnet

    def forward(self, x, log0=0.0, *, density: bool = False):
        return self._split_apply(x, log0, density, inverse=False)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return self._split_apply(x, log0, density, inverse=True)

    def _split_apply(self, x, log0, density, inverse):
        dims = tuple(range(1, x.dim()))
        rvol = float(math.prod(x.shape[1:])) ** 0.5
        x_mean = torch.mean(x, dim=dims, keepdim=True)
        mf = self.mfnet.backward if inverse else self.mfnet.forward
        fft = self.fftnet.backward if inverse else self.fftnet.forward
        y_mf, logj_mf = mf(x_mean, rvol=rvol, density=False)
        if density:
            logj_mf = _spread_density(logj_mf, x.shape[1:])
        y_fft, logj_fft = fft(x - x_mean, density=density)
        return y_mf + y_fft, log0 + logj_mf + logj_fft
