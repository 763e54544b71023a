r"""Spectral flows: inverse power spectral density, FFT flow, mean-field
flow and the PSD block.

Counterpart of ``normflow__tpu/models/spectral.py``: ``IPSD`` and
``IPSDNoZeroMode``, ``FreeScalar``, ``FFTFlow``, ``MeanFieldFlow`` and
``PSDBlock``.  The FFT is ``torch.fft.rfftn``/``irfftn``; the spectral
multiply is elementwise in k-space and the exact log-Jacobian carries the
rfft redundancy correction.

``transfer`` (``normflow__tpu/models/spectral.py:63, 226, 328``) maps the
FFT flow to another lattice and spacing: the IPSD's log-scales absorb the
spacing's powers (``IPSD.apply_scale``) and the flow takes the new
``lat_shape``, from which its momentum grid is built at every call.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..ops.lattice import rfft_lattice_k2
from .core import Flow
from .elementwise import DistConvertor, SplineFlow

__all__ = ["IPSD", "IPSDNoZeroMode", "FreeScalar", "FFTFlow",
           "MeanFieldFlow", "PSDBlock"]


class IPSD(nn.Module):
    """Inverse power spectral density ``y0 + y1 * spline(k^2 / k^2_max)``
    with ``(y0, y1) = exp(logy)``; ``ignore_zeromode`` pins the k = 0
    weight to 1 so the zero mode passes the FFT flow untouched."""

    # transplant order of the JAX leaves: the spline's weights, then logy
    leaf_order = ("spline", "logy")

    def __init__(self, knots_len, *, logy, ignore_zeromode=False,
                 dtype=None, device=None, **spline_kwargs):
        super().__init__()
        self.spline = SplineFlow(knots_len, dtype=dtype, device=device,
                                 **spline_kwargs)
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

    @staticmethod
    def apply_scale(logy, *, a, ndim):
        """Absorb the lattice spacing's powers into the log-scales."""
        log_a = math.log(a)
        return [float(logy[0]) + log_a * ndim,
                float(logy[1]) + log_a * (ndim - 2)]

    def transfer(self, scale_factor=1, ndim=1):
        """A new IPSD at ``1 / scale_factor`` times the lattice spacing in
        ``ndim`` dimensions."""
        new = copy.deepcopy(self)
        log_a = math.log(1 / scale_factor)
        with torch.no_grad():
            new.logy.add_(torch.tensor([log_a * ndim, log_a * (ndim - 2)],
                                       dtype=new.logy.dtype,
                                       device=new.logy.device))
        return new

    def infrared_mass(self, max_lat_k2=None):
        """The dimensionless infrared mass ``exp(logy[0] / 2)``."""
        return torch.exp(0.5 * self.logy[0])


class IPSDNoZeroMode(nn.Module):
    """IPSD without the additive mass term, ``y0 * spline(k^2/k^2_max)``,
    the zero-mode weight pinned to 1."""

    leaf_order = ("spline", "logy")

    def __init__(self, knots_len, *, logy, dtype=None, device=None,
                 **spline_kwargs):
        super().__init__()
        self.spline = SplineFlow(knots_len, dtype=dtype, device=device,
                                 **spline_kwargs)
        self.logy = nn.Parameter(torch.as_tensor(logy, dtype=dtype,
                                                 device=device).clone())

    def forward(self, x):
        s, _ = self.spline.forward(x, density=True)
        sigma_k2 = torch.exp(self.logy[0]) * s
        sigma_k2[(0,) * x.dim()].fill_(1.0)
        return sigma_k2

    @staticmethod
    def apply_scale(logy, *, a, ndim):
        return [float(logy[0]) + math.log(a) * (ndim - 2)]

    def infrared_mass(self, max_lat_k2):
        """From the slope of the raw curve at k = 0 (the zero-mode pin is
        left out: it guards the FFT weight, it is not the curve)."""
        k = torch.tensor([1e-6 / max_lat_k2, 2e-6 / max_lat_k2],
                         dtype=self.logy.dtype, device=self.logy.device)
        s, _ = self.spline.forward(k, density=True)
        z = torch.exp(self.logy[0]) * s
        return torch.sqrt(z[0] / ((z[1] - z[0]) / 1e-6))


class FreeScalar:
    """The free theory's momentum grid (``calc_lattice_k2``)."""

    def __init__(self, lat_shape, kappa=None, m_sq=None):
        self.lat_shape = tuple(lat_shape)
        self.kappa, self.m_sq = kappa, m_sq

    def calc_lattice_k2(self, dtype=torch.float64, device=None):
        return rfft_lattice_k2(self.lat_shape, dtype, device)


class FFTFlow(Flow):
    r"""Linear spectral flow ``y = irfftn(rfftn(x) * w)``,
    ``w = ipsd^{-1/2}``, over the trailing ``len(lat_shape)`` axes.  The
    IPSD starts at the effective mass and kappa ``eff_mass2``,
    ``eff_kappa`` at spacing ``a``: ``logy = (log m2, log(kappa k2_max))``
    scaled by ``IPSD.apply_scale`` (``FFTFlow.build``); fewer than 2 knots
    give a smooth 2-knot spline.  ``ipsd_net`` replaces the IPSD (an
    ``IPSDNoZeroMode``, say); other keywords go to the IPSD's spline."""

    def __init__(self, lat_shape, knots_len=10, *, eff_mass2=1.0,
                 eff_kappa=1.0, a=1.0, ignore_zeromode=False, ipsd_net=None,
                 dtype=None, device=None, **ipsd_kwargs):
        super().__init__()
        self.lat_shape = tuple(lat_shape)
        if ipsd_net is None:
            max_k2 = float(torch.max(rfft_lattice_k2(self.lat_shape,
                                                     torch.float64)))
            if knots_len < 2:
                knots_len = 2
                ipsd_kwargs.setdefault("smooth", True)
            logy = IPSD.apply_scale(
                [math.log(eff_mass2), math.log(eff_kappa * max_k2)], a=a,
                ndim=len(self.lat_shape))
            ipsd_net = IPSD(knots_len, logy=logy,
                            ignore_zeromode=ignore_zeromode, dtype=dtype,
                            device=device, **ipsd_kwargs)
        self.ipsd_net = ipsd_net

    @property
    def infrared_mass(self):
        max_k2 = float(torch.max(rfft_lattice_k2(self.lat_shape,
                                                 torch.float64)))
        return self.ipsd_net.infrared_mass(max_lat_k2=max_k2)

    def transfer(self, scale_factor=1, shape=None, **extra):
        """A new flow on the lattice ``shape`` (default: this one's) at
        ``1 / scale_factor`` times the spacing; other keywords are for
        other flows."""
        new = copy.deepcopy(self)
        new.ipsd_net = self.ipsd_net.transfer(scale_factor=scale_factor,
                                              ndim=len(self.lat_shape))
        if shape is not None:
            new.lat_shape = tuple(shape)
        return new

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
    """Distribution convertor (``DistConvertor(knots_len, **kwargs)``) for
    the volume-mean mode.  Inside the PSD block it receives the mean field
    and ``rvol = sqrt(V)``: the mean is scaled by ``rvol``, converted and
    scaled back.  Without ``rvol`` it takes the whole field, converts its
    mean and leaves the fluctuation as it is; its log-Jacobian density is
    then spread over the lattice."""

    def __init__(self, knots_len=10, *, dtype=None, device=None, **kwargs):
        super().__init__()
        self.dc = DistConvertor(knots_len, dtype=dtype, device=device,
                                **kwargs)

    def forward(self, x, log0=0.0, *, rvol=None, density: bool = False):
        return self._convert(x, log0, density, rvol, self.dc.forward)

    def backward(self, x, log0=0.0, *, rvol=None, density: bool = False):
        return self._convert(x, log0, density, rvol, self.dc.backward)

    @staticmethod
    def _convert(x, log0, density, rvol, fn):
        if rvol is not None:
            y_scaled, log0 = fn(x * rvol, log0, density=density)
            return y_scaled / rvol, log0
        dims = tuple(range(1, x.dim()))
        rvol = float(math.prod(x.shape[1:])) ** 0.5
        x_mean = torch.mean(x, dim=dims, keepdim=True)
        y_scaled, logj = fn(x_mean * rvol, 0.0, density=False)
        if density:
            logj = _spread_density(logj, x.shape[1:])
        return x + (y_scaled / rvol - x_mean), log0 + logj


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
        if not getattr(fftnet.ipsd_net, "ignore_zeromode", True):
            # the mean-field flow owns the zero mode
            raise ValueError(
                "PSDBlock needs an fftnet built with ignore_zeromode=True")
        self.mfnet = mfnet
        self.fftnet = fftnet

    def transfer(self, **kwargs):
        return PSDBlock(self.mfnet.transfer(**kwargs),
                        self.fftnet.transfer(**kwargs))

    def forward(self, x, log0=0.0, *, density: bool = False):
        return self._split_apply(x, log0, density, inverse=False)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return self._split_apply(x, log0, density, inverse=True)

    def hack(self, x, log0=0.0):
        """The forward pass's parts: ``[(x_mean, log0), (y_mf, logj_mf),
        (y_fft, logj_fft), (y, log0 + logJ)]``."""
        rvol = float(math.prod(x.shape[1:])) ** 0.5
        x_mean = torch.mean(x, dim=tuple(range(1, x.dim())), keepdim=True)
        y_mf, logj_mf = self.mfnet.forward(x_mean, rvol=rvol)
        y_fft, logj_fft = self.fftnet.forward(x - x_mean)
        return [(x_mean, log0), (y_mf, logj_mf), (y_fft, logj_fft),
                (y_mf + y_fft, log0 + logj_mf + logj_fft)]

    _hack = hack  # the reference's spelling

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
