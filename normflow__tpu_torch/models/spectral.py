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

Under a space axis (``parallel/space.py``) the FFT flow gathers each
sample's whole lattice on every rank, transforms it and keeps the slab's
rows (an all-to-all FFT is later work), and the volume mean is the space
group's sum of the slabs' sums; the constant log-Jacobians of the FFT and
of the mean-field flow count once, on space rank 0.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..ops.lattice import rfft_lattice_k2
from ..parallel import space
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

    @classmethod
    def build(cls, knots_len, *, logy, ignore_zeromode=False, smooth=False,
              dtype=None, device=None, **spline_kwargs):
        """The JAX package's factory."""
        return cls(knots_len, logy=logy, ignore_zeromode=ignore_zeromode,
                   smooth=smooth, dtype=dtype, device=device,
                   **spline_kwargs)

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

    @classmethod
    def build(cls, knots_len, *, logy, smooth=False, dtype=None,
              device=None, **kwargs):
        """The JAX package's factory."""
        return cls(knots_len, logy=logy, smooth=smooth, dtype=dtype,
                   device=device, **kwargs)

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

    @classmethod
    def build(cls, lat_shape, knots_len=10, eff_mass2=1.0, eff_kappa=1.0,
              a=1.0, ignore_zeromode=False, dtype=None, *, device=None,
              **ipsd_kwargs):
        """The JAX package's factory (the constructor initialises the
        IPSD as it does)."""
        return cls(lat_shape, knots_len, eff_mass2=eff_mass2,
                   eff_kappa=eff_kappa, a=a, ignore_zeromode=ignore_zeromode,
                   dtype=dtype, device=device, **ipsd_kwargs)

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
        y = self._multiply(x, lambda k: k * w)
        return y, log0 + self.log_jacobian(w, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        w = self._weight(x)
        y = self._multiply(x, lambda k: k / w)
        return y, log0 - self.log_jacobian(w, density)

    def _multiply(self, x, fn):
        """``irfftn(fn(rfftn(x)))`` over the lattice axes.  On a slab
        (``parallel/space.py``) every rank gathers each sample's whole
        lattice, transforms it and keeps its slab's rows (the JAX
        package's layout on the CPU, ``docs/DISTRIBUTED.md:50-52``)."""
        dims = self._fft_dims
        slab = space.current()
        if slab is None:
            return torch.fft.irfftn(fn(torch.fft.rfftn(x, dim=dims)),
                                    s=self.lat_shape, dim=dims)
        axis = x.dim() - len(self.lat_shape)
        whole = space.gather_rows(x, axis, slab)
        y = torch.fft.irfftn(fn(torch.fft.rfftn(whole, dim=dims)),
                             s=self.lat_shape, dim=dims)
        return y.narrow(axis, slab.row0, slab.rows)

    def log_jacobian(self, w, density: bool = False):
        """log|det| of the spectral multiply.  Every rfft mode appears twice
        (k and -k) except the planes that are their own conjugate: the
        k_last = 0 plane always, the Nyquist plane only when the last extent
        is even.  On a slab the per-sample value counts on space rank 0
        only, and the density covers the slab's sites."""
        dims = self._fft_dims

        def sumlog(a):
            return torch.sum(torch.log(a), dim=dims)

        logj = 2 * sumlog(w) - sumlog(w[..., 0:1])
        if self.lat_shape[-1] % 2 == 0:
            logj = logj - sumlog(w[..., -1:])
        slab = space.current()
        if not density:
            return space.once(logj, slab)
        n = math.prod(self.lat_shape)
        return (logj / n).expand(_local_shape(self.lat_shape, slab))


class MeanFieldFlow(Flow):
    """Distribution convertor (``DistConvertor(knots_len, **kwargs)``) for
    the volume-mean mode.  Inside the PSD block it receives the mean field
    and ``rvol = sqrt(V)``: the mean is scaled by ``rvol``, converted and
    scaled back.  Without ``rvol`` it takes the whole field, converts its
    mean and leaves the fluctuation as it is; its log-Jacobian density is
    then spread over the lattice."""

    @classmethod
    def build(cls, knots_len=10, dtype=None, *, device=None, **kwargs):
        """The JAX package's factory, whose ``DistConvertor.build`` takes
        ``symmetric=False`` unless it is given."""
        kwargs.setdefault("symmetric", False)
        return cls(knots_len, dtype=dtype, device=device, **kwargs)

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
        slab = space.current()
        rvol = float(_volume(x.shape[1:], slab)) ** 0.5
        x_mean = _lattice_mean(x, slab)
        y_scaled, logj = fn(x_mean * rvol, 0.0, density=False)
        if density:
            logj = _spread_density(logj, x.shape[1:], slab)
        else:
            logj = space.once(logj, slab)
        return x + (y_scaled / rvol - x_mean), log0 + logj


def _local_shape(lat_shape, slab):
    """The lattice's shape, or its slab's."""
    if slab is None:
        return tuple(lat_shape)
    return (slab.rows, *lat_shape[1:])


def _volume(local_shape, slab):
    """The whole lattice's sites, from the local lattice's shape: on a
    slab, the lattice's rows times the sites of a row."""
    if slab is None:
        return math.prod(local_shape)
    return slab.length * math.prod(local_shape[1:])


def _lattice_mean(x, slab):
    """Each sample's mean over the lattice, ``(B, 1, ...)``: on a slab,
    the slabs' sums summed over the space group (``space.psum``)."""
    dims = tuple(range(1, x.dim()))
    if slab is None:
        return torch.mean(x, dim=dims, keepdim=True)
    total = space.psum(torch.sum(x, dim=dims, keepdim=True), slab)
    return total / _volume(x.shape[1:], slab)


def _spread_density(logj, lat_shape, slab=None):
    """Spread a per-sample logJ uniformly over the lattice as a density
    (``lat_shape`` the local lattice's: on a slab, the whole lattice's
    share of each of the slab's sites)."""
    n = _volume(lat_shape, slab)
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
        slab = space.current()
        rvol = float(_volume(x.shape[1:], slab)) ** 0.5
        x_mean = _lattice_mean(x, slab)
        mf = self.mfnet.backward if inverse else self.mfnet.forward
        fft = self.fftnet.backward if inverse else self.fftnet.forward
        y_mf, logj_mf = mf(x_mean, rvol=rvol, density=False)
        if density:
            logj_mf = _spread_density(logj_mf, x.shape[1:], slab)
        else:
            logj_mf = space.once(logj_mf, slab)
        y_fft, logj_fft = fft(x - x_mean, density=density)
        return y_mf + y_fft, log0 + logj_mf + logj_fft
