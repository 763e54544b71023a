r"""Mask-based coupling flows with per-site rational-quadratic splines.

Counterpart of ``Coupling`` (``normflow__tpu/models/couplings.py:36-93``)
and ``RQSplineCoupling`` (l.214-284).  Net ``k`` reads the frozen
partition and parameterises the transform of partition ``k % 2``.  The
conditioner is a PyTorch conv stack on NCHW data; its ``(B, 3m-2, *lat)``
output goes straight to the fused coupling kernel's wrapper
(``ops.kernels.rqs_coupling``), which dispatches on the tensor's device.
"""

from __future__ import annotations

from torch import nn

from ..ops.kernels.spline_coupling import rqs_coupling
from .core import Flow, sum_density

__all__ = ["Coupling", "RQSplineCoupling"]


class Coupling(Flow):
    """Base coupling: ``mask.split(x) -> (x0, x1)``, net ``k`` transforms
    partition ``k % 2`` from the other one, ``mask.cat`` reassembles."""

    def __init__(self, nets, *, mask):
        super().__init__()
        self.nets = nn.ModuleList(nets)
        self.mask = mask

    def forward(self, x, log0=0.0, *, density: bool = False):
        x = list(self.mask.split(x))
        for k, net in enumerate(self.nets):
            parity = k % 2
            x[parity], log0 = self.atomic_forward(
                x_active=x[parity], x_frozen=x[1 - parity], parity=parity,
                net=net, log0=log0, density=density)
        return self.mask.cat(*x), log0

    def backward(self, x, log0=0.0, *, density: bool = False):
        x = list(self.mask.split(x))
        for k in reversed(range(len(self.nets))):
            parity = k % 2
            x[parity], log0 = self.atomic_backward(
                x_active=x[parity], x_frozen=x[1 - parity], parity=parity,
                net=self.nets[k], log0=log0, density=density)
        return self.mask.cat(*x), log0

    def atomic_forward(self, *, x_active, x_frozen, parity, net, log0,
                       density):
        raise NotImplementedError

    def atomic_backward(self, *, x_active, x_frozen, parity, net, log0,
                        density):
        raise NotImplementedError

    @staticmethod
    def preprocess_fz(x):
        """The frozen partition as a one-channel NCHW input."""
        return x.unsqueeze(1)


class RQSplineCoupling(Coupling):
    """Coupling with per-site RQ splines of ``m`` free knots: the net emits
    ``3m - 2`` channels; ``extrap`` sides are ``None`` or ``'linear'``."""

    def __init__(self, nets, *, mask, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
                 extrap=None):
        super().__init__(nets, mask=mask)
        self.xlim, self.ylim = tuple(xlim), tuple(ylim)
        self.extrap = dict(extrap or {})

    def _transform(self, x_active, x_frozen, parity, net, inverse):
        out = net(self.preprocess_fz(x_frozen)).contiguous()
        fx, logg = rqs_coupling(
            x_active.contiguous(), out, xlim=self.xlim, ylim=self.ylim,
            left=self.extrap.get("left"), right=self.extrap.get("right"),
            inverse=inverse)
        return (self.mask.purify(fx, channel=parity),
                self.mask.purify(logg, channel=parity))

    def atomic_forward(self, *, x_active, x_frozen, parity, net, log0,
                       density):
        fx, logg = self._transform(x_active, x_frozen, parity, net, False)
        return fx, log0 + sum_density(logg, density)

    def atomic_backward(self, *, x_active, x_frozen, parity, net, log0,
                        density):
        fx, logg = self._transform(x_active, x_frozen, parity, net, True)
        return fx, log0 + sum_density(logg, density)
