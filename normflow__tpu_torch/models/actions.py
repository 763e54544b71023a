r"""The scalar phi^4 action (``normflow__tpu/models/actions.py:26-88``).

.. math::
    S = \sum_x ( w_2 \phi^2 + w_4 \phi^4 ) - w_0 \sum_{x,\mu} \phi(x)
        \phi(x+\hat\mu)

with lattice-spacing-absorbed couplings from :meth:`get_coef`.  The action
goes through the fused kernel's wrapper (``ops.kernels.phi4_action``),
which dispatches on the tensor's device; the action density and the
potential are plain PyTorch.
"""

from __future__ import annotations

import torch

from ..ops.kernels.phi4 import phi4_action

__all__ = ["ScalarPhi4Action"]


class ScalarPhi4Action:
    """Per-sample phi^4 action; axis 0 of ``cfgs`` is the batch axis."""

    def __init__(self, *, kappa=1.0, m_sq=0.0, lambd=0.0, a=1.0):
        self.kappa, self.m_sq, self.lambd, self.a = kappa, m_sq, lambd, a

    def get_coef(self, lat_ndim: int):
        a = self.a
        kappa = self.kappa * a ** (lat_ndim - 2)
        m_sq = self.m_sq * a**lat_ndim
        lambd = self.lambd * a**lat_ndim
        w0 = 0.5 * (2 * kappa)
        w2 = 0.5 * (m_sq + 2 * kappa * lat_ndim)
        w4 = lambd
        return w0, w2, w4

    def __call__(self, cfgs):
        return self.action(cfgs)

    def action(self, cfgs):
        return phi4_action(cfgs, *self.get_coef(cfgs.dim() - 1))

    def action_density(self, cfgs):
        """Per-site density with a symmetric, positive kinetic term; it
        sums to the action."""
        nd = cfgs.dim() - 1
        w0, w2, w4 = self.get_coef(nd)
        w2 = w2 - w0 * nd
        phi2 = cfgs * cfgs
        dens = w2 * phi2 + w4 * phi2 * phi2
        for mu in range(1, cfgs.dim()):
            dens = dens + (w0 / 4) * (cfgs - torch.roll(cfgs, -1, mu)) ** 2
            dens = dens + (w0 / 4) * (cfgs - torch.roll(cfgs, +1, mu)) ** 2
        return dens

    def potential(self, x):
        return self.m_sq * x**2 + self.lambd * x**4

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz
