r"""The scalar phi^4 action (``normflow__tpu/models/actions.py:26-88``).

.. math::
    S = \sum_x ( w_2 \phi^2 + w_4 \phi^4 ) - w_0 \sum_{x,\mu} \phi(x)
        \phi(x+\hat\mu)

with lattice-spacing-absorbed couplings from :meth:`get_coef`.  The action
goes through the fused kernel's wrapper (``ops.kernels.phi4_action``),
which dispatches on the tensor's device.
"""

from __future__ import annotations

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

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz
