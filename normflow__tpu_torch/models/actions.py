r"""Lattice actions (``normflow__tpu/models/actions.py``).

The scalar phi^4 action

.. math::
    S = \sum_x ( w_2 \phi^2 + w_4 \phi^4 ) - w_0 \sum_{x,\mu} \phi(x)
        \phi(x+\hat\mu)

with lattice-spacing-absorbed couplings from :meth:`get_coef` goes through
the fused kernel's wrapper (``ops.kernels.phi4_action``), which dispatches
on the tensor's device; the action density and the potential are plain
PyTorch.  The gauge actions (``GaugeAction``, ``U1GaugeAction``,
``SchwingerAction``, ``MatrixAction``) are plain PyTorch, as they are plain
XLA in the JAX package: links ``[B, mu, *lat, nc, nc]`` (U(1): complex
``[B, mu, *lat]``), plaquettes by batched complex ``@``.  The staggered
fermion log-det of ``models/fermions.py`` is re-exported here, as the JAX
module does.
"""

from __future__ import annotations

import math

import torch

from ..ops.kernels.phi4 import phi4_action, phi4_action_slab
from ..parallel import space

__all__ = [
    "ScalarPhi4Action", "GaugeAction", "U1GaugeAction", "MatrixAction",
    "SchwingerAction", "calc_trace", "calc_reduced_trace",
]


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
        """Per-sample action; on a slab (``parallel/space.py``) the slab's
        part, through the slab kernel with the neighbours' edge rows
        (``ops.kernels.phi4.phi4_action_slab``, whose docstring says why
        the halo goes in detached)."""
        w = self.get_coef(cfgs.dim() - 1)
        slab = space.current()
        if slab is None:
            return phi4_action(cfgs, *w)
        return phi4_action_slab(cfgs, space.edge_rows(cfgs, slab), *w)

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


def calc_trace(x):
    return torch.sum(torch.diagonal(x, dim1=-2, dim2=-1), dim=-1)


def calc_reduced_trace(x):
    """Reduced trace = trace / n."""
    return torch.mean(torch.diagonal(x, dim1=-2, dim2=-1), dim=-1)


class GaugeAction:
    r"""Wilson plaquette action ``S = -beta sum Re tr'(plaq)``; links
    ``cfgs[batch, mu, *lattice, nc, nc]``."""

    def __init__(self, *, beta=1.0, ndim=2, nc=2):
        self.beta, self.ndim, self.nc = beta, ndim, nc

    def __call__(self, cfgs):
        return self.action(cfgs)

    def action(self, cfgs):
        dims = tuple(range(1, 1 + self.ndim))
        act = 0.0
        for mu in range(1, self.ndim):
            for nu in range(mu):
                act = act + torch.sum(self.calc_plaq(cfgs, mu=mu, nu=nu),
                                      dim=dims)
        return -self.beta * act

    def action_density(self, cfgs):
        dens = 0.0
        for mu in range(1, self.ndim):
            for nu in range(mu):
                dens = dens + self.calc_plaq(cfgs, mu=mu, nu=nu)
        return -self.beta * dens

    def calc_plaq(self, cfgs, *, mu, nu, real=True):
        """Plaquette in the (mu, nu) plane; lattice axes start at 2 of
        ``cfgs`` (batch, direction, *lattice, ...)."""
        x_mu = cfgs[:, mu]
        x_nu = cfgs[:, nu]
        plaq = self.plaq_rule(x_mu, torch.roll(x_nu, -1, 1 + mu),
                              torch.roll(x_mu, -1, 1 + nu), x_nu)
        return plaq.real if real else plaq

    @staticmethod
    def plaq_rule(a, b, c, d):
        return calc_reduced_trace((a @ b) @ (d @ c).mH)

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz

    @property
    def parameters(self):
        return dict(beta=self.beta, ndim=self.ndim)


class U1GaugeAction(GaugeAction):
    """U(1): links are complex phases ``cfgs[batch, mu, *lattice]``."""

    def __init__(self, *, beta=1.0, ndim=2, nc=1):
        super().__init__(beta=beta, ndim=ndim, nc=nc)

    @staticmethod
    def plaq_rule(a, b, c, d):
        return a * b * torch.conj(d * c)

    def calc_topo_charge(self, cfgs):
        """Topological charge from the plaquette angles."""
        topo = 0.0
        for mu in range(1, self.ndim):
            for nu in range(mu):
                ang = torch.angle(self.calc_plaq(cfgs, mu=mu, nu=nu,
                                                 real=False))
                topo = topo + torch.sum(
                    ang, dim=tuple(range(1, ang.dim()))) / (2 * math.pi)
        return topo


class SchwingerAction:
    r"""Schwinger model: the U(1) gauge action minus a pluggable
    ``logdet_func(cfgs) -> per-sample log det`` of the fermion matrix."""

    def __init__(self, *, gauge, logdet_func=None):
        self.gauge, self.logdet_func = gauge, logdet_func

    @classmethod
    def build(cls, *, beta, ndim=2, logdet_func=None):
        return cls(gauge=U1GaugeAction(beta=beta, ndim=ndim),
                   logdet_func=logdet_func)

    def __call__(self, cfgs):
        return self.action(cfgs)

    def action(self, cfgs):
        act = self.gauge.action(cfgs)
        if self.logdet_func is not None:
            act = act - self.logdet_func(cfgs)
        return act

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz


class MatrixAction:
    r"""Matrix-model action ``S = -beta re tr'(M Gamma)``; ``staples_matrix``
    is the optional Gamma."""

    def __init__(self, *, beta=1.0, staples_matrix=None):
        self.beta, self.staples_matrix = beta, staples_matrix

    def __call__(self, cfgs):
        return self.action(cfgs)

    def action(self, cfgs):
        act = self.action_density(cfgs)
        if act.dim() > 1:
            act = torch.sum(act, dim=tuple(range(1, act.dim())))
        return act

    def action_density(self, cfgs):
        if self.staples_matrix is not None:
            cfgs = cfgs @ self.staples_matrix
        return -self.beta * calc_reduced_trace(cfgs).real

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz

    @property
    def parameters(self):
        return {"beta": self.beta}


# the staggered-fermion log-det for SchwingerAction, as the JAX module
# exports it
from .fermions import (  # noqa: E402
    StaggeredFermionLogDet, build_schwinger_action, staggered_dirac_matrix,
)

__all__ += ["StaggeredFermionLogDet", "build_schwinger_action",
            "staggered_dirac_matrix"]
