r"""Gauge-equivariant U(1) flows: plaquette couplings with circular splines.

Counterpart of ``normflow__tpu/models/gauge.py`` (BASELINE.json config 5):

- flow variables are link angles ``theta[b, mu, x0, x1]`` in [-pi, pi);
- a coupling transforms the plaquette angles of an "active" stripe with a
  circular rational-quadratic spline conditioned on gauge-invariant
  features (cos and sin of the frozen plaquettes), then pushes the change
  into one link per active plaquette, so the flow is gauge equivariant;
- the log-Jacobian is ``log f'(P)`` per updated link.

Updating ``theta_1(x)`` changes ``P(x)`` and ``P(x - e0)``; with active
columns ``x0 = offset (mod 4)`` the plaquettes at ``offset + 1, offset +
2`` are frozen (the conditioner's input) and ``offset + 3`` passive.  The
offsets 0..3 and both link directions make the 8 layers of a cycle.

The conditioner is a ``ConvNet`` on NCHW data: ``[cos, sin]`` on axis 1
(the JAX package stacks them channels-last), its ``3(m - 1)`` output
channels moved to the last axis for the knots.  The frozen mask and the
stripe's index tensor are built once per device and dtype, so a captured
graph copies nothing from the host; the stripe's new links go into a new
tensor with ``index_copy`` (the JAX package's ``.at[].set``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import spline as sp
from .core import Flow, FlowList
from .elementwise import softplus_log2
from .nets import ConvNet

__all__ = ["U1PlaquetteCoupling", "U1AngleAction", "u1_plaq_angle",
           "wrap_angle", "build_u1_gauge_flow"]

_PI = math.pi


def wrap_angle(x):
    """Wrap to [-pi, pi) (a floored modulo, as ``jnp``'s ``%``)."""
    return torch.remainder(x + _PI, 2 * _PI) - _PI


def u1_plaq_angle(theta):
    """Plaquette angle ``P(x) = t0(x) + t1(x+e0) - t0(x+e1) - t1(x)``.

    ``theta``: (..., 2, L0, L1) link angles; lattice axes are the last two.
    """
    t0 = theta[..., 0, :, :]
    t1 = theta[..., 1, :, :]
    return wrap_angle(t0 + torch.roll(t1, -1, -2) - torch.roll(t0, -1, -1)
                      - t1)


class U1AngleAction:
    r"""Wilson action on link angles: ``S = -beta sum_x cos P(x)``, the
    angle-variable counterpart of ``actions.U1GaugeAction``."""

    def __init__(self, beta=1.0):
        self.beta = beta

    def __call__(self, theta):
        return self.action(theta)

    def action(self, theta):
        p = u1_plaq_angle(theta)
        return -self.beta * torch.sum(torch.cos(p),
                                      dim=tuple(range(1, p.dim())))

    def action_density(self, theta):
        return -self.beta * torch.cos(u1_plaq_angle(theta))

    def calc_topo_charge(self, theta):
        p = u1_plaq_angle(theta)
        return torch.sum(p, dim=tuple(range(1, p.dim()))) / (2 * _PI)

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz


def _circular_spline_knots(out):
    """Circular RQ-spline knots on [-pi, pi] from ``3(m-1)`` channels on
    the last axis: endpoints pinned to (+-pi, +-pi), the boundary
    derivative shared (``d[0] == d[m-1]``), a C^1 circle diffeomorphism."""
    m1 = out.shape[-1] // 3  # = m - 1 segments
    wx, wy, wd = torch.split(out, [m1, m1, out.shape[-1] - 2 * m1], dim=-1)
    kx = sp.knot_coords(wx, -_PI, 2 * _PI)
    ky = sp.knot_coords(wy, -_PI, 2 * _PI)
    d = softplus_log2(wd)
    return kx, ky, torch.cat([d, d[..., :1]], dim=-1)


class U1PlaquetteCoupling(Flow):
    """One masked plaquette-coupling layer for 2-D U(1).

    ``mu``: the link direction updated (0 or 1); ``offset``: the active
    stripe's phase (``coord % 4 == offset`` along lattice axis ``1 - mu``).
    ``net`` maps 2 channels (cos, sin of the frozen plaquettes, NCHW) to
    ``3(m-1)`` spline-parameter channels.  Input ``(B, 2, L0, L1)``."""

    def __init__(self, net, mu=1, offset=0):
        super().__init__()
        self.net = net
        self.mu = mu
        self.offset = offset
        self._cache = {}

    @property
    def _axis(self):
        """The lattice axis whose coordinate defines the stripes."""
        return 0 if self.mu == 1 else 1

    def _stripe(self, arr):
        """The active stripe of ``arr``, whose last two axes are the
        lattice: every 4th row (``_axis`` 0) or column from ``offset``."""
        if self._axis == 0:
            return arr[..., self.offset::4, :]
        return arr[..., self.offset::4]

    def _tables(self, lat_shape, like):
        """The frozen 0/1 mask ``lat_shape`` and the stripe's coordinates
        along ``_axis``, on ``like``'s device and dtype, built once."""
        key = (tuple(lat_shape), like.device, like.dtype)
        if key not in self._cache:
            n = lat_shape[self._axis]
            if n % 4:
                raise ValueError("stripe masking needs the lattice dim "
                                 "% 4 == 0")
            coord = np.arange(n) % 4
            frozen = ((coord == (self.offset + 1) % 4)
                      | (coord == (self.offset + 2) % 4))
            shape = (-1, 1) if self._axis == 0 else (1, -1)
            frozen = frozen.reshape(shape) * np.ones(lat_shape)
            self._cache[key] = (
                torch.as_tensor(frozen, dtype=like.dtype, device=like.device),
                torch.arange(self.offset, n, 4, device=like.device))
        return self._cache[key]

    def _transform(self, theta, inverse):
        p = u1_plaq_angle(theta)
        frozen, idx = self._tables(p.shape[-2:], p)
        pf = p * frozen
        out = self.net(torch.stack([torch.cos(pf), torch.sin(pf)], dim=1))
        # knots and the spline on the active stripe only (a quarter of the
        # sites); the conditioner sees the whole masked lattice
        p_act = self._stripe(p)
        kx, ky, kd = _circular_spline_knots(self._stripe(out).movedim(1, -1))
        p_new, g = sp.rqs(p_act, kx, ky, kd, inverse=inverse)
        delta = wrap_angle(p_new - p_act)
        # theta_mu(x) appears in P(x) with coefficient +1 for mu = 0 and -1
        # for mu = 1, and in no frozen plaquette: shift it by delta / c
        c = 1.0 if self.mu == 0 else -1.0
        theta_mu = theta[:, self.mu]
        dim = theta_mu.dim() - 2 + self._axis
        theta_mu = theta_mu.index_copy(
            dim, idx, wrap_angle(self._stripe(theta_mu) + c * delta))
        return self._put_mu(theta, theta_mu), torch.log(g), (dim, idx)

    def _put_mu(self, x, x_mu):
        """``x`` with ``x[:, mu]`` replaced by ``x_mu``, a new tensor."""
        parts = [x_mu if m == self.mu else x[:, m] for m in range(2)]
        return torch.stack(parts, dim=1)

    def forward(self, x, log0=0.0, *, density: bool = False):
        theta, logg, where = self._transform(x, inverse=False)
        return theta, log0 + self._reduce(logg, x, density, where)

    def backward(self, x, log0=0.0, *, density: bool = False):
        theta, logg, where = self._transform(x, inverse=True)
        return theta, log0 + self._reduce(logg, x, density, where)

    def _reduce(self, logg, x, density, where):
        if density:
            # the plaquette density on the updated links' active stripe
            dim, idx = where
            zmu = torch.zeros_like(x[:, self.mu]).index_copy(dim, idx, logg)
            return self._put_mu(torch.zeros_like(x), zmu)
        return torch.sum(logg, dim=(-2, -1))


def build_u1_gauge_flow(generator, lat_shape, knots_len=8, hidden=(16,),
                        n_cycles=1, dtype=None, device=None):
    """Stack of 8 plaquette couplings per cycle (both directions x 4
    offsets), updating every link; each conditioner a ``ConvNet`` 2 ->
    ``hidden`` -> ``3(knots_len - 1)``, 3x3 circular, tanh, with bias, its
    weights drawn from ``generator``.  Returns a ``FlowList``."""
    m1 = knots_len - 1
    layers = []
    for _ in range(n_cycles):
        for mu in (0, 1):
            for offset in range(4):
                net = ConvNet(2, 3 * m1, 3, conv_dim=len(lat_shape),
                              hidden_sizes=tuple(hidden),
                              acts=("tanh",) * len(hidden) + (None,),
                              generator=generator, dtype=dtype, device=device)
                layers.append(U1PlaquetteCoupling(net, mu=mu, offset=offset))
    return FlowList(layers)
