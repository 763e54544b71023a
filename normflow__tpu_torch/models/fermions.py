r"""Staggered fermions: the Dirac log-determinant for the Schwinger model.

Counterpart of ``normflow__tpu/models/fermions.py``.  The staggered
(Kogut-Susskind) operator on a d-dim periodic lattice

.. math::
    D_{x,y} = m\,\delta_{x,y} + \tfrac{1}{2}\sum_\mu \eta_\mu(x)
        \big[ U_\mu(x)\,\delta_{x+\hat\mu,y}
            - U^*_\mu(x-\hat\mu)\,\delta_{x-\hat\mu,y} \big],

with :math:`\eta_\mu(x) = (-1)^{x_0+\dots+x_{\mu-1}}` and (by default)
antiperiodic boundary conditions in time (axis 0).  The hopping part is
anti-Hermitian, so ``det D`` is real and positive for ``m > 0``.

- :class:`StaggeredFermionLogDet`: exact, by the even/odd Schur complement
  (``det D = det(m^2 I + A_eo^H A_eo)``, a batched complex Cholesky) or the
  dense ``slogdet`` (the oracle).  The Cholesky is ``cholesky_ex`` without
  its error check, which would read the device from the host (and break a
  CUDA graph): a failed factor gives NaN, as ``jnp.linalg.cholesky`` does,
  and the fitter's NaN guard catches it.
- :class:`StochasticStaggeredLogDet`: the training-time gradient surrogate
  (Hutchinson Z4 probes and batched conjugate gradients on ``K = m^2 -
  H^2``, matrix-free).  Its probes come from a ``torch.Generator`` given
  by ``with_key``; without one it is the exact log-det.  CG runs a fixed
  ``cg_maxiter`` masked iterations, which a CUDA graph can hold: a system
  below ``tol |b|`` takes steps of 0 and keeps its ``x`` bit for bit, so
  the result is the JAX ``while_loop``'s, which stops once every system is
  below its tolerance.
- :class:`SchwingerAngleAction`: the Wilson action on link angles minus the
  log-det, and :func:`build_schwinger_action` on complex links.

The index and phase tables are numpy at build time, made device tensors
once per lattice, device and dtype (``_dense_tables`` and its siblings).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["StaggeredFermionLogDet", "StochasticStaggeredLogDet",
           "staggered_dirac_matrix", "staggered_eo_hopping",
           "apply_staggered_hop", "apply_staggered_K",
           "build_schwinger_action", "SchwingerAngleAction"]


def _site_tables(lat_shape, antiperiodic_time=True):
    """Per direction mu: forward/backward neighbour linear indices, eta
    phases, boundary signs (antiperiodic wrap in time); and the
    coordinates ``(ndim, V)``."""
    lat_shape = tuple(lat_shape)
    ndim = len(lat_shape)
    coords = np.stack(np.meshgrid(
        *[np.arange(n) for n in lat_shape], indexing="ij"), axis=0)
    coords = coords.reshape(ndim, -1)

    def lin(c):
        idx = np.zeros(c.shape[1], dtype=np.int64)
        for mu in range(ndim):
            idx = idx * lat_shape[mu] + c[mu]
        return idx

    nbr_plus, nbr_minus, eta, sgn_plus, sgn_minus = [], [], [], [], []
    for mu in range(ndim):
        cp = coords.copy()
        cp[mu] = (cp[mu] + 1) % lat_shape[mu]
        cm = coords.copy()
        cm[mu] = (cm[mu] - 1) % lat_shape[mu]
        nbr_plus.append(lin(cp))
        nbr_minus.append(lin(cm))
        eta.append((-1.0) ** coords[:mu].sum(axis=0))
        if antiperiodic_time and mu == 0:
            sgn_plus.append(np.where(coords[0] == lat_shape[0] - 1, -1.0, 1.0))
            sgn_minus.append(np.where(coords[0] == 0, -1.0, 1.0))
        else:
            sgn_plus.append(np.ones(coords.shape[1]))
            sgn_minus.append(np.ones(coords.shape[1]))
    return nbr_plus, nbr_minus, eta, sgn_plus, sgn_minus, coords


def _eo_tables(lat_shape, antiperiodic_time=True):
    """Even/odd-block index tables for the Schur-complement construction."""
    V = int(np.prod(lat_shape))
    nbr_plus, nbr_minus, eta, sgn_plus, sgn_minus, coords = _site_tables(
        lat_shape, antiperiodic_time)
    parity = coords.sum(axis=0) % 2
    even = np.nonzero(parity == 0)[0]
    odd = np.nonzero(parity == 1)[0]
    pos = np.full(V, -1, dtype=np.int64)  # linear index -> position in block
    pos[even] = np.arange(even.size)
    pos[odd] = np.arange(odd.size)
    return even, odd, pos, nbr_plus, nbr_minus, eta, sgn_plus, sgn_minus


def _hop_phase_tables(lat_shape, antiperiodic_time=True):
    """Lattice-shaped phase tables of the roll-based hopping stencil: per
    mu, ``w_plus = eta_mu * sgn_plus_mu`` and ``w_minus = eta_mu *
    sgn_minus_mu``."""
    lat_shape = tuple(lat_shape)
    coords = np.stack(np.meshgrid(
        *[np.arange(n) for n in lat_shape], indexing="ij"), axis=0)
    w_plus, w_minus = [], []
    for mu in range(len(lat_shape)):
        eta = (-1.0) ** coords[:mu].sum(axis=0) * np.ones(lat_shape)
        sp = np.ones(lat_shape)
        sm = np.ones(lat_shape)
        if antiperiodic_time and mu == 0:
            sp = np.where(coords[0] == lat_shape[0] - 1, -1.0, 1.0)
            sm = np.where(coords[0] == 0, -1.0, 1.0)
        w_plus.append(eta * sp)
        w_minus.append(eta * sm)
    return w_plus, w_minus


# The tables as device tensors, made once per lattice, boundary condition,
# device and real dtype: a captured graph may not copy from the host.
@functools.lru_cache(maxsize=64)
def _dense_tables(lat_shape, antiperiodic_time, device, real_dtype):
    """Per mu: the flat ``(row, col)`` indices of the forward and backward
    hops into a ``V x V`` matrix, the neighbour behind each site, and the
    hops' weights ``eta sgn / 2``."""
    nbr_plus, nbr_minus, eta, sgn_plus, sgn_minus, _ = _site_tables(
        lat_shape, antiperiodic_time)
    V = int(np.prod(lat_shape))
    rows = np.arange(V)
    real = dict(dtype=real_dtype, device=device)
    return tuple(
        (torch.as_tensor(rows * V + nbr_plus[mu], device=device),
         torch.as_tensor(rows * V + nbr_minus[mu], device=device),
         torch.as_tensor(nbr_minus[mu], device=device),
         torch.as_tensor(0.5 * eta[mu] * sgn_plus[mu], **real),
         torch.as_tensor(0.5 * eta[mu] * sgn_minus[mu], **real))
        for mu in range(len(lat_shape)))


@functools.lru_cache(maxsize=64)
def _eo_device_tables(lat_shape, antiperiodic_time, device, real_dtype):
    """The even sites, and per mu the tables of :func:`_dense_tables` into
    the ``V/2 x V/2`` even -> odd block, for the even sites."""
    even, _, pos, nbr_plus, nbr_minus, eta, sgn_plus, sgn_minus = \
        _eo_tables(lat_shape, antiperiodic_time)
    half = int(np.prod(lat_shape)) // 2
    rows = pos[even]
    real = dict(dtype=real_dtype, device=device)
    return torch.as_tensor(even, device=device), tuple(
        (torch.as_tensor(rows * half + pos[nbr_plus[mu][even]],
                         device=device),
         torch.as_tensor(rows * half + pos[nbr_minus[mu][even]],
                         device=device),
         torch.as_tensor(nbr_minus[mu][even], device=device),
         torch.as_tensor((0.5 * eta[mu] * sgn_plus[mu])[even], **real),
         torch.as_tensor((0.5 * eta[mu] * sgn_minus[mu])[even], **real))
        for mu in range(len(lat_shape)))


@functools.lru_cache(maxsize=64)
def _hop_device_tables(lat_shape, antiperiodic_time, device, real_dtype):
    """Per mu, ``(eta sgn_plus / 2, eta sgn_minus / 2)`` on the lattice."""
    w_plus, w_minus = _hop_phase_tables(lat_shape, antiperiodic_time)
    real = dict(dtype=real_dtype, device=device)
    return tuple((torch.as_tensor(0.5 * wp, **real),
                  torch.as_tensor(0.5 * wm, **real))
                 for wp, wm in zip(w_plus, w_minus))


@functools.lru_cache(maxsize=16)
def _z4_table(device, complex_dtype):
    """The Z4 probe values ``[1, i, -1, -i]``."""
    return torch.tensor([1 + 0j, 1j, -1 + 0j, -1j], dtype=complex_dtype,
                        device=device)


def _as_links(links):
    """Complex links; real input is read as link angles."""
    return links if links.is_complex() else torch.exp(1j * links)


def _tables_for(make, links, antiperiodic_time):
    """``make``'s tables for the lattice, device and dtype of ``links``."""
    return make(tuple(int(n) for n in links.shape[2:]),
                bool(antiperiodic_time), links.device, links.real.dtype)


def staggered_dirac_matrix(links, mass, *, antiperiodic_time=True):
    """Dense staggered Dirac matrices ``(batch, V, V)`` from U(1) links
    ``(batch, ndim, *lat_shape)`` (complex; real input is link angles)."""
    links = _as_links(links)
    batch, ndim = links.shape[:2]
    lat_shape = links.shape[2:]
    V = int(np.prod(lat_shape))
    u = links.reshape(batch, ndim, V)
    diag = torch.arange(V, device=u.device) * (V + 1)
    D = torch.zeros((batch, V * V), dtype=u.dtype, device=u.device)
    D = D.index_add(1, diag, torch.full((batch, V), mass, dtype=u.dtype,
                                        device=u.device))
    tables = _tables_for(_dense_tables, links, antiperiodic_time)
    for mu, (fwd, bwd, behind, w_plus, w_minus) in enumerate(tables):
        # forward hop: + eta(x)/2 U_mu(x) at (x, x+mu); backward hop:
        # - eta(x)/2 conj(U_mu(x-mu)) at (x, x-mu)
        D = D.index_add(1, fwd, w_plus * u[:, mu])
        D = D.index_add(1, bwd, -w_minus * torch.conj(u[:, mu][:, behind]))
    return D.reshape(batch, V, V)


def staggered_eo_hopping(links, *, antiperiodic_time=True):
    """The even -> odd hopping block ``A_eo`` ``(batch, V/2, V/2)``: rows
    even sites, columns odd sites; the staggered operator in the even/odd
    basis is ``[[m I, A_eo], [-A_eo^H, m I]]``."""
    links = _as_links(links)
    batch, ndim = links.shape[:2]
    lat_shape = links.shape[2:]
    if any(n % 2 for n in lat_shape):
        # an odd extent makes the periodic wrap connect SAME-parity sites,
        # which breaks the even/odd Schur identity
        raise ValueError("even-odd log-det needs every lattice extent even; "
                         f"got {tuple(lat_shape)} (use method='dense')")
    V = int(np.prod(lat_shape))
    half = V // 2
    u = links.reshape(batch, ndim, V)
    even, tables = _tables_for(_eo_device_tables, links, antiperiodic_time)
    A = torch.zeros((batch, half * half), dtype=u.dtype, device=u.device)
    for mu, (fwd, bwd, behind, w_plus, w_minus) in enumerate(tables):
        A = A.index_add(1, fwd, w_plus * u[:, mu][:, even])
        A = A.index_add(1, bwd, -w_minus * torch.conj(u[:, mu][:, behind]))
    return A.reshape(batch, half, half)


def _check_lat(lat_shape, cfgs):
    if lat_shape and tuple(cfgs.shape[2:]) != tuple(lat_shape):
        raise ValueError(
            f"configs have lattice {tuple(cfgs.shape[2:])} but this "
            f"log-det was built for {tuple(lat_shape)}")


class StaggeredFermionLogDet:
    """Per-sample ``log det D`` of the staggered operator (batched, exact).

    ``n_copies`` multiplies the log-det (the number of staggered fields).
    ``method='schur'``: ``det D = det(m^2 I + A_eo^H A_eo)`` over the half
    lattice, a Hermitian positive-definite matrix, by batched Cholesky;
    ``'dense'``: the full matrix's ``slogdet``."""

    def __init__(self, *, lat_shape, mass=0.1, n_copies=1,
                 antiperiodic_time=True, method="schur"):
        self.lat_shape = tuple(lat_shape)
        self.mass, self.n_copies = mass, n_copies
        self.antiperiodic_time, self.method = antiperiodic_time, method

    def __call__(self, cfgs):
        _check_lat(self.lat_shape, cfgs)
        if self.method == "schur":
            A = staggered_eo_hopping(
                cfgs, antiperiodic_time=self.antiperiodic_time)
            eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
            gram = (self.mass**2) * eye + A.mH @ A
            L, info = torch.linalg.cholesky_ex(gram, check_errors=False)
            diag = torch.diagonal(L, dim1=-2, dim2=-1).real
            logabs = 2.0 * torch.sum(torch.log(diag), dim=-1)
            logabs = torch.where(info == 0, logabs, torch.nan)
        else:
            D = staggered_dirac_matrix(
                cfgs, self.mass, antiperiodic_time=self.antiperiodic_time)
            logabs = torch.linalg.slogdet(D)[1]
        return self.n_copies * logabs


# ===================================================================== #
# Stencil (matrix-free) staggered operator + stochastic log-det
# ===================================================================== #
def _hop_operands(links, antiperiodic_time):
    """Per mu, the link factors of the hopping stencil: ``(eta sgn_plus /
    2) U_mu`` and ``(eta sgn_minus / 2, conj(U_mu))``, computed once for
    every stencil application on these links."""
    links = _as_links(links)
    tables = _tables_for(_hop_device_tables, links, antiperiodic_time)
    return tuple((hp * links[:, mu], hm, torch.conj(links[:, mu]))
                 for mu, (hp, hm) in enumerate(tables))


def _hop(operands, v):
    """``H v`` from :func:`_hop_operands`; the lattice is the trailing
    axes of ``v``, and its leading axes broadcast against the batch."""
    ndim = len(operands)
    out = torch.zeros_like(v)
    for mu, (fwd, hm, uc) in enumerate(operands):
        ax = v.dim() - ndim + mu
        out = out + fwd * torch.roll(v, -1, ax)
        out = out - hm * torch.roll(uc * v, 1, ax)
    return out


def apply_staggered_hop(links, v, *, antiperiodic_time=True):
    r"""Matrix-free hopping ``H v`` on full-lattice vectors (O(V) stencil),

    .. math::
        (Hv)(x) = \tfrac12\sum_\mu \eta_\mu(x)\big[ s^+_\mu(x) U_\mu(x)
            v(x+\hat\mu) - s^-_\mu(x) U^*_\mu(x-\hat\mu) v(x-\hat\mu)\big],

    the hopping part of :func:`staggered_dirac_matrix`.  ``links``:
    ``(batch, ndim, *lat)``; ``v``: complex ``(..., batch, *lat)``, extra
    leading (probe) axes broadcast against the batch."""
    return _hop(_hop_operands(links, antiperiodic_time), v)


def _apply_K(operands, mass, v):
    return (mass * mass) * v - _hop(operands, _hop(operands, v))


def apply_staggered_K(links, mass, v, *, antiperiodic_time=True):
    r"""Matrix-free ``K v`` with ``K = m^2 + H^\dagger H = m^2 - H^2``,
    Hermitian positive definite, with ``log det D = (1/2) log det K``."""
    return _apply_K(_hop_operands(links, antiperiodic_time), mass, v)


def _cg_batched(matvec, b, *, tol, maxiter, lat_ndim):
    """Conjugate gradients on a batch of independent Hermitian-PD systems.

    ``b``: complex ``(..., *lat)``; inner products reduce over the trailing
    ``lat_ndim`` axes, so each leading index has its own step sizes.
    Runs exactly ``maxiter`` iterations, masked: a system whose residual
    norm is below ``tol |b|`` takes zero steps, so its ``x`` is what the
    JAX ``while_loop`` returns when it stops there."""
    axes = tuple(range(b.dim() - lat_ndim, b.dim()))

    def dot(x, y):
        return torch.sum(torch.conj(x) * y, dim=axes).real

    def expand(s):
        return s.reshape(s.shape + (1,) * lat_ndim)

    b2 = dot(b, b)
    tol2 = (tol * tol) * b2
    x, r, p, rs = torch.zeros_like(b), b, b, b2
    one = torch.ones((), dtype=b2.dtype, device=b2.device)
    for _ in range(maxiter):
        kp = matvec(p)
        pkp = dot(p, kp)
        live = rs > tol2
        alpha = torch.where(live, rs / torch.where(pkp > 0, pkp, one), 0.0)
        x = x + expand(alpha) * p
        r = r - expand(alpha) * kp
        rs_new = dot(r, r)
        beta = torch.where(live, rs_new / torch.where(rs > 0, rs, one), 0.0)
        p = r + expand(beta) * p
        rs = rs_new
    return x


class StochasticStaggeredLogDet:
    r"""Stochastic, matrix-free estimator of the staggered ``log det D``
    GRADIENT:

    .. math::
        \partial_\theta \log\det D
            \approx \tfrac12\,\tfrac1P \sum_p
              \mathrm{Re}\,[\,(K^{-1}z_p)^\dagger\, (\partial_\theta K)\, z_p]

    with Z4 probes ``z_p`` and ``K^{-1} z`` from batched CG on detached
    links.  The value returned is the surrogate ``0.5 Re[sg(K^{-1}
    z)^\dagger K z]`` averaged over the probes, ~``V/2``, NOT the log-det:
    it is for training.  Without a generator (``with_key(None)`` or never
    keyed) it is the exact log-det, which the fitter's evaluation and the
    samplers use; the fitter's training step keys it with the model's
    generator, which draws fresh probes at every step (and every replay)."""

    def __init__(self, *, lat_shape, mass=0.1, n_copies=1,
                 antiperiodic_time=True, n_probes=2, cg_tol=1e-5,
                 cg_maxiter=256, key=None):
        self.lat_shape = tuple(lat_shape)
        self.mass, self.n_copies = mass, n_copies
        self.antiperiodic_time = antiperiodic_time
        self.n_probes, self.cg_tol, self.cg_maxiter = n_probes, cg_tol, \
            cg_maxiter
        self.key = key  # a torch.Generator, or None for the exact log-det
        self._exact = StaggeredFermionLogDet(
            lat_shape=lat_shape, mass=mass, n_copies=n_copies,
            antiperiodic_time=antiperiodic_time)

    def with_key(self, key):
        """A copy drawing its probes from the generator ``key``."""
        return StochasticStaggeredLogDet(
            lat_shape=self.lat_shape, mass=self.mass,
            n_copies=self.n_copies, antiperiodic_time=self.antiperiodic_time,
            n_probes=self.n_probes, cg_tol=self.cg_tol,
            cg_maxiter=self.cg_maxiter, key=key)

    def exact(self):
        return self._exact

    def _probes(self, links):
        """Z4 probes ``(n_probes, batch, *lat)``: uniform in {1, i, -1,
        -i}, drawn from the generator."""
        shape = (self.n_probes, links.shape[0], *links.shape[2:])
        quarter = torch.randint(0, 4, shape, generator=self.key,
                                device=links.device)
        return _z4_table(links.device, links.dtype)[quarter]

    def __call__(self, cfgs):
        if self.key is None:
            return self._exact(cfgs)
        links = _as_links(cfgs)
        return self.surrogate(links, self._probes(links))

    def surrogate(self, links, z):
        """The surrogate on the probes ``z`` ``(n_probes, batch, *lat)``."""
        links = _as_links(links)
        ndim = links.dim() - 2
        frozen = _hop_operands(links.detach(), self.antiperiodic_time)
        with torch.no_grad():
            sol = _cg_batched(lambda v: _apply_K(frozen, self.mass, v), z,
                              tol=self.cg_tol, maxiter=self.cg_maxiter,
                              lat_ndim=ndim)
        kz_live = apply_staggered_K(links, self.mass, z,
                                    antiperiodic_time=self.antiperiodic_time)
        axes = tuple(range(2, 2 + ndim))
        est = 0.5 * torch.mean(
            torch.sum(torch.conj(sol) * kz_live, dim=axes).real, dim=0)
        return self.n_copies * est


class SchwingerAngleAction:
    r"""Schwinger-model action on LINK ANGLES,
    ``S(theta) = -beta sum_x cos P(x) - N_c log det D[e^{i theta}]``, for
    the angle-variable gauge flows of ``models.gauge``; ``theta`` real
    ``(batch, ndim, *lat_shape)``.  ``logdet_func`` plugs in another
    log-det (e.g. :class:`StochasticStaggeredLogDet`); by default the exact
    one with ``method``."""

    def __init__(self, *, beta=1.0, lat_shape=(), mass=0.1, n_copies=1,
                 antiperiodic_time=True, method="schur", logdet_func=None):
        from .gauge import U1AngleAction

        self.beta, self.lat_shape, self.mass = beta, tuple(lat_shape), mass
        self.n_copies, self.antiperiodic_time = n_copies, antiperiodic_time
        self.method, self.logdet_func = method, logdet_func
        self._gauge = U1AngleAction(beta=beta)
        self._exact = StaggeredFermionLogDet(
            lat_shape=lat_shape, mass=mass, n_copies=n_copies, method=method,
            antiperiodic_time=antiperiodic_time)

    def with_key(self, key):
        """The action with the generator ``key`` threaded into a
        stochastic ``logdet_func`` (the fitter's training step); itself for
        the exact log-det."""
        if self.logdet_func is not None and hasattr(self.logdet_func,
                                                    "with_key"):
            return SchwingerAngleAction(
                beta=self.beta, lat_shape=self.lat_shape, mass=self.mass,
                n_copies=self.n_copies,
                antiperiodic_time=self.antiperiodic_time, method=self.method,
                logdet_func=self.logdet_func.with_key(key))
        return self

    def __call__(self, theta):
        return self.action(theta)

    def action(self, theta):
        ld = self._exact if self.logdet_func is None else self.logdet_func
        return self._gauge.action(theta) - ld(theta)

    def calc_topo_charge(self, theta):
        return self._gauge.calc_topo_charge(theta)

    def log_prob(self, x, action_logz=0.0):
        return -self.action(x) - action_logz


def build_schwinger_action(*, beta, lat_shape, mass=0.1, n_copies=1,
                           antiperiodic_time=True, method="schur"):
    """The Schwinger action on complex links: the Wilson U(1) gauge part and
    the exact staggered-fermion log-det."""
    from .actions import SchwingerAction

    return SchwingerAction.build(
        beta=beta, ndim=len(lat_shape),
        logdet_func=StaggeredFermionLogDet(
            lat_shape=tuple(lat_shape), mass=mass, n_copies=n_copies,
            method=method, antiperiodic_time=antiperiodic_time))
