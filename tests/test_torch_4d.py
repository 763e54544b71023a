"""Port parity of phi^4 on 4-D lattices, on the CPU.

The JAX package runs the phi^4 action at any lattice rank (its Pallas
kernel at 1-3 dims, XLA's rolls at 4, ``normflow__tpu/models/actions.py:
60-69``) and builds the unpacked flagship at any rank (``conv_dim =
len(lat_shape)``, 4-D convs by roll-and-sum).  The port's kernels take 4-D
fields on the card; here, on the CPU, its wrappers run their plain
versions, which are held against the JAX package in float64:

- ``phi4_action_plain`` and ``phi4_action_grad_plain`` at ``(4, 4, 4, 4,
  4)`` and ``(3, 3, 5, 4, 6)`` against ``ScalarPhi4Action.action`` (XLA's
  branch) and ``jax.grad`` of it, to 1e-12, and the port's differentiable
  ``phi4_action`` through autograd;
- the same at the shapes of the tiled nd kernels' tile: ``(4, 8, 8, 8,
  8)`` against the XLA branch and ``(4, 8, 8, 8)`` against the Pallas
  kernel ``phi4_action_pallas`` in interpret mode (which takes 3-D), in
  float64 to 1e-12 and in float32 within the smoke's bars;
- the 4-D slab plain versions summed over two and four slabs with their
  halos against the whole-lattice plain versions, to 1e-12;
- ``build_phi4_model((4, 4, 4, 4), packed=False, hidden=(4,), n_layers=2,
  knots=4)`` with the JAX leaves perturbed by seeded numpy noise and
  transplanted: ``y``, logq, the log-Jacobian and logp per sample, the
  inverse round trip, and one path-gradient and one ``rep`` step's loss
  and gradients against ``jax.value_and_grad`` of the JAX fitter's loss;
- that model under a 2-rank ``{"data": 1, "space": 2}`` gloo group
  (``tests/_torch_4d_worker.py``): logq, logp, the loss and the gradients
  of both estimators, and ``sample_chain`` and ``sample_parallel_chains``
  on fed draws, against the unsharded run.

Float64 throughout, to 1e-10 unless stated.  The JAX side is compiled at
XLA's lowest backend optimisation level (each function runs once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflow__tpu as jnf
from normflow__tpu.ops.kernels import phi4_action_pallas
from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
import normflow__tpu_torch as nt
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.ops.kernels import phi4
from normflow__tpu_torch.utils.transplant import jax_leaf_grads

import _torch_4d_worker as W4
import _torch_space_worker as W
from test_torch_cntr import _jit0

LAT = W4.LAT
ACTION = dict(kappa=0.6, m_sq=-2.4, lambd=0.5)  # the flagship's
TOL = 1e-10
AXES2 = {"data": 1, "space": 2}


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def perturbed_leaves4(jax_tree, rng, scale=0.3):
    """Leaves plus N(0, scale^2) noise; conv leaves (``(k, k, k, k, in,
    out)`` at 4-D) get noise scaled by their init bound 1/sqrt(fan_in)."""
    leaves = leaves_of(jax_tree)
    for k, a in leaves.items():
        s = scale / np.sqrt(np.prod(a.shape[:-1])) if a.ndim >= 4 else scale
        leaves[k] = a + rng.standard_normal(a.shape) * s
    return leaves


@pytest.mark.parametrize("shape", [(4, 4, 4, 4, 4), (3, 3, 5, 4, 6)])
@pytest.mark.parametrize("hopping", [True, False])
def test_plain_action_and_force_match_jax(rng, shape, hopping):
    """The plain action and force against the JAX action's XLA branch and
    ``jax.grad`` of ``sum g S``, to 1e-12; the port's ``phi4_action``
    through autograd gives the same force."""
    cfgs = rng.standard_normal(shape)
    g = rng.standard_normal(shape[0])
    coupling = dict(ACTION, kappa=ACTION["kappa"] if hopping else 0.0)
    jact = jnf.action.ScalarPhi4Action(**coupling)
    w0, w2, w4 = ScalarPhi4Action(**coupling).get_coef(4)
    assert (w0, w2, w4) == jact.get_coef(4) and (w0 != 0.0) == hopping
    want, want_force = _jit0(lambda c, gg: (jact.action(c), jax.grad(
        lambda c: jnp.sum(gg * jact.action(c)))(c)), jnp.asarray(cfgs),
        jnp.asarray(g))
    tc, tg = torch.from_numpy(cfgs), torch.from_numpy(g)
    _close(phi4.phi4_action_plain(tc, w0, w2, w4), want, atol=1e-12)
    _close(phi4.phi4_action_grad_plain(tc, tg, w0, w2, w4), want_force,
           atol=1e-12)
    tc.requires_grad_(True)
    act = phi4.phi4_action(tc, w0, w2, w4)
    _close(act.detach(), want, atol=1e-12)
    (force,) = torch.autograd.grad((tg * act).sum(), tc)
    _close(force, want_force, atol=1e-12)


# the float32 bars of chip_smoke.py: the action relative to max(1, |S|),
# the force element by element (tests/test_kernels.py:36-37)
PHI4_REL_TOL, FORCE_RTOL, FORCE_ATOL = 2e-5, 2e-4, 2e-5


@pytest.mark.parametrize("shape", [(4, 8, 8, 8, 8), (4, 8, 8, 8)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("hopping", [True, False])
def test_plain_action_and_force_match_jax_on_the_nd_tile(rng, shape, dtype,
                                                         hopping):
    """The plain action and force at the tiled nd kernels' shapes (the
    8^4 flagship's lattice, and 8^3) against the JAX package on the same
    numpy draws: at 4-D the action's XLA branch, at 3-D its Pallas kernel
    in interpret mode (``phi4_action_pallas``), and ``jax.grad`` of ``sum
    g S``; float64 to 1e-12 (the action relative to max(1, |S|): at 8^4
    |S| ~ 1e4, whose float64 ulp is 1.8e-12, summed over 4096 sites in
    another order), float32 within ``PHI4_REL_TOL`` and ``FORCE_*``."""
    assert phi4.action_plan_nd(shape[1:]) is not None
    cfgs = rng.standard_normal(shape).astype(dtype)
    g = rng.standard_normal(shape[0]).astype(dtype)
    coupling = dict(ACTION, kappa=ACTION["kappa"] if hopping else 0.0)
    jact = jnf.action.ScalarPhi4Action(**coupling)
    w = ScalarPhi4Action(**coupling).get_coef(len(shape) - 1)
    if len(shape) == 5:
        action = jact.action
    else:
        def action(c):
            return phi4_action_pallas(c, *w, interpret=True)
    want, want_force = _jit0(lambda c, gg: (action(c), jax.grad(
        lambda c: jnp.sum(gg * action(c)))(c)), jnp.asarray(cfgs),
        jnp.asarray(g))
    assert want.dtype == dtype and want_force.dtype == dtype
    tc, tg = torch.from_numpy(cfgs), torch.from_numpy(g)
    got = phi4.phi4_action_plain(tc, *w).numpy()
    force = phi4.phi4_action_grad_plain(tc, tg, *w).numpy()
    want, want_force = np.asarray(want), np.asarray(want_force)
    rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    if dtype == np.float64:
        assert rel.max() <= 1e-12
        _close(force, want_force, atol=1e-12)
    else:
        assert rel.max() <= PHI4_REL_TOL
        assert (np.abs(force - want_force)
                <= FORCE_ATOL + FORCE_RTOL * np.abs(want_force)).all()


@pytest.mark.parametrize("shape", [(4, 4, 4, 4, 4), (3, 8, 5, 4, 6),
                                   (2, 4, 3, 2, 1)])
@pytest.mark.parametrize("n", [2, 4])
def test_slab_plain_versions_sum_to_the_whole(rng, shape, n):
    """The 4-D slab action's plain version summed over ``n`` slabs of the
    first lattice axis with their halos ``(B, 2, L1, L2, L3)`` is the
    whole lattice's, and the stacked slab forces are its force, to
    1e-12."""
    cfgs = torch.from_numpy(rng.standard_normal(shape))
    g = torch.from_numpy(rng.standard_normal(shape[0]))
    w = ScalarPhi4Action(**ACTION).get_coef(4)
    rows = shape[1] // n
    act, force = 0.0, []
    for s in range(n):
        slab = cfgs[:, s * rows:(s + 1) * rows]
        halo = torch.stack([cfgs[:, (s * rows - 1) % shape[1]],
                            cfgs[:, ((s + 1) * rows) % shape[1]]], 1)
        assert halo.shape == (shape[0], 2, *shape[2:])
        act = act + phi4.phi4_action_slab(slab, halo, *w)
        force.append(phi4.phi4_action_slab_grad(slab, halo, g, *w))
    _close(act, phi4.phi4_action_plain(cfgs, *w), atol=1e-12)
    _close(torch.cat(force, 1), phi4.phi4_action_grad_plain(cfgs, g, *w),
           atol=1e-12)


@pytest.fixture(scope="module")
def twins():
    """The small 4-D flagship in both packages with the same perturbed
    weights, and the leaves."""
    rng = np.random.default_rng(20261018)
    jmodel = jax_build(**W4.SMALL, dtype=jnp.float64)
    leaves = perturbed_leaves4(jmodel.net_, rng)
    jmodel.net_ = restore_into(jmodel.net_, leaves)
    return jmodel, leaves, rng


def test_model_logq_logp_and_round_trip_match_jax(twins):
    """Per sample ``y``, the log-Jacobian, logq and logp, and the inverse's
    ``log_prob`` of fresh configurations, against the JAX model, to
    1e-10; the port's round trip to 1e-10."""
    jmodel, leaves, rng = twins
    model = W4.model4(leaves)
    x = rng.standard_normal((4, *LAT))
    y2 = rng.standard_normal((3, *LAT))

    def jax_side(net, xj, yj):
        jy, jlogj = net.forward(xj)
        return (jy, jlogj, jmodel.prior.log_prob(xj) - jlogj,
                -jmodel.action(jy), jmodel.posterior.log_prob(yj))

    want = _jit0(jax_side, jmodel.net_, jnp.asarray(x), jnp.asarray(y2))
    with torch.no_grad():
        tx = torch.from_numpy(x)
        y, logj = model.net_.forward(tx)
        got = (y, logj, model.prior.log_prob(tx) - logj, -model.action(y),
               model.posterior.log_prob(torch.from_numpy(y2)))
    for name, a, b in zip(("y", "logj", "logq", "logp", "log_prob"), got,
                          want):
        _close(a.numpy(), b, atol=TOL)
        assert a.shape == np.shape(b), name
    with torch.no_grad():
        x_back, log0 = model.net_.backward(y, log0=logj)
    _close(x_back.numpy(), x)
    _close(log0.numpy(), np.zeros(4))
    x_err, logj_err = nt.backward_sanitychecker(model, n_samples=3,
                                                verbose=False)
    assert x_err <= TOL and logj_err <= TOL


@pytest.mark.parametrize("estimator", ["rep", "path"])
def test_model_step_matches_jax(twins, estimator):
    """One step's loss and gradients on the same draw, against
    ``jax.value_and_grad`` of the JAX fitter's loss
    (``normflow__tpu/training/fitter.py:250-268``), to 1e-10."""
    jmodel, leaves, rng = twins
    x = rng.standard_normal((5, *LAT))

    def loss_of(net, xj):
        y, logj = net.forward(xj)
        if estimator == "path":
            net_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, net)
            x_inv, mlogj = net_sg.backward(y)
            logq = jmodel.prior.log_prob(x_inv) + mlogj
        else:
            logq = jmodel.prior.log_prob(xj) - logj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    want_loss, want_grads = _jit0(jax.value_and_grad(loss_of), jmodel.net_,
                                  jnp.asarray(x))
    model = W4.model4(leaves)
    fit = model.fit
    fit.grad_estimator = estimator
    tx = torch.from_numpy(x)
    loss, _, _ = fit.loss_of(tx, model.prior.log_prob(tx))
    loss.backward()
    _close(float(loss.detach()), float(want_loss))
    got, want = jax_leaf_grads(model.net_), leaves_of(want_grads)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], atol=TOL)


@pytest.fixture(scope="module")
def sharded(twins):
    """The 1 x 2 job's ranks and one process's unsharded runs on the same
    draws."""
    _, leaves, _ = twins
    rng = np.random.default_rng(20261019)
    b = 6

    def rounds(n):
        return [(rng.standard_normal((b, *LAT)), np.log(rng.random(b)))
                for _ in range(n)]

    job = dict(leaves=leaves, axes=AXES2, x=rng.standard_normal((b, *LAT)),
               chain_rounds=rounds(2), par_rounds=rounds(2))
    ranks = W4.model4(leaves).device_handler.spawnprocesses(W4.run_rank, 2,
                                                           job)
    ref = {est: W.grads_of(W4.model4(leaves), job["x"], est)
           for est in ("rep", "path")}
    ref["samplers"] = W.samplers(W4.model4(leaves), job["chain_rounds"],
                                 job["par_rounds"])
    return ranks, ref


@pytest.mark.parametrize("est", ["rep", "path"])
def test_sharded_model_matches_unsharded(sharded, est):
    """On both space ranks: logq, logp, the loss and every gradient leaf
    equal the unsharded run's, to 1e-10."""
    ranks, ref = sharded
    want = ref[est]
    for r in ranks:
        got = r[est]
        for k in ("logq", "logp", "loss"):
            _close(got[k], want[k])
        assert got["grads"].keys() == want["grads"].keys()
        for k in want["grads"]:
            _close(got["grads"][k], want["grads"][k])


def test_sharded_samplers_match_unsharded(sharded):
    """``sample_chain`` (samples, logq, logp, accept rates, the final
    reference) and ``sample_parallel_chains`` on fed 4-D draws, on both
    space ranks, equal the unsharded samplers', to 1e-10."""
    ranks, ref = sharded
    want = ref["samplers"]
    for r in ranks:
        got = r["samplers"]
        for kind in ("chain", "parallel"):
            assert got[kind].keys() == want[kind].keys()
            for k in want[kind]:
                _close(got[kind][k], want[kind][k])
        for a, b in zip(got["chain_ref"], want["chain_ref"]):
            _close(a, b)
