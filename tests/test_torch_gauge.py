"""Port parity of the U(1) gauge sector, on the CPU, in float64.

The cases of ``tests/test_gauge.py`` run on the port (the angle action
against ``U1GaugeAction`` on complex links, the round trip, frozen
plaquettes, gauge equivariance, plaquette invariance, logJ against the
autograd Jacobian, the density path); then the port against the JAX
package on the same numpy inputs, with perturbed JAX weights transplanted
by ``load_jax_leaves``, to 1e-10: ``u1_plaq_angle``, ``U1AngleAction``,
one ``U1PlaquetteCoupling`` for each direction and offset and
``build_u1_gauge_flow`` (forward and inverse, logJ summed and as a density,
parameter gradients), the gauge actions of ``models/actions.py``, and one
guarded path-gradient training step of the 8x8 U(1) model against
``jax.value_and_grad`` and optax on the same prior draw.  The slow JAX
training test (``test_u1_training_and_exactness``) has its counterpart on
the card, in ``chip_smoke.py``'s U(1) phase.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflow__tpu as nf
from normflow__tpu.models import actions as ja
from normflow__tpu.models import gauge as jg
from normflow__tpu.models import nets as jn
from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_u1_model as jax_build_u1_model
from normflow__tpu_torch.examples import u1_gauge
from normflow__tpu_torch.models import actions as ta
from normflow__tpu_torch.models import gauge as tg
from normflow__tpu_torch.models.nets import ConvNet
from normflow__tpu_torch.utils.transplant import jax_leaf_order, load_jax_leaves
from normflow__tpu_torch.zoo import build_u1_model
from test_torch_flow_zoo import check_flow
from test_torch_modules import perturbed_leaves

TOL = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")
LAT = (8, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _theta(rng, batch=4, lat=LAT):
    return rng.uniform(-np.pi, np.pi, (batch, 2, *lat))


def _flow(seed=0, **kw):
    return tg.build_u1_gauge_flow(torch.Generator().manual_seed(seed), LAT,
                                  knots_len=6, hidden=(8,), dtype=torch.float64,
                                  **kw)


def _net(seed=0):
    return ConvNet(2, 3 * 5, 3, generator=torch.Generator().manual_seed(seed),
                   **F64)


def _gauge_transform(th, alpha):
    """mu = 0 links shift lattice axis 0, mu = 1 links axis 1."""
    t0 = th[:, 0] + alpha - torch.roll(alpha, -1, -2)
    t1 = th[:, 1] + alpha - torch.roll(alpha, -1, -1)
    return tg.wrap_angle(torch.stack([t0, t1], dim=1))


# ------------------------------------------- tests/test_gauge.py, on the port
def test_u1_angle_action_matches_complex_action(rng):
    theta = _t(_theta(rng))
    a1 = tg.U1AngleAction(beta=1.3)(theta)
    a2 = ta.U1GaugeAction(beta=1.3, ndim=2)(torch.exp(1j * theta))
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), atol=1e-10)


def test_gauge_flow_roundtrip(rng):
    flow = _flow()
    theta = _t(_theta(rng))
    with torch.no_grad():
        y, logj = flow.forward(theta)
        x, logj0 = flow.backward(y, log0=logj)
    np.testing.assert_allclose(tg.wrap_angle(x - theta).numpy(), 0.0,
                               atol=1e-8)
    np.testing.assert_allclose(logj0.numpy(), 0.0, atol=1e-8)


def test_single_coupling_frozen_plaquettes_unchanged(rng):
    c = tg.U1PlaquetteCoupling(_net(), mu=1, offset=0)
    theta = _t(_theta(rng))
    with torch.no_grad():
        y, _ = c.forward(theta)
    p_old = tg.u1_plaq_angle(theta).numpy()
    p_new = tg.u1_plaq_angle(y).numpy()
    for col in range(8):  # frozen stripes x0 % 4 in {1, 2}
        if col % 4 in (1, 2):
            np.testing.assert_allclose(p_new[:, col], p_old[:, col],
                                       atol=1e-12)
    assert not np.allclose(p_new[:, 0], p_old[:, 0])


def test_gauge_equivariance(rng):
    """flow(g . theta) == g . flow(theta) with identical logJ."""
    flow = _flow()
    theta = _t(_theta(rng))
    alpha = _t(rng.uniform(-np.pi, np.pi, (1, *LAT)))
    with torch.no_grad():
        y1, logj1 = flow.forward(_gauge_transform(theta, alpha))
        y2, logj2 = flow.forward(theta)
    np.testing.assert_allclose(
        tg.wrap_angle(y1 - _gauge_transform(y2, alpha)).numpy(), 0.0,
        atol=1e-8)
    np.testing.assert_allclose(logj1.numpy(), logj2.numpy(), atol=1e-8)


def test_plaquettes_are_gauge_invariant(rng):
    theta = _t(_theta(rng))
    alpha = _t(rng.uniform(-np.pi, np.pi, (1, *LAT)))
    theta_g = _gauge_transform(theta, alpha)
    np.testing.assert_allclose(
        tg.wrap_angle(tg.u1_plaq_angle(theta_g)
                      - tg.u1_plaq_angle(theta)).numpy(), 0.0, atol=1e-8)


def test_gauge_logj_vs_jacobian(rng):
    """Per-sample logJ against the slogdet of the link-space Jacobian."""
    flow = _flow()
    theta = _t(_theta(rng, batch=1))

    def f(flat):
        return flow.forward(flat.reshape(1, 2, *LAT))[0].reshape(-1)

    jac = torch.autograd.functional.jacobian(f, theta.reshape(-1))
    _, logdet = torch.linalg.slogdet(jac)
    with torch.no_grad():
        _, logj = flow.forward(theta)
    np.testing.assert_allclose(float(logj[0]), float(logdet), rtol=1e-6)


@pytest.mark.parametrize("mu,offset", [(1, 0), (0, 3)])
def test_single_coupling_density_path(rng, mu, offset):
    """density=True gives a per-link field that sums to the scalar logJ,
    supported on the updated direction's active stripe only."""
    c = tg.U1PlaquetteCoupling(_net(), mu=mu, offset=offset)
    theta = _t(_theta(rng))
    with torch.no_grad():
        y, logj = c.forward(theta)
        yd, dens = c.forward(theta, density=True)
    assert torch.equal(y, yd) and dens.shape == theta.shape
    np.testing.assert_allclose(dens.sum(dim=(1, 2, 3)).numpy(), logj.numpy(),
                               rtol=1e-6)
    d = dens.numpy()
    assert np.all(d[:, 1 - mu] == 0.0)
    for coord in range(8):
        if coord % 4 != offset:
            sl = d[:, mu, coord] if mu == 1 else d[:, mu, :, coord]
            np.testing.assert_allclose(sl, 0.0, atol=0.0)


def test_stripe_lattice_must_divide_by_four(rng):
    c = tg.U1PlaquetteCoupling(_net(), mu=1, offset=0)
    with pytest.raises(ValueError, match="% 4"):
        c.forward(_t(_theta(rng, lat=(6, 8))))


# ------------------------------------------------------- port vs JAX package
def test_plaq_angle_and_wrap_match_jax(rng):
    theta = _theta(rng, batch=3) * 3.0  # beyond [-pi, pi): wrap matters
    np.testing.assert_allclose(tg.u1_plaq_angle(_t(theta)).numpy(),
                               np.asarray(jg.u1_plaq_angle(theta)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tg.wrap_angle(_t(theta)).numpy(),
                               np.asarray(jg.wrap_angle(jnp.asarray(theta))),
                               rtol=0, atol=TOL)


def test_angle_action_matches_jax(rng):
    theta = _theta(rng, batch=3)
    jact, tact = jg.U1AngleAction(beta=1.7), tg.U1AngleAction(beta=1.7)
    for name in ("action", "action_density", "calc_topo_charge",
                 "log_prob"):
        np.testing.assert_allclose(
            getattr(tact, name)(_t(theta)).numpy(),
            np.asarray(getattr(jact, name)(jnp.asarray(theta))),
            rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("mu", [0, 1])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_plaquette_coupling_matches_jax(rng, mu, offset):
    """Forward and inverse, logJ summed and as a density, and the
    conditioner's gradients."""
    jnet = jn.ConvNet.build(jax.random.key(mu * 4 + offset), 2, 3 * 5,
                            kernel_size=3, conv_dim=2, hidden_sizes=(4,),
                            acts=("tanh", None))
    jflow = jg.U1PlaquetteCoupling(net=jnet, mu=mu, offset=offset)
    tflow = tg.U1PlaquetteCoupling(
        ConvNet(2, 15, 3, hidden_sizes=(4,), acts=("tanh", None), **F64),
        mu=mu, offset=offset)
    leaves = perturbed_leaves(jflow, rng, scale=1.0)
    load_jax_leaves(tflow, leaves)
    check_flow(restore_into(jflow, leaves), tflow, _theta(rng, batch=3), rng)


def test_gauge_flow_matches_jax(rng):
    jflow = jg.build_u1_gauge_flow(jax.random.key(1), LAT, knots_len=6,
                                   hidden=(4,), n_cycles=1)
    tflow = tg.build_u1_gauge_flow(torch.Generator().manual_seed(1), LAT,
                                   knots_len=6, hidden=(4,), n_cycles=1,
                                   dtype=torch.float64)
    assert sum(p.numel() for p in tflow.parameters()) == sum(
        a.size for a in leaves_of(jflow).values())
    leaves = perturbed_leaves(jflow, rng)
    load_jax_leaves(tflow, leaves)
    check_flow(restore_into(jflow, leaves), tflow, _theta(rng, batch=2), rng)


def _links(rng, batch=3, lat=(4, 6), nc=None):
    """Complex links: U(1) phases, or unitary ``nc x nc`` matrices."""
    if nc is None:
        return np.exp(1j * rng.uniform(-np.pi, np.pi, (batch, len(lat), *lat)))
    a = (rng.standard_normal((batch, len(lat), *lat, nc, nc))
         + 1j * rng.standard_normal((batch, len(lat), *lat, nc, nc)))
    return np.linalg.qr(a)[0]


@pytest.mark.parametrize("ndim,nc", [(2, 2), (3, 3)])
def test_gauge_action_matches_jax(rng, ndim, nc):
    cfgs = _links(rng, lat=(4, 3, 5)[:ndim], nc=nc)
    jact = ja.GaugeAction(beta=0.7, ndim=ndim, nc=nc)
    tact = ta.GaugeAction(beta=0.7, ndim=ndim, nc=nc)
    for name in ("action", "action_density", "log_prob"):
        np.testing.assert_allclose(
            getattr(tact, name)(_t(cfgs)).numpy(),
            np.asarray(getattr(jact, name)(jnp.asarray(cfgs))),
            rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(
        tact.calc_plaq(_t(cfgs), mu=1, nu=0, real=False).numpy(),
        np.asarray(jact.calc_plaq(jnp.asarray(cfgs), mu=1, nu=0,
                                  real=False)), rtol=0, atol=TOL)
    assert tact.parameters == jact.parameters
    m = _t(cfgs[:, 0])
    for fn in ("calc_trace", "calc_reduced_trace"):
        np.testing.assert_allclose(getattr(ta, fn)(m).numpy(),
                                   np.asarray(getattr(ja, fn)(cfgs[:, 0])),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("ndim", [2, 3])
def test_u1_gauge_action_matches_jax(rng, ndim):
    cfgs = _links(rng, lat=(4, 6, 2)[:ndim])
    jact = ja.U1GaugeAction(beta=1.1, ndim=ndim)
    tact = ta.U1GaugeAction(beta=1.1, ndim=ndim)
    for name in ("action", "action_density", "calc_topo_charge", "log_prob"):
        np.testing.assert_allclose(
            getattr(tact, name)(_t(cfgs)).numpy(),
            np.asarray(getattr(jact, name)(jnp.asarray(cfgs))),
            rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("staples", [False, True])
def test_matrix_action_matches_jax(rng, staples):
    cfgs = _links(rng, nc=3)[:, 0]  # (batch, 4, 6, 3, 3)
    gamma = (rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
             if staples else None)
    jact = ja.MatrixAction(beta=0.9, staples_matrix=None if gamma is None
                           else jnp.asarray(gamma))
    tact = ta.MatrixAction(beta=0.9, staples_matrix=None if gamma is None
                           else _t(gamma))
    for name in ("action", "action_density", "log_prob"):
        np.testing.assert_allclose(
            getattr(tact, name)(_t(cfgs)).numpy(),
            np.asarray(getattr(jact, name)(jnp.asarray(cfgs))),
            rtol=0, atol=TOL, err_msg=name)
    assert tact.parameters == jact.parameters


def test_schwinger_action_without_fermions_matches_jax(rng):
    """``SchwingerAction`` with no log-det is the gauge action (its
    fermion part is held in ``tests/test_torch_fermions.py``)."""
    cfgs = _links(rng, lat=(4, 4))
    jact = ja.SchwingerAction.build(beta=2.0)
    tact = ta.SchwingerAction.build(beta=2.0)
    np.testing.assert_allclose(tact(_t(cfgs)).numpy(),
                               np.asarray(jact(jnp.asarray(cfgs))),
                               rtol=0, atol=TOL)


# ----------------------------------------------------------- the slice whole
def u1_twins(rng, lat=LAT):
    """The JAX and the port's ``build_u1_model`` at ``lat`` with one cycle
    and narrow conditioners, perturbed JAX weights in both."""
    kw = dict(knots_len=6, hidden=(4,), n_cycles=1, beta=2.0, seed=3)
    jmodel = jax_build_u1_model(lat, **kw)
    model = build_u1_model(lat, **kw, dtype=torch.float64, device="cpu")
    leaves = perturbed_leaves(jmodel.net_, rng)
    load_jax_leaves(model.net_, leaves)
    jmodel.net_ = restore_into(jmodel.net_, leaves)
    return jmodel, model


def _jit0(fn):
    """``jax.jit`` at XLA's lowest backend optimisation level (each runs
    once)."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_backend_optimization_level": 0})(*args)
    return run


def test_u1_model_logqp_matches_jax(rng):
    jmodel, model = u1_twins(rng)
    x = _theta(rng, batch=5)

    def jax_logqp(net, x):
        y, logj = net.forward(x)
        return jmodel.prior.log_prob(x) - logj, -jmodel.action(y)

    want = _jit0(jax_logqp)(jmodel.net_, jnp.asarray(x))
    with torch.no_grad():
        y, logj = model.net_.forward(_t(x))
        got = (model.prior.log_prob(_t(x)) - logj, -model.action(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    assert model.net_.npar == 8 * (2 * 4 * 9 + 4 + 4 * 15 * 9 + 15)


def guarded_step_vs_jax(jmodel, model, xs, *, path, clip=None, lr=1e-3):
    """Steps of the port's guarded ``Fitter._step`` on the draws ``xs``
    against ``jax.value_and_grad`` of the JAX fitter's loss
    (``normflow__tpu/training/fitter.py:250-268``) and optax's AdamW:
    losses to 1e-10, then every leaf to 1e-9 (float64)."""
    fit = model.fit
    fit(n_epochs=0, batch_size=len(xs[0]),
        hyperparam=dict(lr=lr, weight_decay=0.0),
        grad_estimator="path" if path else "rep", clip_grad_norm=clip,
        checkpoint_dict=dict(print_stride=None))
    jtx = optax.adamw(lr, weight_decay=0.0)
    if clip is not None:
        jtx = optax.chain(optax.clip_by_global_norm(clip), jtx)

    def loss_of(net, x):
        y, logj = net.forward(x)
        if path:
            x_inv, mlogj = jax.tree_util.tree_map(jax.lax.stop_gradient,
                                                  net).backward(y)
            logq = jmodel.prior.log_prob(x_inv) + mlogj
        else:
            logq = jmodel.prior.log_prob(x) - logj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    jnet, jstate = jmodel.net_, jtx.init(jmodel.net_)
    value_and_grad = _jit0(jax.value_and_grad(loss_of))
    for x in xs:
        want_loss, grads = value_and_grad(jnet, jnp.asarray(x))
        upd, jstate = jtx.update(grads, jstate, jnet)
        jnet = optax.apply_updates(jnet, upd)
        tx = _t(x)
        loss, _ = fit._step(tx, model.prior.log_prob(tx))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                                   atol=1e-10)
    want = leaves_of(jnet)
    got = {str(i): p.detach().numpy() for i, (_, _, p) in
           enumerate(jax_leaf_order(model.net_))}
    for k in want:
        w = np.asarray(want[k])
        if got[k].ndim == 4:  # OIHW -> HWIO
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-9,
                                   err_msg=f"leaf {k}")


def test_u1_guarded_step_matches_jax_and_optax(rng):
    """Two path-gradient steps (clip 25, AdamW lr 1e-3) of the 8x8 U(1)
    model, as the card's smoke trains BASELINE config 5."""
    jmodel, model = u1_twins(rng)
    guarded_step_vs_jax(jmodel, model, [_theta(rng, batch=4)
                                        for _ in range(2)],
                        path=True, clip=25.0)


def test_u1_example_runs_on_the_cpu(capsys):
    model = u1_gauge.main(lat_shape=(4, 4), n_epochs=2, batch_size=8,
                          n_cycles=1, knots_len=4, device="cpu")
    out = capsys.readouterr().out
    assert "number of model parameters = " in out and "<cos P> = " in out
    assert model.device.type == "cpu"


def test_observables_binned_error():
    """<cos P> of configurations with known plaquettes, and the binned
    error: the standard error of the bin means."""
    rng = np.random.default_rng(0)
    theta = rng.uniform(-np.pi, np.pi, (40, 2, 4, 4))
    obs = u1_gauge.observables(theta, n_bins=4)
    p = np.asarray(jg.u1_plaq_angle(theta))
    per = np.cos(p).mean(axis=(1, 2))
    bins = per.reshape(4, 10).mean(axis=1)
    np.testing.assert_allclose(obs["cos_p"], (per.mean(), bins.std(ddof=1)
                                              / 2.0), rtol=1e-12)
    np.testing.assert_allclose(obs["q"], p.sum(axis=(1, 2)) / (2 * math.pi),
                               rtol=1e-12, atol=1e-12)
