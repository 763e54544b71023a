"""Port parity of the staggered-fermion sector, on the CPU, in float64.

Every case of ``tests/test_fermions.py`` runs on the port (its loop oracle
of the Dirac matrix is reused as it is); then the port against the JAX
package on the same numpy inputs, to 1e-10 unless a test says otherwise:
the dense and even/odd matrices, both log-det methods and their
gradients, the hop stencil and ``K``, the fixed-count CG against the JAX
``while_loop`` on the same systems, ``StochasticStaggeredLogDet``'s value
and gradient on Z4 probes drawn by JAX and injected into the port,
``SchwingerAngleAction`` and ``build_schwinger_action``; and one guarded
training step of the 8x8 exact Schwinger model against the JAX step on the
same prior draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflow__tpu as nf
from normflow__tpu.models import fermions as jf
from normflow__tpu.models.gauge import build_u1_gauge_flow as jax_u1_flow
from normflow__tpu.utils.serialization import restore_into
from normflow__tpu_torch import Model
from normflow__tpu_torch.examples import schwinger
from normflow__tpu_torch.models import fermions as tf
from normflow__tpu_torch.models.gauge import build_u1_gauge_flow
from normflow__tpu_torch.models.priors import UniformPrior
from normflow__tpu_torch.utils.transplant import load_jax_leaves
from test_fermions import _loop_dirac_oracle
from test_torch_gauge import guarded_step_vs_jax
from test_torch_modules import perturbed_leaves

TOL = 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_links(rng, lat=(4, 4), batch=2):
    return np.exp(1j * rng.uniform(-np.pi, np.pi,
                                   size=(batch, len(lat), *lat)))


def _angles(rng, lat=(4, 4), batch=2):
    return rng.uniform(-np.pi, np.pi, size=(batch, len(lat), *lat))


def _grad(fn, theta):
    t = _t(theta).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(fn(t)), t)
    return g.numpy()


# ----------------------------------------- tests/test_fermions.py, on the port
def test_dirac_matrix_matches_loop_oracle(rng):
    links = _random_links(rng)
    D = tf.staggered_dirac_matrix(_t(links), 0.3).numpy()
    np.testing.assert_allclose(D, _loop_dirac_oracle(links, 0.3), atol=1e-12)


def test_dirac_matrix_periodic_bc(rng):
    links = _random_links(rng, lat=(2, 6), batch=1)
    D = tf.staggered_dirac_matrix(_t(links), 0.5,
                                  antiperiodic_time=False).numpy()
    np.testing.assert_allclose(
        D, _loop_dirac_oracle(links, 0.5, antiperiodic_time=False),
        atol=1e-12)


def test_logdet_real_positive(rng):
    D = tf.staggered_dirac_matrix(_t(_random_links(rng, batch=3)), 0.2)
    H = D.numpy() - 0.2 * np.eye(16)
    np.testing.assert_allclose(H, -H.conj().transpose(0, 2, 1), atol=1e-12)
    sign, logabs = torch.linalg.slogdet(D)
    np.testing.assert_allclose(sign.numpy(), 1.0 + 0.0j, atol=1e-10)
    assert np.isfinite(logabs.numpy()).all()


def test_logdet_gauge_invariance(rng):
    """det D is invariant under U_mu(x) -> g(x) U_mu(x) g*(x+mu)."""
    lat = (4, 4)
    links = _random_links(rng, lat=lat, batch=1)
    g = np.exp(1j * rng.uniform(-np.pi, np.pi, size=lat))
    gauged = links.copy()
    for mu in range(2):
        gauged[:, mu] = g * links[:, mu] * np.conj(np.roll(g, -1, axis=mu))
    ld = tf.StaggeredFermionLogDet(lat_shape=lat, mass=0.25)
    np.testing.assert_allclose(float(ld(_t(links))[0]),
                               float(ld(_t(gauged))[0]), rtol=1e-10)


def test_logdet_free_field_value():
    links = torch.ones((1, 2, 4, 4), dtype=torch.complex128)
    got = float(tf.StaggeredFermionLogDet(lat_shape=(4, 4), mass=0.3)(links))
    ev = np.linalg.eigvals(tf.staggered_dirac_matrix(links, 0.3)[0].numpy())
    np.testing.assert_allclose(got, np.log(np.abs(ev)).sum(), rtol=1e-10)


SCHUR_CASES = [((4, 4), True), ((4, 4), False), ((2, 6), True),
               ((4, 4, 4), True)]


@pytest.mark.parametrize("lat,apbc", SCHUR_CASES)
def test_schur_logdet_matches_dense_and_jax(rng, lat, apbc):
    """On the port, Schur == dense; each method against the JAX one."""
    links = _random_links(rng, lat=lat)
    got = {}
    for method in ("dense", "schur"):
        kw = dict(lat_shape=lat, mass=0.35, antiperiodic_time=apbc,
                  method=method)
        got[method] = tf.StaggeredFermionLogDet(**kw)(_t(links)).numpy()
        want = np.asarray(jf.StaggeredFermionLogDet(**kw)(
            jnp.asarray(links)))
        np.testing.assert_allclose(got[method], want, rtol=0, atol=TOL,
                                   err_msg=method)
    np.testing.assert_allclose(got["schur"], got["dense"], rtol=1e-10)


def test_schur_rejects_odd_extent(rng):
    schur = tf.StaggeredFermionLogDet(lat_shape=(3, 4), mass=0.35)
    with pytest.raises(ValueError, match="extent"):
        schur(_t(_random_links(rng, lat=(3, 4), batch=1)))


def test_logdet_grads_match_dense_and_jax(rng):
    """Gradients in the link angles: schur == dense on the port, and each
    against ``jax.grad`` of the JAX log-det."""
    lat = (4, 4)
    theta = _angles(rng, lat, batch=2)
    g = {}
    for method in ("dense", "schur"):
        kw = dict(lat_shape=lat, mass=0.3, method=method)
        g[method] = _grad(tf.StaggeredFermionLogDet(**kw), theta)
        jld = jf.StaggeredFermionLogDet(**kw)
        want = np.asarray(jax.grad(lambda t: jnp.sum(jld(t)))(
            jnp.asarray(theta)))
        np.testing.assert_allclose(g[method], want, rtol=0, atol=TOL,
                                   err_msg=method)
    np.testing.assert_allclose(g["schur"], g["dense"], rtol=1e-8, atol=1e-10)


def test_logdet_accepts_angles(rng):
    theta = _angles(rng)
    ld = tf.StaggeredFermionLogDet(lat_shape=(4, 4), mass=0.4)
    np.testing.assert_allclose(ld(_t(theta)).numpy(),
                               ld(torch.exp(1j * _t(theta))).numpy(),
                               rtol=1e-12)


def test_logdet_differentiable(rng):
    g = _grad(tf.StaggeredFermionLogDet(lat_shape=(4, 4), mass=0.4),
              _angles(rng, batch=1))
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_schur_failed_factor_gives_nan(rng):
    """A factor that fails (here: NaN links) gives NaN, as
    ``jnp.linalg.cholesky`` does, and raises nothing."""
    theta = _angles(rng)
    theta[0, 0, 0, 0] = np.nan
    out = tf.StaggeredFermionLogDet(lat_shape=(4, 4), mass=0.3)(_t(theta))
    assert np.isnan(out[0].item()) and np.isfinite(out[1].item())


def test_schwinger_action_end_to_end(rng):
    lat = (4, 4)
    act = tf.build_schwinger_action(beta=2.0, lat_shape=lat, mass=0.3,
                                    n_copies=2)
    links = _t(_random_links(rng, lat=lat, batch=3))
    s_full, s_gauge = act(links).numpy(), act.gauge.action(links).numpy()
    assert np.isfinite(s_full).all()
    ld = tf.StaggeredFermionLogDet(lat_shape=lat, mass=0.3, n_copies=2)
    np.testing.assert_allclose(s_full, s_gauge - ld(links).numpy(),
                               rtol=1e-12)
    jact = jf.build_schwinger_action(beta=2.0, lat_shape=lat, mass=0.3,
                                     n_copies=2)
    np.testing.assert_allclose(s_full, np.asarray(jact(jnp.asarray(
        links.numpy()))), rtol=0, atol=TOL)


def test_schwinger_action_constructors_plumb_method(rng):
    lat = (3, 4)
    act = tf.build_schwinger_action(beta=2.0, lat_shape=lat, mass=0.3,
                                    method="dense")
    assert np.isfinite(act(_t(_random_links(rng, lat=lat))).numpy()).all()
    ang = tf.SchwingerAngleAction(beta=2.0, lat_shape=lat, mass=0.3,
                                  method="dense")
    assert np.isfinite(ang(_t(_angles(rng, lat))).numpy()).all()


def test_logdet_lat_shape_mismatch_raises(rng):
    ld = tf.StaggeredFermionLogDet(lat_shape=(4, 4), mass=0.3)
    with pytest.raises(ValueError, match="built for"):
        ld(_t(_random_links(rng, lat=(2, 6), batch=1)))


# ------------------------------------------------- the matrix-free operator
@pytest.mark.parametrize("apt", [True, False])
def test_hop_stencil_matches_dense_and_jax(rng, apt):
    links = _random_links(rng, lat=(4, 6))
    D = tf.staggered_dirac_matrix(_t(links), 0.0, antiperiodic_time=apt)
    v = rng.normal(size=(2, 4, 6)) + 1j * rng.normal(size=(2, 4, 6))
    hv = tf.apply_staggered_hop(_t(links), _t(v), antiperiodic_time=apt)
    np.testing.assert_allclose(
        hv.numpy().reshape(2, -1),
        torch.einsum("bij,bj->bi", D, _t(v).reshape(2, -1)).numpy(),
        atol=1e-12)
    want = jf.apply_staggered_hop(jnp.asarray(links), jnp.asarray(v),
                                  antiperiodic_time=apt)
    np.testing.assert_allclose(hv.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_dense_and_eo_matrices_match_jax(rng):
    for lat, apt in ((4, 6), True), ((2, 4), False), ((4, 2, 2), True):
        theta = _angles(rng, lat)
        np.testing.assert_allclose(
            tf.staggered_dirac_matrix(_t(theta), 0.3,
                                      antiperiodic_time=apt).numpy(),
            np.asarray(jf.staggered_dirac_matrix(jnp.asarray(theta), 0.3,
                                                 antiperiodic_time=apt)),
            rtol=0, atol=TOL)
        np.testing.assert_allclose(
            tf.staggered_eo_hopping(_t(theta), antiperiodic_time=apt).numpy(),
            np.asarray(jf.staggered_eo_hopping(jnp.asarray(theta),
                                               antiperiodic_time=apt)),
            rtol=0, atol=TOL)


def test_hop_stencil_broadcasts_probe_axis(rng):
    links = _t(_random_links(rng))
    v = _t(rng.normal(size=(3, 2, 4, 4)) + 1j * rng.normal(size=(3, 2, 4, 4)))
    hv = tf.apply_staggered_hop(links, v)
    for p in range(3):
        np.testing.assert_allclose(
            hv[p].numpy(), tf.apply_staggered_hop(links, v[p]).numpy(),
            atol=1e-12)


def test_K_identity_and_logdet_relation(rng):
    links = _random_links(rng, lat=(4, 4), batch=1)
    mass, V = 0.25, 16
    eye = torch.eye(V, dtype=torch.complex128).reshape(V, 1, 4, 4)
    K = tf.apply_staggered_K(_t(links), mass, eye).reshape(V, V).T.numpy()
    np.testing.assert_allclose(K, K.conj().T, atol=1e-12)
    assert np.linalg.eigvalsh(K).min() > 0
    D = tf.staggered_dirac_matrix(_t(links), mass)[0].numpy()
    np.testing.assert_allclose(0.5 * np.linalg.slogdet(K)[1],
                               np.linalg.slogdet(D)[1], rtol=1e-10)
    v = rng.normal(size=(2, 1, 4, 4)) + 1j * rng.normal(size=(2, 1, 4, 4))
    np.testing.assert_allclose(
        tf.apply_staggered_K(_t(links), mass, _t(v)).numpy(),
        np.asarray(jf.apply_staggered_K(jnp.asarray(links), mass,
                                        jnp.asarray(v))), rtol=0, atol=TOL)


def test_cg_batched_solves(rng):
    links = _t(_random_links(rng, lat=(4, 4), batch=3))
    b = _t(rng.normal(size=(3, 4, 4)) + 1j * rng.normal(size=(3, 4, 4)))
    x = tf._cg_batched(lambda v: tf.apply_staggered_K(links, 0.3, v), b,
                       tol=1e-12, maxiter=500, lat_ndim=2)
    np.testing.assert_allclose(tf.apply_staggered_K(links, 0.3, x).numpy(),
                               b.numpy(), atol=1e-9)


@pytest.mark.parametrize("tol,maxiter", [(1e-6, 200), (1e-10, 25)])
def test_fixed_count_cg_matches_the_jax_while_loop(rng, tol, maxiter):
    """The same systems (probe-shaped, with per-system masses through the
    batch), solved by the JAX loop that stops once every system has
    converged (first case) or at ``maxiter`` (second), and by the port's
    ``maxiter`` masked iterations."""
    links = _random_links(rng, lat=(4, 4), batch=3)
    b = rng.normal(size=(2, 3, 4, 4)) + 1j * rng.normal(size=(2, 3, 4, 4))
    want = jf._cg_batched(
        lambda v: jf.apply_staggered_K(jnp.asarray(links), 0.2, v),
        jnp.asarray(b), tol=tol, maxiter=maxiter, lat_ndim=2)
    got = tf._cg_batched(lambda v: tf.apply_staggered_K(_t(links), 0.2, v),
                         _t(b), tol=tol, maxiter=maxiter, lat_ndim=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _jax_probe_draw(key, n_probes, theta):
    """The Z4 probes JAX's ``StochasticStaggeredLogDet`` draws from
    ``key`` (``fermions.py:384-387``)."""
    quarter = jax.random.randint(key, (n_probes,) + theta.shape[:1]
                                 + theta.shape[2:], 0, 4)
    table = np.array([1 + 0j, 1j, -1 + 0j, -1j])
    return table[np.asarray(quarter)]


def test_stochastic_logdet_matches_jax_on_injected_probes(rng):
    """Value and gradient of the surrogate on the probes JAX draws from a
    key, injected into the port."""
    lat = (4, 4)
    theta = _angles(rng, lat, batch=2)
    kw = dict(lat_shape=lat, mass=0.3, n_copies=2, n_probes=3, cg_tol=1e-8,
              cg_maxiter=120)
    key = jax.random.key(11)
    jest = jf.StochasticStaggeredLogDet(**kw).with_key(key)
    want = np.asarray(jest(jnp.asarray(theta)))
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(jest(t)))(
        jnp.asarray(theta)))
    z = _t(_jax_probe_draw(key, 3, theta))
    est = tf.StochasticStaggeredLogDet(**kw)
    np.testing.assert_allclose(est.surrogate(_t(theta), z).numpy(), want,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(
        _grad(lambda t: est.surrogate(t, z), theta), want_g, rtol=0,
        atol=TOL)
    # the keyed port draws its probes through ``_probes``
    keyed = est.with_key(torch.Generator().manual_seed(0))
    keyed._probes = lambda links: z
    np.testing.assert_allclose(keyed(_t(theta)).numpy(), want, rtol=0,
                               atol=TOL)


def test_z4_probes_from_the_generator():
    est = tf.StochasticStaggeredLogDet(lat_shape=(4, 4), n_probes=64)
    links = torch.ones((8, 2, 4, 4), dtype=torch.complex128)
    z = est.with_key(torch.Generator().manual_seed(5))._probes(links)
    again = est.with_key(torch.Generator().manual_seed(5))._probes(links)
    assert z.shape == (64, 8, 4, 4) and torch.equal(z, again)
    vals = set(z.reshape(-1).tolist())
    assert vals == {1 + 0j, 1j, -1 + 0j, -1j}
    # E[z z^dagger] = I: the mean of |z|^2 is 1 and of z z' -> 0
    assert torch.allclose(torch.abs(z), torch.ones(()).double())
    assert abs(complex((z[:, :, 0, 0] * z[:, :, 0, 1].conj()).mean())) < 0.1


def test_stochastic_logdet_gradient_unbiased(rng):
    """The surrogate's gradient averages to the exact log-det gradient
    over probe draws (64 generators x 4 probes)."""
    lat = (4, 4)
    theta = _angles(rng, lat, batch=1)
    exact = tf.StaggeredFermionLogDet(lat_shape=lat, mass=0.3)
    g_exact = _grad(exact, theta)
    est = tf.StochasticStaggeredLogDet(lat_shape=lat, mass=0.3, n_probes=4,
                                       cg_tol=1e-10, cg_maxiter=400)
    np.testing.assert_allclose(est(_t(theta)).numpy(),
                               exact(_t(theta)).numpy(), rtol=1e-10)
    grads = np.stack([
        _grad(est.with_key(torch.Generator().manual_seed(100 + i)), theta)
        for i in range(64)])
    mean = grads.mean(axis=0)
    stderr = grads.std(axis=0) / np.sqrt(64) + 1e-12
    assert np.all(np.abs(mean - g_exact) < 5 * stderr)
    assert np.corrcoef(mean.ravel(), g_exact.ravel())[0, 1] > 0.95


def _angle_model(action, lat=(4, 4), seed=7, flow=None):
    if flow is None:
        flow = build_u1_gauge_flow(torch.Generator().manual_seed(3), lat,
                                   knots_len=4, hidden=(4,), n_cycles=1,
                                   dtype=torch.float64)
    kw = dict(dtype=torch.float64, device="cpu")
    prior = UniformPrior(torch.full((2, *lat), -np.pi, **kw),
                         torch.full((2, *lat), np.pi, **kw))
    return Model(net_=flow, prior=prior, action=action, seed=seed)


def test_stochastic_schwinger_action_trains(rng):
    """The fitter keys the stochastic log-det with the model's generator:
    the first-step loss differs from exact-action training by O(V), the
    run stays finite, and the same action called keyless is exact."""
    lat = (4, 4)
    est = tf.StochasticStaggeredLogDet(lat_shape=lat, mass=0.3, n_probes=2,
                                       cg_tol=1e-6, cg_maxiter=200)
    action = tf.SchwingerAngleAction(beta=1.0, lat_shape=lat, mass=0.3,
                                     logdet_func=est)
    assert hasattr(action, "with_key")
    hp = dict(hyperparam=dict(lr=1e-3, weight_decay=0.0),
              checkpoint_dict=dict(print_stride=None))
    model = _angle_model(action)
    hist = model.fit(n_epochs=6, batch_size=8, **hp)
    assert np.isfinite(hist["loss"]).all()
    exact = _angle_model(tf.SchwingerAngleAction(beta=1.0, lat_shape=lat,
                                                 mass=0.3))
    hist_exact = exact.fit(n_epochs=1, batch_size=8, **hp)
    assert abs(hist["loss"][0] - hist_exact["loss"][0]) > 1.0
    theta = _t(_angles(rng, lat))
    np.testing.assert_allclose(action(theta).numpy(),
                               exact.action(theta).numpy(), rtol=1e-10)
    # the keyed training action is built once per action and fit call
    keyed = model.fit._training_action()
    assert keyed is model.fit._training_action()
    assert keyed.logdet_func.key is model.generator


def test_keyed_training_draws_probes_from_the_model_generator():
    """A step's probes are the model generator's next draws after the
    prior's: the step's loss equals the loss of the body rebuilt by hand
    from the same generator state."""
    lat = (4, 4)
    est = tf.StochasticStaggeredLogDet(lat_shape=lat, mass=0.3, n_probes=2,
                                       cg_tol=1e-6, cg_maxiter=60)
    model = _angle_model(tf.SchwingerAngleAction(
        beta=1.0, lat_shape=lat, mass=0.3, logdet_func=est))
    model.fit(n_epochs=0, batch_size=8, checkpoint_dict=dict(
        print_stride=None))
    state = model.generator.get_state()
    x, logr = model.prior.sample_(8, model.generator)
    with torch.no_grad():
        y, logj = model.net_.forward(x)
        keyed = model.action.with_key(model.generator)
        want = torch.mean(logr - logj + keyed(y))
    model.generator.set_state(state)
    loss, _ = model.fit.train_body()  # the step moves the weights after
    assert float(loss) == float(want)


@pytest.mark.parametrize("method", ["schur", "dense"])
def test_schwinger_angle_action_matches_jax(rng, method):
    lat = (4, 4)
    theta = _angles(rng, lat, batch=3)
    kw = dict(beta=1.5, lat_shape=lat, mass=0.25, n_copies=2, method=method)
    jact, tact = jf.SchwingerAngleAction(**kw), tf.SchwingerAngleAction(**kw)
    assert tact.with_key(torch.Generator()) is tact
    for name in ("action", "calc_topo_charge", "log_prob"):
        np.testing.assert_allclose(
            getattr(tact, name)(_t(theta)).numpy(),
            np.asarray(getattr(jact, name)(jnp.asarray(theta))),
            rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(
        _grad(tact, theta),
        np.asarray(jax.grad(lambda t: jnp.sum(jact(t)))(jnp.asarray(theta))),
        rtol=0, atol=TOL)


# ----------------------------------------------------------- the slice whole
def test_schwinger_guarded_step_matches_jax_and_optax(rng):
    """Two steps of the 8x8 exact Schwinger model as its example trains it
    (reparametrization gradient, AdamW lr 1e-3, no decay), on the same
    prior draws: losses to 1e-10, leaves to 1e-9."""
    lat = (8, 8)
    jflow = jax_u1_flow(jax.random.key(2), lat, knots_len=6, hidden=(4,),
                        n_cycles=1)
    jprior = nf.prior.UniformPrior.build(low=-np.pi * np.ones((2, *lat)),
                                         high=np.pi * np.ones((2, *lat)))
    kw = dict(beta=2.0, lat_shape=lat, mass=0.2)
    jmodel = nf.Model(net_=jflow, prior=jprior,
                      action=jf.SchwingerAngleAction(**kw), seed=0)
    flow = build_u1_gauge_flow(torch.Generator(), lat, knots_len=6,
                               hidden=(4,), n_cycles=1, dtype=torch.float64)
    leaves = perturbed_leaves(jflow, rng)
    load_jax_leaves(flow, leaves)
    jmodel.net_ = restore_into(jflow, leaves)
    model = _angle_model(tf.SchwingerAngleAction(**kw), lat, flow=flow)
    guarded_step_vs_jax(jmodel, model, [_angles(rng, lat, batch=4)
                                        for _ in range(2)], path=False)


def test_schwinger_example_runs_on_the_cpu(capsys):
    model = schwinger.main(lat_shape=(4, 4), n_epochs=2, batch_size=8,
                           n_cycles=1, knots_len=4, device="cpu")
    out = capsys.readouterr().out
    assert "number of model parameters = " in out and "<cos P> = " in out
    assert model.device.type == "cpu"
