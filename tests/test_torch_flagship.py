"""Port parity of the whole sampling slice on a small flagship.

``build_phi4_model`` at 8x8, 4 knots, hidden (4,), 2 coupling layers, in
both packages; the JAX leaves are perturbed with seeded numpy noise and
transplanted into the port.  Per sample ``y``, ``logJ``, ``logq``, ``logp``
and ``logq - logp`` agree to 1e-9 in float64 (rtol 1e-5 in float32), the round trip is
exact to 1e-10, and the host statistics (ESS, the Metropolis recurrence, the
resampled accept rate) give the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.mcmc.metropolis import _accept_scan_core
from normflow__tpu.mcmc.metropolis import \
    estimate_accept_rate as jax_accept_rate
from normflow__tpu.ops.stats import calc_ess as jax_calc_ess
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
import normflow__tpu_torch as nt
from normflow__tpu_torch.utils.transplant import load_jax_leaves
from normflow__tpu_torch.zoo import build_phi4_model

SMALL = dict(lat_shape=(8, 8), knots=4, hidden=(4,), n_layers=2)
B = 8


def perturbed_leaves(jax_tree, rng, scale=0.3):
    """Leaves plus N(0, scale^2) noise; 4-D (conv) leaves get noise scaled
    by their init bound 1/sqrt(fan_in)."""
    leaves = leaves_of(jax_tree)
    for k, a in leaves.items():
        s = scale / np.sqrt(np.prod(a.shape[:-1])) if a.ndim == 4 else scale
        leaves[k] = a + rng.standard_normal(a.shape) * s
    return leaves


def twin_models(rng, jax_dtype, torch_dtype):
    jmodel = jax_build(**SMALL, dtype=jax_dtype)
    model = build_phi4_model(**SMALL, dtype=torch_dtype, device="cpu")
    leaves = perturbed_leaves(jmodel.net_, rng)
    load_jax_leaves(model.net_, leaves)
    jmodel.net_ = restore_into(jmodel.net_, leaves)
    return jmodel, model


@jax.jit
def _jax_logq_logp(net, prior, action, x):
    y, logj = net.forward(x)
    return y, logj, prior.log_prob(x) - logj, -action(y)


def logqp_both(jmodel, model, x):
    """``(y, logJ, logq, logp)`` per sample from the port and from JAX."""
    with torch.no_grad():
        tx = torch.from_numpy(x)
        y, logj = model.net_.forward(tx)
        logq = model.prior.log_prob(tx) - logj
    return ((y, logj, logq, -model.action(y)),
            _jax_logq_logp(jmodel.net_, jmodel.prior, jmodel.action,
                           jnp.asarray(x)))


@pytest.fixture
def twins(rng):
    return twin_models(rng, jnp.float64, torch.float64)


def test_transplant_accepts_flagship_leaves():
    jmodel = jax_build(**SMALL)
    model = build_phi4_model(**SMALL, dtype=torch.float64, device="cpu")
    leaves = leaves_of(jmodel.net_)
    load_jax_leaves(model.net_, leaves)
    assert len(leaves) == len(list(model.net_.parameters())) == 15
    assert jmodel.net_.npar == model.net_.npar


def test_full_width_parameter_count():
    """The 32x32 flagship's 23 leaves and 41,571 parameters."""
    model = build_phi4_model(device="cpu")
    assert len(list(model.net_.parameters())) == 23
    assert model.net_.npar == 41571


def test_forward_logq_logp_agree(rng, twins):
    jmodel, model = twins
    x = rng.standard_normal((B, 8, 8))
    got, want = logqp_both(jmodel, model, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose((got[2] - got[3]).numpy(),
                               np.asarray(want[2] - want[3]), rtol=0,
                               atol=1e-9)


def test_inverse_log_prob_agrees(rng, twins):
    jmodel, model = twins
    y = rng.standard_normal((B, 8, 8))
    got = model.posterior.log_prob(torch.from_numpy(y))
    want = jmodel.posterior.log_prob(jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)


def test_backward_sanitychecker(twins):
    _, model = twins
    x_err, logj_err = nt.backward_sanitychecker(model, n_samples=B,
                                                verbose=False)
    assert x_err <= 1e-10 and logj_err <= 1e-10


def test_calc_ess_agrees(rng, twins):
    jmodel, model = twins
    (_, _, logq, logp), (_, _, jlogq, jlogp) = logqp_both(
        jmodel, model, rng.standard_normal((B, 8, 8)))
    np.testing.assert_allclose(float(nt.calc_ess(logq, logp)),
                               float(jax_calc_ess(jlogq, jlogp)), rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_accept_scan_core_identical(rng, dtype):
    logqp = (rng.standard_normal(256) * 2).astype(dtype)
    lrand = np.log(rng.random(256)).astype(dtype)
    ref = dtype(logqp[0] + 0.5)
    got = nt.accept_scan_core(lrand, logqp, ref)
    want = _accept_scan_core(jnp.asarray(lrand), jnp.asarray(logqp),
                             jnp.asarray(ref))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed", [0, 7])
def test_estimate_accept_rate_identical(rng, seed):
    logqp = rng.standard_normal(512) * 1.5
    assert nt.estimate_accept_rate(logqp, seed=seed) == \
        jax_accept_rate(logqp, seed=seed)


def test_logqp_stream_and_mcmc(twins):
    _, model = twins
    logqp = model.posterior.logqp_stream(3, B)
    assert logqp.shape == (3 * B,) and bool(torch.isfinite(logqp).all())
    y0, logq0, logp0 = model.mcmc.sample__(B, bookkeeping=True)
    y1, logq1, logp1 = model.mcmc.sample__(B)  # from the carried _ref
    assert y1.shape == (B, 8, 8) and len(model.mcmc.history.accept_rate) == 2
    # a kept sample is a proposal or the carried reference, with its own logq
    raw_logq = model.mcmc.history.raw_logq[0]
    for i, j in enumerate(model.mcmc.history.accept_ind[0]):
        assert float(logq0[i]) == float(raw_logq[j])
    np.testing.assert_allclose(logp1.numpy(), -model.action(y1).numpy())


def test_float32_agrees(rng):
    jmodel, model = twin_models(rng, jnp.float32, torch.float32)
    x = rng.standard_normal((B, 8, 8)).astype(np.float32)
    got, want = logqp_both(jmodel, model, x)
    for g, w in zip(got, want):  # y, logJ, logq, logp: each at rtol 1e-5
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
