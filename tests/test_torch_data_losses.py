"""Every training loss over several data ranks, on a real gloo group on the
CPU.

The JAX package computes any loss on the sharded global batch
(``normflow__tpu/training/losses.py:1-8``); the port gathers the data
ranks' per-sample ``logq`` and ``logp`` (``ModelDeviceHandler.
gather_rows``), takes the loss of the global batch on every rank and sums
the ranks' gradients.  One spawned job (``tests/_torch_losses_worker.
run_rank``, four ranks) fits the affine model of ``tests/test_parallel.py:
17-29`` (perturbed weights, 8x8, float64) for three steps with each of the
eight losses and both gradient estimators over a data axis of two ranks and
over ``{"data": 2, "space": 2}``.  The draws are the JAX fitter's own
(``model.next_key()`` per step, ``fitter.py:428-434``), fed to the port as
numpy; each sharded fit's losses and parameters are held to 1e-10 against
the JAX package's unsharded ``Model.fit`` and against the port's one-rank
fit.  ``torch.autograd.gradcheck`` holds the data gather's backward.
"""

import concurrent.futures
import warnings

import jax
import numpy as np
import pytest

from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into

import _torch_losses_worker as W
import _torch_space_worker as S
from test_torch_flagship import perturbed_leaves
from test_torch_space import jax_affine

B, STEPS, TOL = 16, 3, 1e-10
CASES = [(mesh, loss, est) for mesh in W.MESHES for loss in W.LOSSES
         for est in W.ESTIMATORS]


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def jax_draws(jmodel, n, b):
    """The prior draws of the JAX fitter's first ``n`` steps at batch
    ``b``: step ``k`` splits the model's key (``Model.next_key``) and
    draws ``prior.sample_(key, b)``."""
    key, out = jmodel._key, []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jmodel.prior.sample_(sub, b)[0]))
    return out


def jax_fit(leaves, loss, est):
    """The JAX package's unsharded ``Model.fit`` of ``STEPS`` steps:
    ``(losses, parameters as the port's, flattened)``."""
    jmodel = jax_affine()
    jmodel.net_ = restore_into(jmodel.net_, leaves)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hist = jmodel.fit(n_epochs=STEPS, batch_size=B,
                          loss_fn=getattr(jlosses, loss), grad_estimator=est,
                          **W.FIT)
    return ([float(v) for v in hist["loss"]],
            W.as_port_params(leaves_of(jmodel.net_)))


@pytest.fixture(scope="module")
def job():
    """The four ranks' fits (spawned first, run beside the JAX fits), the
    JAX package's unsharded fits and the port's one-rank fits."""
    rng = np.random.default_rng(20261019)
    leaves = perturbed_leaves(jax_affine().net_, rng)
    draws = jax_draws(jax_affine(), STEPS, B)
    handler = S.affine_model().device_handler
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(handler.spawnprocesses, W.run_rank, 4,
                            dict(leaves=leaves, draws=draws))
        want = {(loss, est): jax_fit(leaves, loss, est)
                for loss in W.LOSSES for est in W.ESTIMATORS}
        one = W.one_rank_fits(leaves, draws)
        return dict(ranks=ranks.result(), jax=want, one=one)


@pytest.mark.parametrize("mesh,loss,est", CASES)
def test_sharded_fit_matches_jax_unsharded_fit(job, mesh, loss, est):
    """The sharded fit's losses (rank 0's history) and every rank's final
    parameters against the JAX package's unsharded fit on the same draws."""
    losses, _ = job["ranks"][0][mesh, loss, est]
    want_losses, want_params = job["jax"][loss, est]
    assert len(losses) == STEPS
    _close(losses, want_losses)
    for r in job["ranks"]:
        _close(r[mesh, loss, est][1], want_params)


@pytest.mark.parametrize("mesh,loss,est", CASES)
def test_sharded_fit_matches_one_rank_fit(job, mesh, loss, est):
    """The same against the port's fit on one rank; every rank ends with
    the parameters of rank 0 bit for bit, and only the handler's rank 0
    keeps the history."""
    losses, params = job["ranks"][0][mesh, loss, est]
    want_losses, want_params = job["one"][loss, est]
    _close(losses, want_losses)
    _close(params, want_params)
    for r in job["ranks"]:
        np.testing.assert_array_equal(r[mesh, loss, est][1], params)
        keeps = r["rank"] == 0 or (mesh == "data" and r["rank"] == 2)
        assert (r[mesh, loss, est][0] != []) == keeps


def test_data_gather_gradcheck(job):
    """``gradcheck`` of the data gather over two ranks, on both pairs."""
    for r in job["ranks"]:
        assert r["gradcheck"] is True, r["gradcheck"]
