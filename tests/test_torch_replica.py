"""A mesh axis that is neither the batch axis nor ``space`` on a real
4-rank gloo group on the CPU.

The JAX package's ``use_mesh(axes=...)`` shards the batch over one axis
and the first lattice axis over ``space``, and replicates over every other
axis (``normflow__tpu/parallel/mesh.py:106-137``).  One spawned job
(``ModelDeviceHandler.spawnprocesses``, one thread per rank) runs
``tests/_torch_space_worker.replica_rank`` on the small float64 flagship
(8x8, 4 knots, hidden (4,), 2 couplings, perturbed weights) under
``{"data": 2, "replica": 2}``, then under ``{"data": 1, "space": 2,
"replica": 2}``.  Every draw is numpy from one seed; each rank takes its
data rank's rows and its slab.  Replicas take the same rows, the same slab
and the same streams, and the gradients sum over the data and space ranks
alone, so each run equals one rank's run on the whole draws (the mesh
without the replica axis): four fit steps to 1e-12, the parameters the same
bits on every rank, the samplers to 1e-10, and the loss and the summed
gradient of the first draw against ``jax.value_and_grad`` of the JAX step
on its CPU mesh with the same axes.
"""

import jax
import numpy as np
import pytest

from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch.parallel import fold_seed

import _torch_space_worker as W
from test_torch_flagship import perturbed_leaves

B, LAT = 16, W.LAT
AXES = {"data": 2, "replica": 2}
SPACE_AXES = {"data": 1, "space": 2, "replica": 2}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def job():
    """The leaves and draws, the four ranks' results and one rank's runs
    on the whole draws."""
    rng = np.random.default_rng(20261019)
    leaves = perturbed_leaves(jax_build(**W.SMALL).net_, rng)

    def rounds(n):
        return [(rng.standard_normal((B, *LAT)), np.log(rng.random(B)))
                for _ in range(n)]

    spec = dict(leaves=leaves, axes=AXES, space_axes=SPACE_AXES,
                x=rng.standard_normal((B, *LAT)),
                fits=[rng.standard_normal((B, *LAT)) for _ in range(4)],
                space_fits=[rng.standard_normal((B, *LAT))
                            for _ in range(2)],
                chain_rounds=rounds(3), par_rounds=rounds(3))
    ranks = W.flagship().device_handler.spawnprocesses(W.replica_rank, 4,
                                                       spec)

    def one():
        return W.attached("flagship", leaves, None)

    ref = dict(grads=W.grads_of(one(), spec["x"], "rep"),
               fit=W.fit_run(one(), spec["fits"]),
               space_fit=W.fit_run(one(), spec["space_fits"]),
               samplers=W.samplers(one(), spec["chain_rounds"],
                                   spec["par_rounds"]))
    return dict(spec=spec, ranks=ranks, ref=ref)


def test_replicas_share_rows_streams_and_sums(job):
    """Rank ``r`` is data rank ``r // 2``: its prior stream is that data
    rank's (``fold_seed`` of it), and the gradients sum over the two data
    ranks; under the space axis rank ``r`` holds slab ``r // 2``."""
    for r in job["ranks"]:
        top, d = r["topology"], r["topology"]["rank"] // 2
        assert (top["data_axis"], top["n_data"], top["data_rank"],
                top["stream_rank"], top["reduce_ranks"], top["slab"]) == (
            "data", 2, d, d, 2, None)
        assert top["seed"] == fold_seed(3, d)
        top = r["space topology"]
        assert top["stream_rank"] == top["rank"] // 2
        assert top["slab"] == (top["rank"] // 2, 2, 4 * (top["rank"] // 2),
                               4)
        assert top["seed"] == fold_seed(3, top["rank"] // 2)


def test_replica_fit_equals_one_rank_fit(job):
    """Four steps on the 2 x 2 mesh equal one rank's steps on the whole
    draws, to 1e-12 (a sum over the two data ranks in another order); the
    replicas counted once."""
    losses, params = job["ranks"][0]["fit"]
    want_losses, want_params = job["ref"]["fit"]
    assert len(losses) == 4
    _close(losses, want_losses, 1e-12)
    _close(params, want_params, 1e-12)


@pytest.mark.parametrize("what", ["fit", "space fit"])
def test_replica_params_identical_across_ranks(job, what):
    ranks = job["ranks"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[what][1], ranks[0][what][1])


def test_replica_with_space_equals_one_rank_fit(job):
    """Two steps with the lattice split over ``space`` and replicated:
    the unsharded fit to 1e-10, the space tests' bar."""
    losses, params = job["ranks"][0]["space fit"]
    want_losses, want_params = job["ref"]["space_fit"]
    assert len(losses) == 2
    _close(losses, want_losses, 1e-10)
    _close(params, want_params, 1e-10)


def test_replica_grads_match_jax_mesh(job):
    """The first draw's loss and summed gradients on every rank against
    one rank's on the whole draw and ``jax.value_and_grad`` of the JAX
    fitter's loss with the batch sharded over ``data`` and replicated over
    ``replica`` (8 virtual CPU devices, 4 in the mesh)."""
    jmodel = jax_build(**W.SMALL)
    jmodel.net_ = restore_into(jmodel.net_, job["spec"]["leaves"])
    jmodel.device_handler.use_mesh(axes=AXES)
    sharder = jmodel.device_handler.batch_sharder()
    x = jax.numpy.asarray(job["spec"]["x"])

    @jax.jit
    def loss_of(net):  # normflow__tpu/training/fitter.py:250-268, rep
        xs = sharder(x)
        y, logj = net.forward(xs)
        return jlosses.calc_kl_mean(jmodel.prior.log_prob(xs) - logj,
                                    -jmodel.action(y))

    want_loss, want_grads = jax.value_and_grad(loss_of)(jmodel.net_)
    want = leaves_of(want_grads)
    ref = job["ref"]["grads"]
    for r in job["ranks"]:
        got = r["grads"]
        _close(got["loss"], want_loss, 1e-10)
        _close(got["loss"], ref["loss"], 1e-12)
        assert got["grads"].keys() == want.keys()
        for k in want:
            _close(got["grads"][k], want[k], 1e-9)
            _close(got["grads"][k], ref["grads"][k], 1e-12)


def test_replica_samplers_equal_unsharded(job):
    ref = job["ref"]["samplers"]
    for r in job["ranks"]:
        got = r["samplers"]
        for k in ("logq", "logp", "samples", "accept_rate"):
            _close(got["chain"][k], ref["chain"][k], 1e-10)
        for g, w in zip(got["chain_ref"], ref["chain_ref"]):
            _close(g, w, 1e-10)
        for k in ("logq", "logp", "samples", "final_samples"):
            _close(got["parallel"][k], ref["parallel"][k], 1e-10)
        np.testing.assert_array_equal(got["parallel"]["accept_rate"],
                                      ref["parallel"]["accept_rate"])


def test_replicas_draw_alike(job):
    """An unfed ``posterior.sample__``: the replicas of a data rank draw
    the same bits from their shared stream (the data ranks' seeds differ:
    ``test_replicas_share_rows_streams_and_sums``)."""
    r0, r1, r2, r3 = (r["sample__"] for r in job["ranks"])
    for a, b in ((r0, r1), (r2, r3)):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
