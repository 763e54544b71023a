"""The port's data parallelism (``normflow__tpu_torch/parallel``) on a real
2-rank gloo group on the CPU.

One spawned job (``ModelDeviceHandler.spawnprocesses``: two processes,
``torch.multiprocessing``, a free ``localhost`` port, one thread each) runs
``tests/_torch_ddp_worker.run_rank`` on both ranks of the small float64
flagship (8x8, 4 knots, hidden (4,), 2 couplings; rank 0's perturbed
weights broadcast by ``replicate_params``).  Every draw is numpy from one
seed and split by rows over the ranks, so each sharded run is held against
one rank's run on the whole draws: four fit steps to 1e-12 with the
parameters identical across ranks bit for bit, a spike that only rank 1
sees rewinding both ranks, ``sample_chain`` and ``sample_parallel_chains``
equal to the unsharded samplers, and the global batch's loss and the
summed gradient against ``jax.grad`` of the JAX package's step on its
8-device CPU mesh with the batch sharded (``tests/test_parallel.py:39``'s
pattern).  The guard rules (a batch that does not divide, a bad address, a
failing rank) raise; every loss trains over several data ranks
(``tests/test_torch_data_losses.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch.parallel import (batch_axis, fold_key, fold_seed,
                                          init_distributed)
from normflow__tpu_torch.parallel.dryrun import dryrun_multichip
from normflow__tpu_torch.zoo import build_phi4_model

import _torch_ddp_worker as W
from test_torch_flagship import perturbed_leaves

B = 16  # a global batch: 8 per rank here, 2 per device of the JAX mesh


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def job():
    """The leaves and draws, both ranks' results, and one rank's runs on
    the whole draws."""
    rng = np.random.default_rng(20261017)
    leaves = perturbed_leaves(jax_build(**W.SMALL).net_, rng)
    fit_draws = [rng.standard_normal((B, 8, 8)) for _ in range(4)]
    spike_draws = [rng.standard_normal((B, 8, 8)) for _ in range(6)]

    def rounds(n):
        return [(rng.standard_normal((B, 8, 8)),
                 np.log(rng.random(B))) for _ in range(n)]

    chain_rounds, par_rounds = rounds(3), rounds(3)
    handler = W.small_model().device_handler
    ranks = handler.spawnprocesses(W.run_rank, 2, leaves, fit_draws,
                                   spike_draws, chain_rounds, par_rounds)

    one = W.small_model(leaves)
    ref = dict(fit=W.fit_steps(one, fit_draws),
               rewind=W.rewind_run(W.small_model(leaves), spike_draws,
                                   {2, 3}))
    model = W.small_model(leaves)
    W.feed_sampler(model.mcmc, model.prior, chain_rounds)
    ref["chain"] = model.mcmc.sample_chain(3, B, collect_samples=True)
    ref["chain_ref"] = model.mcmc._ref
    W.feed_sampler(model.mcmc, model.prior, par_rounds)
    ref["parallel"] = model.mcmc.sample_parallel_chains(
        3, B, collect_samples=True)
    return dict(leaves=leaves, fit_draws=fit_draws, ranks=ranks, ref=ref)


def test_ranks_and_broadcast(job):
    r0, r1 = job["ranks"]
    assert (r0["rank"], r1["rank"], r0["nranks"]) == (0, 1, 2)
    for a, b in zip(r0["replicated"], r1["replicated"]):
        np.testing.assert_array_equal(a, b)
    # rank 1's generator is folded, rank 0's keeps the model's seed
    assert (r0["seed"], r1["seed"]) == (3, fold_seed(3, 1))


def test_dp_fit_equals_one_rank_fit(job):
    """Four data-parallel steps equal one rank's steps on the concatenated
    draws, to 1e-12 (the averaged loss and gradients are a sum of halves
    in another order)."""
    (loss, params), (want_loss, want_params) = (job["ranks"][0]["fit"],
                                                job["ref"]["fit"])
    assert len(loss) == 4 and job["ranks"][1]["fit"][0] == []  # rank 0's
    _close(loss, want_loss)
    for p, q in zip(params, want_params):
        _close(p, q)


def test_dp_params_identical_across_ranks(job):
    r0, r1 = job["ranks"]
    for what in ("fit", "rewind"):
        for a, b in zip(r0[what][1], r1[what][1]):
            np.testing.assert_array_equal(a, b)


def test_dp_rewind_on_every_rank(job):
    """Only rank 1's draws of steps 3 and 4 spike; the all-reduced loss
    carries the spike, so both ranks rewind after the second segment and
    end where one rank on the whole draws ends."""
    r0, r1 = job["ranks"]
    rewinds, params = job["ref"]["rewind"]
    assert r0["rewind"][0] == r1["rewind"][0] == rewinds == [4]
    for p, q in zip(r0["rewind"][1], params):
        _close(p, q)


def test_dp_grads_match_jax_sharded_step(job):
    """The global batch's loss and the summed gradients of the first draw
    against ``jax.value_and_grad`` of the JAX fitter's loss with the batch
    sharded over the 8-device CPU mesh."""
    jmodel = jax_build(**W.SMALL, dtype=jnp.float64)
    jmodel.net_ = restore_into(jmodel.net_, job["leaves"])
    jmodel.device_handler.use_mesh(n_devices=8)
    sharder = jmodel.device_handler.batch_sharder()
    x = jnp.asarray(job["fit_draws"][0])

    @jax.jit
    def loss_of(net):  # normflow__tpu/training/fitter.py:250-268, rep
        xs = sharder(x)
        y, logj = net.forward(xs)
        return jlosses.calc_kl_mean(jmodel.prior.log_prob(xs) - logj,
                                    -jmodel.action(y))

    want_loss, want_grads = jax.value_and_grad(loss_of)(jmodel.net_)
    want = leaves_of(want_grads)
    for r in job["ranks"]:
        loss, grads = r["grads"]
        _close(loss, want_loss, atol=1e-10)
        assert grads.keys() == want.keys()
        for k in want:
            _close(grads[k], want[k], atol=1e-9)


def test_sharded_sample_chain_equals_unsharded(job):
    """Each rank draws half of every round; the gathered chain, its
    samples and its carried reference are those of one rank, on every
    rank."""
    ref = job["ref"]["chain"]
    for r in job["ranks"]:
        for k in ("logq", "logp", "samples", "accept_rate"):
            _close(r["chain"][k], ref[k], atol=1e-10)
        for g, w in zip(r["chain_ref"], job["ref"]["chain_ref"]):
            _close(g, w, atol=1e-10)


def test_sharded_parallel_chains_equal_unsharded(job):
    ref = job["ref"]["parallel"]
    for r in job["ranks"]:
        for k in ("logq", "logp", "samples", "final_samples"):
            assert r["parallel"][k].shape == tuple(ref[k].shape)
            _close(r["parallel"][k], ref[k], atol=1e-10)
        np.testing.assert_array_equal(r["parallel"]["accept_rate"],
                                      ref["accept_rate"])


@pytest.mark.parametrize("name,match", [("odd_batch", "does not divide")])
def test_dp_guard_rules_raise(job, name, match):
    for r in job["ranks"]:
        assert r[name] is not None and match in r[name], r[name]


@pytest.mark.parametrize("kw,err", [
    (dict(rank=2, world_size=2, init_method="tcp://localhost:1"),
     ValueError),
    (dict(rank=0, world_size=1), ValueError),  # no address
    (dict(rank=0, world_size=1, init_method="nosuch://localhost:1"),
     (ValueError, RuntimeError)),
])
def test_init_distributed_raises(kw, err, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(err):
        init_distributed(device="cpu", **kw)
    assert not torch.distributed.is_initialized()


def test_handler_without_a_group():
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device="cpu")
    dh = model.device_handler
    assert (dh.rank, dh.nranks, dh.group) == (0, 1, None)
    assert dh.batch_sharder()(7) == 7
    x = torch.arange(6.0)
    assert dh.all_gather_into_tensor(x) is x
    assert dh.gather_rows(x, x)[1] is x
    with pytest.raises(RuntimeError, match="init_distributed"):
        dh.use_mesh()
    # JAX's axis-order rule (tests/test_parallel.py:304-315), checked
    # before a group is needed
    with pytest.raises(ValueError, match="batch axis"):
        dh.use_mesh(axes={"space": 8})
    # an axis that is neither the batch axis nor space replicates, as in
    # JAX: the mesh is accepted, and only the missing group stops it
    with pytest.raises(RuntimeError, match="init_distributed"):
        dh.use_mesh(axes={"data": 2, "space": 2, "time": 2})
    assert batch_axis({"data": 2, "space": 2, "time": 2}) == "data"
    assert batch_axis({"time": 2, "space": 2}) == "time"
    with pytest.raises(RuntimeError, match="init_distributed"):
        dh.use_mesh(axes={"space": 2, "data": 4})
    assert (dh.group, dh.slab, dh.space_axis) == (None, None, None)
    assert batch_axis({"space": 2, "data": 4}) == "data"
    assert batch_axis({"space": 2, "rows": 4}, axis="data") == "rows"


def test_fold_key_rule():
    g = torch.Generator().manual_seed(11)
    assert fold_seed(11, 0) == 11 and fold_seed(11, 3) == 11 + 3 * 2**32
    a, b = fold_key(g, 2), fold_key(g, 2)
    assert a.initial_seed() == fold_seed(11, 2)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert fold_key(g, 0).initial_seed() == 11


def test_dryrun_multichip_two_ranks():
    """Pass 1 alone: two ranks are too few for the data x space mesh."""
    losses = dryrun_multichip(2, device="cpu")
    (dp0, dpsp0), (dp1, dpsp1) = losses
    assert dp0 == dp1 and np.isfinite(dp0)
    assert np.isnan(dpsp0) and np.isnan(dpsp1)


def test_dryrun_multichip_four_ranks_runs_both_passes():
    """Four ranks: pass 1 on the data axis, pass 2 on ``{"data": 2,
    "space": 2}``."""
    losses = dryrun_multichip(4, device="cpu")
    assert len(losses) == 4
    assert all(pair == losses[0] for pair in losses)
    assert np.isfinite(losses[0]).all()


def test_spawnprocesses_reports_a_failing_rank():
    dh = W.small_model().device_handler
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        dh.spawnprocesses(W.failing_rank, 2)
