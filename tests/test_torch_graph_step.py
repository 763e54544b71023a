"""The port's graph-ready training step and its bench, on the CPU.

On a CUDA model ``model.fit`` replays one captured step and
``logqp_stream`` one captured batch (``normflow__tpu_torch/utils/
graphs.py``); here the same bodies run eagerly.  Covered: one guarded step
of an 8x8 flagship with the bench's optimizer (clip 25, AdamW with a
cosine schedule read from the float64 device count) against
``jax.value_and_grad`` and optax on the same draw, float64 to 1e-9; the
on-device NaN guard, which keeps every parameter and every optimizer-state
tensor bit for bit (mirroring ``tests/test_model_fit.py:144,154``); the
live tensors keeping their storage over steps, a rewind, a restore and a
snapshot load, one written with an int count included; the graph cache's
stamps; the bench's helpers at 8x8 against root ``bench.py``'s.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as root_bench
import normflow__tpu_torch as nt
from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of
from normflow__tpu_torch import bench
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.elementwise import DistConvertor
from normflow__tpu_torch.models.priors import NormalPrior
from normflow__tpu_torch.training import optim
from normflow__tpu_torch.utils.graphs import GraphCache
from normflow__tpu_torch.utils.transplant import jax_leaf_order
from normflow__tpu_torch.zoo import build_phi4_model
from test_torch_flagship import twin_models

F64 = dict(dtype=torch.float64, device="cpu")
QUIET = dict(print_stride=None)
HP = dict(lr=0.01, weight_decay=0.0)


def _zerodim_model(seed=5):
    return nt.Model(net_=DistConvertor(10, **F64),
                    prior=NormalPrior(shape=(1,), **F64),
                    action=ScalarPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5),
                    seed=seed)


def _live(fit):
    """The fitter's live tensors: parameters, then optimizer state."""
    return fit.params + optim.state_leaves(fit.opt_state)


def _bits(ts):
    return [t.detach().clone().view(torch.int64) for t in ts]


def test_flagship_guarded_step_matches_jax_and_optax(rng):
    """One step of the bench's optimizer (clip 25, AdamW lr 3e-3 x cosine
    to 0.05 over 10 steps, weight decay 1e-4) on the same draw, after two
    earlier steps, so the count is 2: the port's device-committed step
    against ``jax.value_and_grad`` of the JAX fitter's path-gradient loss
    and the optax chain, float64."""
    jmodel, model = twin_models(rng, jnp.float64, torch.float64)
    fit = model.fit
    fit(n_epochs=0, batch_size=8, hyperparam=dict(lr=3e-3,
                                                  weight_decay=1e-4),
        scheduler=nt.cosine_decay_schedule(1.0, decay_steps=10, alpha=0.05),
        grad_estimator="path", clip_grad_norm=25.0, checkpoint_dict=QUIET)
    sched = optax.cosine_decay_schedule(1.0, decay_steps=10, alpha=0.05)
    jtx = optax.chain(optax.clip_by_global_norm(25.0),
                      optax.adamw(lambda s: 3e-3 * sched(s),
                                  weight_decay=1e-4))
    jnet, jstate = jmodel.net_, None
    jstate = jtx.init(jnet)
    xs = [rng.standard_normal((8, 8, 8)) for _ in range(3)]

    def loss_of(net, x):  # normflow__tpu/training/fitter.py:250-268
        xj = jnp.asarray(x)
        y, _ = net.forward(xj)
        x_inv, mlogj = jax.tree_util.tree_map(jax.lax.stop_gradient,
                                              net).backward(y)
        logq = jmodel.prior.log_prob(x_inv) + mlogj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    for x in xs:
        want_loss, grads = jax.value_and_grad(loss_of)(jnet, x)
        upd, jstate = jtx.update(grads, jstate, jnet)
        jnet = optax.apply_updates(jnet, upd)
        tx = torch.from_numpy(x)
        loss, _ = fit._step(tx, model.prior.log_prob(tx))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                                   atol=1e-10)
    assert fit.opt_state[1][0]["count"].dtype == torch.float64
    assert float(fit.opt_state[1][0]["count"]) == 3.0
    want = leaves_of(jnet)
    got = {str(i): p.detach().numpy() for i, (_, _, p) in
           enumerate(jax_leaf_order(model.net_))}
    for k in want:
        w = np.asarray(want[k])
        if got[k].ndim == 4:  # OIHW -> HWIO
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-9,
                                   err_msg=f"leaf {k}")


class _NaNAction(ScalarPhi4Action):
    def action(self, cfgs):  # a NaN loss
        return torch.sum(cfgs, dim=1) * float("nan")


class _InfGradAction(ScalarPhi4Action):
    def action(self, cfgs):
        # sqrt(0) = 0 is finite; its gradient inf * 0 is NaN
        return torch.sqrt(torch.sum(cfgs, dim=1) * 0.0)


@pytest.mark.parametrize("evil", [_NaNAction, _InfGradAction])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_guard_keeps_params_and_state_bit_for_bit(evil, clip):
    """After 5 healthy steps (a count of 5, moments not zero), steps whose
    loss is NaN, or finite with a non-finite gradient, leave every
    parameter and every optimizer-state tensor as it was, bit for bit,
    and the losses they report are what they computed."""
    model = _zerodim_model()
    fit = model.fit
    fit(n_epochs=5, batch_size=16, hyperparam=HP, clip_grad_norm=clip,
        checkpoint_dict=QUIET)
    count = optim.state_leaves(fit.opt_state)[0]
    assert float(count) == 5.0
    before = _bits(_live(fit))
    model.action = evil(kappa=0, m_sq=-1.2, lambd=0.5)
    hist = fit.train(3, batch_size=16)
    assert len(hist["loss"]) == 8
    assert np.isfinite(hist["loss"][-1]) == (evil is _InfGradAction)
    for a, b in zip(_bits(_live(fit)), before):
        assert torch.equal(a, b)
    assert all(bool((t != 0).any()) for t in optim.state_leaves(
        fit.opt_state)[1:])  # the moments are not zero


def test_live_tensors_keep_their_storage(tmp_path):
    """The parameters and the optimizer state are the same tensors over
    steps, a rewind, a restore, a snapshot load, and the load of a
    snapshot whose counts are ints (the earlier format)."""
    model = _zerodim_model()
    fit = model.fit
    path = os.path.join(tmp_path, "snap.E0.pt")
    fit(n_epochs=20, batch_size=32, save_every=10, hyperparam=HP,
        steps_per_call=5, checkpoint_dict=dict(QUIET, snapshot_path=path),
        rewind_on_spike=10.0)
    ptrs = [t.data_ptr() for t in _live(fit)]
    lr_scale = fit._lr_scale_t

    real, calls = fit._segment, []

    def spiking(n_steps):  # the second segment reports a spike
        calls.append(n_steps)
        out = real(n_steps)
        return out + 1e4 if len(calls) == 2 else out

    fit._segment = spiking
    fit.rewind_lr_backoff = 0.5
    hist = fit.train(15, batch_size=32, steps_per_call=5)
    assert hist["rewinds"] == [10] and float(fit._lr_scale_t) == 0.5
    assert fit._lr_scale_t is lr_scale
    assert [t.data_ptr() for t in _live(fit)] == ptrs

    fit._restore(fit._state_copy())
    assert [t.data_ptr() for t in _live(fit)] == ptrs

    snap = os.path.join(tmp_path, "snap.E20.pt")
    saved = torch.load(snap, weights_only=True)
    assert saved["opt_state"][0]["count"].dtype == torch.float64
    fit._load_snapshot(snap)
    assert [t.data_ptr() for t in _live(fit)] == ptrs
    assert float(fit.opt_state[0]["count"]) == 20.0

    old = dict(saved)  # the earlier format: the counts as ints
    old["opt_state"] = ({**saved["opt_state"][0], "count": 7}, (),
                        {"count": 7})
    old_path = os.path.join(tmp_path, "old.E7.pt")
    torch.save(old, old_path)
    fit._load_snapshot(old_path)
    assert [t.data_ptr() for t in _live(fit)] == ptrs
    assert [float(c) for c in (fit.opt_state[0]["count"],
                               fit.opt_state[2]["count"])] == [7.0, 7.0]
    for a, b in zip(fit.opt_state[0]["mu"], saved["opt_state"][0]["mu"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="structure"):
        optim.assign_(fit.opt_state, saved["opt_state"][:2])


def test_logqp_stream_body_continues_the_generator():
    """On the CPU ``logqp_stream`` runs its batch body eagerly: the stream
    is the bodies' outputs from the same generator state, in order."""
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device="cpu", dtype=torch.float64)
    model.seed(3)
    got = model.posterior.logqp_stream(3, 5)
    model.seed(3)
    want = torch.cat([model.posterior.logqp_batch(5, model.generator)
                      for _ in range(3)])
    assert torch.equal(got, want)


def test_graph_cache_stamps():
    """A graph is kept while its stamp holds: weights loaded in place keep
    the stamp; a swapped net or a weight given new storage clears every
    graph of the old stamp."""
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device="cpu")

    def stamp():
        return (model.net_, model.prior, model.action,
                *(p.data_ptr() for p in model.net_.parameters()))

    cache, made = GraphCache(), []

    def make():
        made.append(1)
        return len(made)

    assert cache.get(4, stamp(), make) == 1
    assert cache.get(4, stamp(), make) == 1
    assert cache.get(8, stamp(), make) == 2 and len(cache) == 2
    model.net_.load_state_dict(build_phi4_model(
        (8, 8), knots=4, hidden=(4,), n_layers=2, device="cpu",
        seed=1).net_.state_dict())
    assert cache.get(4, stamp(), make) == 1
    p = next(model.net_.parameters())
    p.data = p.data.clone()
    assert cache.get(4, stamp(), make) == 3 and len(cache) == 1
    model.net_ = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                                  device="cpu").net_
    assert cache.get(4, stamp(), make) == 4 and len(cache) == 1


@pytest.fixture(scope="module")
def tiny():
    return build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                            device="cpu")


def test_bench_bootstrap_matches_root_bench():
    logqp = np.random.default_rng(0).normal(size=512) * 2.0
    got = bench.bootstrap_ess_err(logqp, n_boot=30, seed=5)
    want = root_bench.bootstrap_ess_err(logqp, n_boot=30, seed=5)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got == bench.bootstrap_ess_err(logqp, n_boot=30, seed=5) > 0


def test_bench_autotune_picks_the_fastest(tiny, monkeypatch):
    seen = []
    orig = tiny.posterior.logqp_stream

    def spy(iters, batch, generator=None):
        seen.append(iters)
        return orig(iters, batch, generator)

    monkeypatch.setattr(tiny.posterior, "logqp_stream", spy)
    best, table = bench.autotune_batch(tiny, candidates=(4, 8), iters=3,
                                       reps=2)
    assert set(table) == {4, 8} and best in table
    assert table[best] == max(table.values())
    assert all(r > 0 and np.isfinite(r) for r in table.values())
    assert set(seen) == {3} and len(seen) == 2 * (1 + 2)


def test_bench_reps_draw_from_distinct_seeds(tiny):
    seeds = bench.rep_seeds(0, 3)
    assert len(set(seeds)) == 3
    streams = []
    orig = bench._timed_stream

    def keep(model, iters, batch, seed):
        out = orig(model, iters, batch, seed)
        streams.append((seed, out[1]))
        return out

    bench._timed_stream = keep
    try:
        times, last = bench.time_reps({"arm": tiny}, 2, 4, seeds)
    finally:
        bench._timed_stream = orig
    times, last = times["arm"], last["arm"]
    assert len(times) == 3 and torch.equal(last, streams[-1][1])
    timed = streams[1:]  # after the warm-up
    assert [s for s, _ in timed] == seeds
    for i in range(3):
        for j in range(i):
            assert not torch.equal(timed[i][1], timed[j][1])
    tiny.seed(seeds[1])  # a repetition is its seed's stream
    assert torch.equal(tiny.posterior.logqp_stream(2, 4), timed[1][1])


# root bench.py's keys (l.399-435) that the port reports; the roofline and
# flops keys are TPU/XLA-only
ROOT_KEYS = {"metric", "value", "unit", "vs_baseline", "value_err",
             "raw_samples_per_sec", "timing_spread_s", "ess", "ess_err",
             "accept_rate", "accept_rate_err", "train_epochs", "n_layers",
             "grad_estimator", "sampling_backend", "backend_medians_s",
             "backend_eff_per_s", "train_time_s", "platform",
             "sampling_batch", "knots", "rng_impl", "baseline"}


def test_bench_prints_one_json_line_with_the_keys():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench.main(["--device", "cpu", "--lat", "8", "--n_layers",
                          "2", "--knots", "4", "--hidden", "4",
                          "--train_epochs", "3", "--train_batch", "8",
                          "--sample_iters", "2", "--batch", "8", "--reps",
                          "2"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == out
    assert ROOT_KEYS <= set(out)
    assert {"train_steps_per_s", "card", "idle_share_sample_replay",
            "idle_share_train_replay", "rep_seeds"} <= set(out)
    assert out["platform"] == "cpu" and out["card"] is None
    assert out["idle_share_train_replay"] is None  # measured on the card
    assert 0 < out["ess"] <= 1 and 0 <= out["accept_rate"] <= 1
    assert len(out["timing_spread_s"]) == 2 and out["sampling_batch"] == 8
