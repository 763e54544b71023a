"""Port parity of training: losses, optimizers, one flagship step, the fitter.

The same numpy inputs go through the JAX package and the port: the nine
losses and the optimizers (AdamW, Adam with L2, SGD, with clipping, weight
decay, a cosine schedule and a parameter group) agree with the JAX
functions and optax to 1e-12 in float64; one training step of an 8x8
flagship with transplanted weights agrees with ``jax.value_and_grad`` of
the JAX fitter's loss (``fitter.py:250-268``) to 1e-10 in the loss and
1e-9 in every gradient leaf, for both gradient estimators.  The rest
mirrors ``tests/test_model_fit.py`` on the port's ``Fitter``.
"""

import contextlib
import io
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of
import normflow__tpu_torch as nt
from normflow__tpu_torch import bench
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.core import FlowList
from normflow__tpu_torch.models.elementwise import DistConvertor, Scale
from normflow__tpu_torch.models.priors import NormalPrior
from normflow__tpu_torch.training import losses, optim
from normflow__tpu_torch.tools import protocol_run
from normflow__tpu_torch.training.checkpoint import snapshot_path_for_epoch
from normflow__tpu_torch.utils.transplant import jax_leaf_grads
from test_torch_flagship import twin_models

LOSSES = ["calc_kl_mean", "calc_kl_var", "calc_corrcoef",
          "calc_direct_kl_mean", "calc_kl_mean_includelogz",
          "calc_least_squares", "calc_minus_logz", "calc_ess",
          "calc_minus_ess"]
F64 = dict(dtype=torch.float64, device="cpu")
QUIET = dict(print_stride=None)


def _zerodim_model(seed=5):
    """The zero-dim example: DistConvertor(10) on one site, kappa = 0."""
    return nt.Model(net_=DistConvertor(10, **F64),
                    prior=NormalPrior(shape=(1,), **F64),
                    action=ScalarPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5),
                    seed=seed)


def _params(model):
    return [p.detach().clone() for p in model.net_.parameters()]


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(rng, name):
    logq = rng.standard_normal(256)
    logp = logq + rng.standard_normal(256) * 0.3
    got = getattr(losses, name)(torch.from_numpy(logq),
                                torch.from_numpy(logp))
    want = getattr(jlosses, name)(jnp.asarray(logq), jnp.asarray(logp))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12,
                               atol=1e-12)
    assert getattr(nt.Fitter, name) is getattr(losses, name)


def test_cosine_decay_schedule_matches_optax():
    want = optax.cosine_decay_schedule(2.0, decay_steps=7, alpha=0.05)
    got = nt.cosine_decay_schedule(2.0, decay_steps=7, alpha=0.05)
    for step in range(10):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-14)
    with pytest.raises(ValueError):
        nt.cosine_decay_schedule(1.0, decay_steps=0)


def _optax_tx(name, lr, wd):
    if name == "adamw":
        return optax.adamw(lr, weight_decay=wd)
    inner = optax.adam(lr) if name == "adam" else optax.sgd(lr)
    return optax.chain(optax.add_decayed_weights(wd), inner)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax(rng, name):
    """Clip -> per-group transform (lr 0.01 with a cosine schedule, and a
    group at lr 0.05), weight decay 0.02, over 3 steps: float64 to 1e-12."""
    shapes = [(3, 4), (5,), (2, 2, 2)]
    labels = ["g0", "g0", "g1"]
    params = [rng.standard_normal(s) for s in shapes]
    steps = [[rng.standard_normal(s) * scale for s in shapes]
             for scale in (3.0, 0.05, 2.0)]  # the middle step is not clipped
    jsched = optax.cosine_decay_schedule(1.0, decay_steps=3, alpha=0.05)
    sched = nt.cosine_decay_schedule(1.0, decay_steps=3, alpha=0.05)
    make = dict(adamw=optim.adamw, adam=optim.adam, sgd=optim.sgd)[name]

    jtx = optax.chain(optax.clip_by_global_norm(1.5), optax.multi_transform(
        {"g0": _optax_tx(name, lambda s: 0.01 * jsched(s), 0.02),
         "g1": _optax_tx(name, lambda s: 0.05 * jsched(s), 0.02)}, labels))
    tx = optim.chain(optim.clip_by_global_norm(1.5), optim.multi_transform(
        {"g0": make(lambda s: 0.01 * sched(s), weight_decay=0.02),
         "g1": make(lambda s: 0.05 * sched(s), weight_decay=0.02)}, labels))

    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jparams), tx.init(tparams)
    for grads in steps:
        jup, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = tx.update([torch.from_numpy(g) for g in grads],
                                tstate, tparams)
        tparams = [p + u for p, u in zip(tparams, tup)]
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_device_count_optimizer_matches_optax_over_20_steps(rng, name):
    """The step counts are float64 scalars on the parameters' device and
    the cosine schedule reads them as tensors: clip 1.5 -> per-group
    transform (lr 0.01 and 0.05 times a cosine decay over 12 steps, so the
    schedule reaches its floor), weight decay 0.02, 20 steps, float64 to
    1e-12 against optax."""
    shapes = [(3, 4), (5,), (2, 2, 2)]
    labels = ["g0", "g1", "g1"]
    params = [rng.standard_normal(s) for s in shapes]
    steps = [[rng.standard_normal(s) * scale for s in shapes]
             for scale in rng.choice([0.05, 3.0], size=20)]
    jsched = optax.cosine_decay_schedule(1.0, decay_steps=12, alpha=0.05)
    sched = nt.cosine_decay_schedule(1.0, decay_steps=12, alpha=0.05)
    make = dict(adamw=optim.adamw, adam=optim.adam, sgd=optim.sgd)[name]
    jtx = optax.chain(optax.clip_by_global_norm(1.5), optax.multi_transform(
        {"g0": _optax_tx(name, lambda s: 0.01 * jsched(s), 0.02),
         "g1": _optax_tx(name, lambda s: 0.05 * jsched(s), 0.02)}, labels))
    tx = optim.chain(optim.clip_by_global_norm(1.5), optim.multi_transform(
        {"g0": make(lambda s: 0.01 * sched(s), weight_decay=0.02),
         "g1": make(lambda s: 0.05 * sched(s), weight_decay=0.02)}, labels))
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jparams), tx.init(tparams)
    counts = [t for t in optim.state_leaves(tstate) if t.dim() == 0]
    assert counts and all(c.dtype == torch.float64 for c in counts)
    for grads in steps:
        jup, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = tx.update([torch.from_numpy(g) for g in grads],
                                tstate, tparams)
        tparams = [p + u for p, u in zip(tparams, tup)]
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                       atol=1e-12)
    assert all(float(c) == 20.0 for c in optim.state_leaves(tstate)
               if c.dim() == 0)


def test_cosine_schedule_reads_the_count_tensor():
    """The schedule of a float64 count tensor: a float64 tensor on the
    count's device, as optax's for a traced count, capped at the decay
    steps."""
    want = optax.cosine_decay_schedule(2.0, decay_steps=7, alpha=0.05)
    got = nt.cosine_decay_schedule(2.0, decay_steps=7, alpha=0.05)
    for step in range(10):
        lr = got(torch.tensor(float(step), dtype=torch.float64))
        assert lr.dtype == torch.float64 and lr.dim() == 0
        np.testing.assert_allclose(float(lr), float(want(step)), rtol=1e-14)


@pytest.mark.parametrize("estimator", ["rep", "path"])
def test_flagship_step_matches_jax(rng, estimator):
    """One step's loss and gradients on the same draw, against
    ``jax.value_and_grad`` of the JAX fitter's loss."""
    jmodel, model = twin_models(rng, jnp.float64, torch.float64)
    x = rng.standard_normal((8, 8, 8))

    def loss_of(net):  # normflow__tpu/training/fitter.py:250-268
        xj = jnp.asarray(x)
        y, logj = net.forward(xj)
        if estimator == "path":
            net_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, net)
            x_inv, mlogj = net_sg.backward(y)
            logq = jmodel.prior.log_prob(x_inv) + mlogj
        else:
            logq = jmodel.prior.log_prob(xj) - logj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    want_loss, want_grads = jax.value_and_grad(loss_of)(jmodel.net_)

    fit = model.fit
    fit.grad_estimator = estimator
    tx = torch.from_numpy(x)
    loss, logq, logp = fit.loss_of(tx, model.prior.log_prob(tx))
    loss.backward()
    assert all(p.requires_grad for p in model.net_.parameters())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=0,
                               atol=1e-10)
    got, want = jax_leaf_grads(model.net_), leaves_of(want_grads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=f"leaf {k}")


def test_flagship_fit_runs_the_bench_protocol():
    """The bench settings (AdamW, cosine schedule, path gradient, clip 25)
    for a few steps of a small float64 flagship."""
    model = twin_models(np.random.default_rng(0), jnp.float64,
                        torch.float64)[1]
    n = 6
    hist = model.fit(n_epochs=n, batch_size=16,
                     hyperparam=dict(lr=3e-3, weight_decay=1e-4),
                     scheduler=nt.cosine_decay_schedule(1.0, decay_steps=n,
                                                        alpha=0.05),
                     grad_estimator="path", clip_grad_norm=25.0,
                     steps_per_call=4, checkpoint_dict=QUIET)
    assert len(hist["loss"]) == n and np.isfinite(hist["loss"]).all()
    assert model.fit.opt_state[1][0]["count"] == n


def test_zerodim_training_hits_reference_targets():
    """As tests/test_model_fit.py: loss <= -1.0, accept >= 0.9 and
    ESS >= 0.95 after 500 epochs at batch 128, lr 0.01."""
    model = _zerodim_model()
    hist = model.fit(n_epochs=500, batch_size=128,
                     hyperparam=dict(lr=0.01, weight_decay=0.0),
                     checkpoint_dict=dict(print_stride=250))
    assert hist["loss"][-1] <= -1.0, hist["loss"][-1]
    assert hist["accept_rate"][-1][0] >= 0.9
    assert hist["ess"][-1] >= 0.95
    assert len(hist["ess"]) == 4  # epochs 1, 10, 250, 500


def test_path_estimator_warns_for_other_losses():
    model = _zerodim_model()
    with pytest.warns(UserWarning, match="unbiased only"):
        model.fit(n_epochs=2, batch_size=16, loss_fn=losses.calc_kl_var,
                  grad_estimator="path", checkpoint_dict=QUIET)


def test_keyed_actions_are_refused():
    """Keyed actions were refused until the fermion sector was ported; now
    the fitter keys one with the model's generator, once per ``fit`` call,
    for its training steps only."""
    model = _zerodim_model()
    action = model.action
    keys = []
    action.with_key = lambda key: keys.append(key) or action
    hist = model.fit(n_epochs=3, checkpoint_dict=QUIET)
    assert keys == [model.generator] and len(hist["loss"]) == 3
    model.fit(n_epochs=1, checkpoint_dict=QUIET)
    assert keys == [model.generator] * 2


@pytest.mark.parametrize("kw", [
    dict(loss_fn=losses.calc_kl_var),
    dict(param_groups=[{"ind": [1], "hyper": dict(lr=0.02)}],
         optimizer_class="adam"),
    dict(optimizer_class="sgd", clip_grad_norm=1.0),
])
def test_fit_options_train(kw):
    model = _zerodim_model()
    hist = model.fit(n_epochs=30, batch_size=64,
                     hyperparam=dict(lr=0.01, weight_decay=0.0),
                     checkpoint_dict=QUIET, **kw)
    assert len(hist["loss"]) == 30 and np.isfinite(hist["loss"]).all()


def test_nan_guard_keeps_params():
    model = _zerodim_model()
    model.fit(n_epochs=5, batch_size=16,
              hyperparam=dict(lr=1e8, weight_decay=0.0),
              checkpoint_dict=QUIET)
    assert all(bool(torch.isfinite(p).all())
               for p in model.net_.parameters())


def test_nan_guard_catches_nonfinite_grads_with_finite_loss():
    """A finite loss with a non-finite gradient leaves params and the
    optimizer state untouched."""

    class EvilAction(ScalarPhi4Action):
        def action(self, cfgs):
            # sqrt(0) = 0 is finite; its gradient inf * 0 is NaN
            return torch.sqrt(torch.sum(cfgs, dim=1) * 0.0)

    model = nt.Model(net_=FlowList([Scale(**F64)]),
                     prior=NormalPrior(shape=(1,), **F64),
                     action=EvilAction(), seed=3)
    before = _params(model)
    hist = model.fit(n_epochs=3, batch_size=8, hyperparam=dict(lr=0.1),
                     checkpoint_dict=QUIET)
    assert np.isfinite(hist["loss"]).all()
    for b, a in zip(before, _params(model)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert model.fit.opt_state[0]["count"] == 0


def test_snapshot_roundtrip_and_bit_exact_resume(tmp_path):
    model = _zerodim_model()
    path = os.path.join(tmp_path, "run", "snap.E0.pt")
    cd = dict(print_stride=None, snapshot_path=path)
    hp = dict(lr=0.01, weight_decay=0.0)
    hist = model.fit(n_epochs=40, batch_size=64, save_every=20,
                     hyperparam=hp, checkpoint_dict=cd)
    assert sorted(os.listdir(os.path.join(tmp_path, "run"))) == \
        ["snap.E20.pt", "snap.E40.pt"]
    assert snapshot_path_for_epoch("a.b/c.E3.pt", 7) == "a.b/c.E7.pt"

    resume = os.path.join(tmp_path, "resume", "snap.E20.pt")
    os.makedirs(os.path.dirname(resume))
    shutil.copy(os.path.join(tmp_path, "run", "snap.E20.pt"), resume)
    model2 = _zerodim_model(seed=99)
    hist2 = model2.fit(n_epochs=20, batch_size=64, hyperparam=hp,
                       checkpoint_dict=dict(cd, snapshot_path=resume))
    assert model2.fit.checkpoint_dict["epochs_run"] == 20
    assert hist2["loss"] == hist["loss"][20:]
    for a, b in zip(_params(model2), _params(model)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert os.path.exists(os.path.join(tmp_path, "resume", "snap.E40.pt"))


def test_steps_per_call_history_length():
    model = _zerodim_model()
    hist = model.fit(n_epochs=37, batch_size=32,
                     hyperparam=dict(lr=0.01, weight_decay=0.0),
                     checkpoint_dict=QUIET, steps_per_call=10)
    assert len(hist["loss"]) == 37


def test_rewind_on_spike_healthy_run_is_transparent():
    kw = dict(n_epochs=30, batch_size=32, steps_per_call=10,
              hyperparam=dict(lr=0.01, weight_decay=0.0),
              checkpoint_dict=QUIET)
    h1 = _zerodim_model().fit(**kw)
    h2 = _zerodim_model().fit(rewind_on_spike=1e6, **kw)
    assert h1["loss"] == h2["loss"]
    assert h2.get("rewinds", []) == []


def _armed_fitter(spiking, backoff=None):
    """A zero-dim fitter whose segments ``spiking`` (1-based) report a
    finite divergence the NaN guard cannot see.  Records the params and
    the lr scale at the start of every segment."""
    model = _zerodim_model()
    fit = model.fit
    fit(n_epochs=0, hyperparam=dict(lr=0.01, weight_decay=0.0),
        checkpoint_dict=QUIET, rewind_on_spike=10.0,
        rewind_lr_backoff=backoff)
    real, seen = fit._segment, []

    def fake(n_steps):
        seen.append((_params(model), float(fit._lr_scale_t)))
        out = real(n_steps)
        return out + 1e4 if len(seen) in spiking else out

    fit._segment = fake
    return model, fit, seen


def test_rewind_on_spike_rewinds_and_reseeds():
    model, fit, seen = _armed_fitter(spiking=(2,))
    hist = fit.train(30, batch_size=32, steps_per_call=10)
    assert hist["rewinds"] == [20]
    assert len(hist["loss"]) == 20 and max(hist["loss"]) < 1e3
    assert len(seen) == 3
    # the third segment starts from the state after the first
    for a, b in zip(seen[2][0], seen[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert model.generator.initial_seed() == 5 + 7919


def test_rewind_lr_backoff_shrinks_updates():
    model, fit, seen = _armed_fitter(spiking=(2, 3), backoff=0.5)
    hist = fit.train(40, batch_size=32, steps_per_call=10)
    assert len(hist["rewinds"]) == 2
    assert [s for _, s in seen] == [1.0, 1.0, 0.5, 0.25]
    assert float(fit._lr_scale_t) == 0.25
    assert model.generator.initial_seed() == 5 + 7919 + 7920

    # the scale is exact: half the step from the same state and draw
    x, logr = model.prior.sample_(32, model.generator)
    start = (_params(model), fit._state_copy()[1])
    deltas = []
    for scale in (1.0, 0.5):
        fit._restore((start[0], start[1]))
        fit._lr_scale_t.fill_(scale)
        fit._step(x, logr)
        deltas.append([a - b for a, b in zip(_params(model), start[0])])
    for d1, dh in zip(*deltas):
        torch.testing.assert_close(dh, 0.5 * d1, rtol=1e-12, atol=1e-15)


# --------------------------------------------------------------------- #
# the bench's halves and the protocol run in pieces
# --------------------------------------------------------------------- #
def _bench_args(*extra):
    """The bench's settings for the 8x8 flagship at its widths (4
    couplings, 8 knots, hidden 24, 24) on the CPU, batch 16."""
    return bench.parse_args(["--device", "cpu", "--lat", "8",
                             "--train_batch", "16", "--steps_per_call", "8",
                             *extra])


def test_protocol_run_resumes_bit_for_bit(tmp_path):
    """``tools/protocol_run`` cut into 2 x 24 steps, each piece in a fresh
    ``Model`` from the snapshot the other left, against 48 unbroken steps
    of the bench's training half (cosine over the 48, path gradient, clip
    25): the losses, parameters, optimizer state and generator state bit
    for bit."""
    unbroken, _ = bench.train(_bench_args("--train_epochs", "48"))
    d = str(tmp_path / "protocol")
    pieces = [protocol_run.train(d, _bench_args(), total=48, max_steps=24,
                                 save_every=24, stream=(1, 16))
              for _ in range(2)]
    assert [n for _, n in pieces] == [24, 48]
    model = pieces[1][0]
    assert model is not pieces[0][0]
    losses = sum((m.fit.train_history["loss"] for m, _ in pieces), [])
    assert losses == unbroken.fit.train_history["loss"]
    assert len(losses) == 48
    for a, b in zip(_params(model), _params(unbroken)):
        assert torch.equal(a, b)
    got, want = (optim.state_leaves(m.fit.opt_state)
                 for m in (model, unbroken))
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    assert float(optim.state_leaves(model.fit.opt_state)[0]) == 48
    assert torch.equal(model.generator.get_state(),
                       unbroken.generator.get_state())
    traj = protocol_run.read_trajectory(d)
    assert [(r["step"], r["steps"], r["call"]) for r in traj] == \
        [(24, 24, 1), (48, 24, 2)]
    assert all(0 < r["ess"] <= 1 and r["steps_per_s"] > 0 for r in traj)
    assert protocol_run.newest_snapshot(d) == (
        os.path.join(d, "flagship.E48.pt"), 48)
    # the count reached: a third call trains nothing
    assert protocol_run.train(d, _bench_args(), total=48,
                              save_every=24)[1] == 48


def test_protocol_run_pieces_fit_the_budget():
    piece = protocol_run._piece
    # to the next multiple of save_every, within the total and the cap
    assert piece(0, 96000, 4000, 1000, None, math.inf, 96000) == 4000
    assert piece(1000, 96000, 4000, 1000, 40.0, math.inf, 96000) == 3000
    assert piece(94000, 96000, 4000, 1000, None, math.inf, 96000) == 2000
    assert piece(0, 48, 24, 8, None, math.inf, 24) == 24
    # a budget: one segment while the rate is unknown, then whole
    # segments that fit at the measured rate
    assert piece(0, 96000, 4000, 1000, None, 3600.0, 96000) == 1000
    assert piece(1000, 96000, 4000, 1000, 44.0, 50.0, 96000) == 2000
    assert piece(4000, 96000, 4000, 1000, 44.0, 20.0, 96000) == 0
    assert protocol_run.newest_snapshot("/nonexistent") == (None, 0)
    with pytest.raises(ValueError, match="multiple"):
        protocol_run.train("/nonexistent", _bench_args(), save_every=12)


def test_bench_measuring_half_gives_mains_keys():
    """The bench split in two: ``measure`` on a trained ``device="cpu"``
    model gives the record ``main`` gives, key for key."""
    small = ("--n_layers", "2", "--knots", "4", "--hidden", "4",
             "--train_epochs", "3", "--sample_iters", "2", "--batch", "8",
             "--reps", "2")
    with contextlib.redirect_stdout(io.StringIO()):
        whole = bench.main(["--device", "cpu", "--lat", "8",
                            "--train_batch", "8", *small])
        args = _bench_args(*small)
        model, seconds = bench.train(args)
        out = bench.measure(model, args, seconds)
    assert set(out) == set(whole)
    assert out["train_epochs"] == 3 and out["platform"] == "cpu"
    assert 0 < out["ess"] <= 1 and out["sampling_batch"] == 8


def test_protocol_run_main_measures_when_done(tmp_path, monkeypatch):
    """The tool's command line at a small size on the CPU (the protocol's
    length cut to 8 steps), after a first call that trained half of it:
    it trains the rest from the snapshot, runs the samplers and prints
    the bench's record last."""
    monkeypatch.setattr(protocol_run, "TOTAL", 8)
    d = str(tmp_path / "p")
    argv = ["--dir", d, "--device", "cpu", "--lat", "8",
            "--n_layers", "2", "--knots", "4", "--hidden", "4",
            "--train_batch", "8", "--steps_per_call", "4",
            "--sample_iters", "2", "--batch", "8", "--reps", "2"]
    own, args = protocol_run.parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        protocol_run.train(d, args, total=8, max_steps=4, save_every=4,
                           stream=(1, 8))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = protocol_run.main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == out and out["train_epochs"] == 8
    assert any("accept rates on the trained weights" in l for l in lines)
    assert "blocked_mcmc" in "".join(lines)
    assert [r["step"] for r in protocol_run.read_trajectory(d)] == [4, 8]
