"""Port parity of the slice as a whole, on the CPU: the reference's 8x8
affine example and the unpacked flagship.

``examples/scalar_affine.py``'s model and ``build_phi4_model(packed=False)``
are built at narrow widths in both packages, the JAX leaves are perturbed
with seeded numpy noise and transplanted; per sample ``y``, ``logq`` and
``logp`` agree to 1e-9 in float64.  At the unpacked shape in float32, one
coupling's conditioner output from the JAX model goes through the JAX
package's Pallas coupling kernel in interpret mode, which the port's
coupling must match to 1e-4.  One guarded training step with the example's
``param_groups`` matches ``jax.value_and_grad`` and the JAX fitter's optax
chain to 1e-9, a 20-step CPU fit of the example at full size lowers the
loss, and the port's jackknife equals ``scripts/parity_observables.py``'s.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflow__tpu as jnf
from normflow__tpu.ops.kernels.spline_coupling import rqs_transform_fused
from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
import normflow__tpu_torch as nt
from normflow__tpu_torch.examples import scalar_affine as affine
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.priors import NormalPrior
from normflow__tpu_torch.utils.transplant import jax_leaf_order, load_jax_leaves
from normflow__tpu_torch.zoo import build_phi4_model
from test_torch_flagship import perturbed_leaves

ROOT = Path(__file__).resolve().parents[1]
LAT = (8, 8)
NARROW = dict(n_layers=2, hidden_sizes=(4,), knots0_len=4, knots1_len=5,
              knots2_len=6, knots4_len=6)
ACTION = dict(kappa=0.67, m_sq=-4 * 0.67, lambd=0.5)
QUIET = dict(print_stride=None)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_affine = _load("jax_scalar_affine_example", "examples/scalar_affine.py")
parity_script = _load("parity_observables_script",
                      "scripts/parity_observables.py")


def _twins(rng, which, jdtype=jnp.float64, tdtype=torch.float64):
    """The JAX model and its port with the same perturbed weights."""
    if which == "affine":
        jnet = jax_affine.assemble_net(lat_shape=LAT, key=jax.random.key(0),
                                       **NARROW)
        jmodel = jnf.Model(net_=jnet, prior=jnf.prior.NormalPrior.build(
            shape=LAT), action=jnf.action.ScalarPhi4Action(**ACTION))
        model = nt.Model(
            net_=affine.assemble_net(lat_shape=LAT, dtype=tdtype,
                                     device="cpu", **NARROW),
            prior=NormalPrior(shape=LAT, dtype=tdtype, device="cpu"),
            action=ScalarPhi4Action(**ACTION))
    else:
        small = dict(lat_shape=LAT, knots=4, hidden=(4,), n_layers=2,
                     packed=False)
        jmodel = jax_build(**small, dtype=jdtype)
        model = build_phi4_model(**small, dtype=tdtype, device="cpu")
    leaves = perturbed_leaves(jmodel.net_, rng)
    load_jax_leaves(model.net_, leaves)
    jmodel.net_ = restore_into(jmodel.net_, leaves)
    return jmodel, model


@pytest.mark.parametrize("which", ["affine", "unpacked"])
def test_logq_logp_and_samples_agree(rng, which):
    """The flow's output ``y`` for the same prior draw, ``logq`` and
    ``logp``, and the inverse ``log_prob``, to 1e-9 in float64."""
    jmodel, model = _twins(rng, which)
    x = rng.standard_normal((6, *LAT))
    jy, jlogj = jmodel.net_.forward(jnp.asarray(x))
    jlogq = jmodel.prior.log_prob(jnp.asarray(x)) - jlogj
    with torch.no_grad():
        y, logj = model.net_.forward(torch.from_numpy(x))
        logq = model.prior.log_prob(torch.from_numpy(x)) - logj
    for got, want in ((y, jy), (logq, jlogq),
                      (-model.action(y), -jmodel.action(jy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)
    y2 = rng.standard_normal((6, *LAT))
    np.testing.assert_allclose(
        model.posterior.log_prob(torch.from_numpy(y2)).numpy(),
        np.asarray(jmodel.posterior.log_prob(jnp.asarray(y2))), rtol=0,
        atol=1e-9)
    x_err, logj_err = nt.backward_sanitychecker(model, n_samples=4,
                                                verbose=False)
    assert x_err <= 1e-10 and logj_err <= 1e-10


@pytest.mark.parametrize("inverse", [False, True])
def test_unpacked_coupling_matches_the_pallas_kernel(rng, inverse):
    """float32 at the unpacked shape, S = 64 sites at 8x8: the JAX model's
    first conditioner output, through ``rqs_transform_fused`` in interpret
    mode and purified by the mask, against the port's coupling transform
    on the same partitions."""
    jmodel, model = _twins(rng, "unpacked", jnp.float32, torch.float32)
    jflow, flow = jmodel.net_.flows[2], model.net_.flows[2]
    x = rng.standard_normal((4, *LAT)).astype(np.float32)
    jx0, jx1 = jflow.mask.split(jnp.asarray(x))
    out = jflow.nets[0](jflow.preprocess_fz(jx1))        # (B, 8, 8, 3m-2)
    assert out.shape == (4, *LAT, 10) and out.dtype == jnp.float32
    e = dict(jflow.extrap)
    fx, logg = rqs_transform_fused(
        jx0, out, xlim=jflow.xlim, ylim=jflow.ylim, left=e.get("left"),
        right=e.get("right"), inverse=inverse, interpret=True)
    want = [jflow.mask.purify(t, channel=0) for t in (fx, logg)]
    x0, x1 = flow.mask.split(torch.from_numpy(x))
    with torch.no_grad():
        got = flow._transform(x0, x1, 0, flow.nets[0], inverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_guarded_step_with_param_groups_matches_jax_and_optax(rng):
    """Three steps of the example's optimizer (AdamW lr 1e-3, weight decay
    1e-4 on the PSD block and the convertors, 1e-2 on the couplings) on
    the same draws: the JAX fitter's own optax chain, float64."""
    jmodel, model = _twins(rng, "affine")
    groups = [dict(g) for g in affine.PARAM_GROUPS]
    model.fit(n_epochs=0, batch_size=8, hyperparam=dict(lr=1e-3),
              param_groups=groups, checkpoint_dict=QUIET)
    jfit = jmodel.fit
    jfit.hyperparam.update(lr=1e-3)
    jtx = jfit._build_optimizer("adamw", None, groups)
    jnet = jmodel.net_
    jstate = jtx.init(jnet)

    def loss_of(net, x):  # the reparametrisation estimator
        xj = jnp.asarray(x)
        y, logj = net.forward(xj)
        logq = jmodel.prior.log_prob(xj) - logj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    @jax.jit
    def jax_step(net, state, x):
        loss, grads = jax.value_and_grad(loss_of)(net, x)
        upd, state = jtx.update(grads, state, net)
        return loss, optax.apply_updates(net, upd), state

    for _ in range(3):
        x = rng.standard_normal((8, *LAT))
        want_loss, jnet, jstate = jax_step(jnet, jstate, x)
        tx = torch.from_numpy(x)
        loss, _ = model.fit._step(tx, model.prior.log_prob(tx))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                                   atol=1e-10)
    want = leaves_of(jnet)
    got = [p.detach().numpy() for _, _, p in jax_leaf_order(model.net_)]
    assert len(got) == len(want)
    for i, g in enumerate(got):
        w = np.asarray(want[str(i)])
        if g.ndim == 4:  # OIHW -> HWIO
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9,
                                   err_msg=f"leaf {i}")


def test_affine_example_fit_lowers_the_loss(capsys):
    """``main`` at the reference's full size for 20 steps on the CPU."""
    model = affine.main(n_epochs=20, print_stride=10, device="cpu",
                        snapshot_path=None)
    loss = np.asarray(model.fit.train_history["loss"])
    assert loss.shape == (20,) and np.isfinite(loss).all()
    assert loss[-5:].mean() < loss[:5].mean() - 0.5
    assert "number of model parameters" in capsys.readouterr().out
    # n_devices > 1 runs one process per device: without a process group
    # (torchrun's environment or spawnprocesses) it raises
    with pytest.raises(ValueError, match="RANK"):
        affine.main(n_devices=2, device="cpu")


def test_jackknife_equals_the_parity_script(rng):
    samples = rng.standard_normal((1000, 4, 4)) * 0.7 + 0.2
    samples[1:] += 0.5 * samples[:-1]  # some autocorrelation
    for n_bins in (20, 7):
        got = affine.observables(samples, n_bins=n_bins)
        want = parity_script.observables(samples, n_bins=n_bins)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


def test_entry_points_need_the_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for build in (lambda: build_phi4_model(packed=False),
                  lambda: affine.assemble_net(lat_shape=LAT)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
