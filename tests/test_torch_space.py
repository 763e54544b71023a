"""The port's lattice (``space``) sharding on real gloo groups on the CPU.

Two spawned jobs (``ModelDeviceHandler.spawnprocesses``, one thread per
rank) run ``tests/_torch_space_worker.run_rank``: four ranks under
``use_mesh(axes={"data": 2, "space": 2})`` and two under ``{"data": 1,
"space": 2}``.  Every draw is numpy from one seed; each rank takes its
share of the batch and its slab of the lattice rows, and each sharded run
is held against one rank's run on the whole draws, in float64:

- JAX's two dp x sp tests (``tests/test_parallel.py:133-191``: the packed
  flagship coupling with ``RowParityFeature`` and the affine model over
  ``EvenOddMask``, 8x8): the loss trajectory of a fit equals the port's
  one-rank fit to 1e-10 and the JAX package's unsharded fit on the same
  draws with the same weights to 1e-10, the first step's reduced gradients
  JAX's to 1e-9 (``test_dp_grads_match_jax_sharded_step``'s tolerances);
- the small flagship with its PSD block under 1 x 2 and 2 x 2: logq, logp,
  the loss and the gradients, for both estimators, to 1e-10;
- ``sample_chain`` and ``sample_parallel_chains`` under 2 x 2 equal to the
  unsharded samplers on fed draws, and the blocked sampler's sweep (whole
  lattice, no slab) equal to the unsharded sweep;
- ``CircularConv`` on slabs (dilated, an even kernel, 4-D): outputs and
  input gradients equal the whole lattice's;
- the action's one-way halo: the gradient equals the whole lattice's where
  the cotangent is the same on the space ranks, and misses it where it is
  not;
- the axis-order rule, and the ``ValueError`` of a halo deeper than the
  lattice and of a packed mask of odd extents (a lattice that does not
  split evenly shards as XLA shards it: ``tests/test_torch_uneven_slabs.py``).

The slab kernels' plain versions are held against the whole-lattice plain
action and force on numpy inputs without a group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflow__tpu as nf
from normflow__tpu.models import PackedEvenOddMask as JPacked
from normflow__tpu.models.nets import RowParityFeature as JRowParity
from normflow__tpu.nn import (AffineCoupling_, ConvAct, DistConvertor_,
                              ModuleList_, RQSplineCoupling_)
from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch.models.masks import PackedEvenOddMask
from normflow__tpu_torch.ops.kernels import phi4
from normflow__tpu_torch.parallel import space

import _torch_space_worker as W
from test_torch_flagship import perturbed_leaves

LAT = W.LAT
B, FIT_B = 16, 32
AXES4, AXES2 = {"data": 2, "space": 2}, {"data": 1, "space": 2}
TOL, GRAD_TOL = 1e-10, 1e-9
J_ACTION = dict(kappa=0.67, m_sq=-2.68, lambd=0.5)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def jax_packed():
    """The JAX test's packed coupling model (``test_parallel.py:146-169``)."""
    m = 4
    keys = jax.random.split(jax.random.key(13), 2)
    nets = tuple(JRowParity(net=ConvAct.build(
        k, 2, 3 * m - 2, kernel_size=3, conv_dim=2, hidden_sizes=(4,),
        acts=("tanh", None), bias=False)) for k in keys)
    net_ = ModuleList_(flows=(
        DistConvertor_.build(8, symmetric=True, smooth=True),
        RQSplineCoupling_.build(
            nets, mask=JPacked(shape=LAT), xlim=(-4.0, 4.0),
            ylim=(-4.0, 4.0), extrap={"left": "linear", "right": "linear"}),
    ))
    return _jax_model(net_, 13)


def jax_affine():
    """The JAX test's affine model (``test_parallel.py:17-29``)."""
    key = jax.random.key(7)
    nets = tuple(ConvAct.build(k, 1, 2, kernel_size=3, conv_dim=2,
                               hidden_sizes=(4,), acts=("tanh", None),
                               bias=False)
                 for k in jax.random.split(key, 2))
    net_ = ModuleList_(flows=(AffineCoupling_(
        nets=nets, mask=nf.mask.EvenOddMask(shape=LAT)),))
    return _jax_model(net_, 7)


def _jax_model(net_, seed):
    return nf.Model(net_=net_, prior=nf.prior.NormalPrior.build(shape=LAT),
                    action=nf.action.ScalarPhi4Action(**J_ACTION), seed=seed)


def jax_fit(jmodel, leaves, draws, lr=1e-3, weight_decay=0.01):
    """The JAX fitter's step (``normflow__tpu/training/fitter.py:235-289``,
    reparametrization gradient, AdamW) on the fed draws, unsharded: the
    losses and the first step's gradients."""
    net = restore_into(jmodel.net_, leaves)
    prior, action = jmodel.prior, jmodel.action

    @jax.jit
    def value_and_grad(net, x):
        def loss_of(net):
            y, logj = net.forward(x)
            return jlosses.calc_kl_mean(prior.log_prob(x) - logj,
                                        -action(y))
        return jax.value_and_grad(loss_of)(net)

    tx = optax.adamw(lr, weight_decay=weight_decay)
    state = tx.init(net)
    out, first = [], None
    for x in draws:
        loss, grads = value_and_grad(net, jnp.asarray(x))
        first = leaves_of(grads) if first is None else first
        updates, state = tx.update(grads, state, net)
        net = optax.apply_updates(net, updates)
        out.append(float(loss))
    return out, first


@pytest.fixture(scope="module")
def job():
    """The draws and leaves, the 2 x 2 and 1 x 2 jobs' results, one rank's
    runs on the whole draws and the JAX package's unsharded fits."""
    rng = np.random.default_rng(20261017)
    jmodels = dict(packed=jax_packed(), affine=jax_affine(),
                   flagship=jax_build(**W.SMALL))
    leaves = {k: perturbed_leaves(m.net_, rng) for k, m in jmodels.items()}
    fits = dict(packed=[rng.standard_normal((FIT_B, *LAT))
                        for _ in range(5)],
                affine=[rng.standard_normal((FIT_B, *LAT))
                        for _ in range(6)])

    def rounds(n):
        return [(rng.standard_normal((B, *LAT)), np.log(rng.random(B)))
                for _ in range(n)]

    common = dict(leaves=leaves, x=rng.standard_normal((B, *LAT)),
                  estimators=("rep", "path"))
    job4 = dict(common, axes=AXES4, fits=fits, chain_rounds=rounds(3),
                par_rounds=rounds(3), g=rng.standard_normal(B),
                blocked=(rng.standard_normal((1, *LAT)),
                         rng.standard_normal((2, 4, 16)),
                         np.log(rng.random((2, 4)))),
                order={"space": 2, "data": 2})
    handler = W.flagship().device_handler
    ranks4 = handler.spawnprocesses(W.run_rank, 4, job4)
    convs = [(rng.standard_normal((2, 2, 8, *([4] * (d - 1)))),
              rng.standard_normal((2, 3, 8, *([4] * (d - 1)))))
             for d, _, _ in W.CONV_CASES]
    ranks2 = handler.spawnprocesses(W.run_rank, 2, dict(common, axes=AXES2,
                                                        convs=convs))

    ref = {}
    for kind, draws in fits.items():
        ref[f"fit {kind}"] = W.fit_run(W.attached(kind, leaves[kind], None),
                                       draws)
        ref[f"jax {kind}"] = jax_fit(jmodels[kind], leaves[kind], draws)
    for est in common["estimators"]:
        ref[f"flagship {est}"] = W.grads_of(
            W.attached("flagship", leaves["flagship"], None), common["x"],
            est)
    model = W.attached("flagship", leaves["flagship"], None)
    ref["samplers"] = W.samplers(model, job4["chain_rounds"],
                                 job4["par_rounds"])
    ref["blocked"] = W.blocked(model, *job4["blocked"])
    return dict(job4=job4, ranks4=ranks4, ranks2=ranks2, ref=ref,
                convs=convs)


@pytest.mark.parametrize("kind", ["packed", "affine"])
def test_dp_sp_fit_matches_one_rank_and_jax(job, kind):
    """JAX's ``test_packed_coupling_dp_sp_matches_single_device`` and
    ``test_space_sharded_training_matches_single_device`` on the port: the
    2 x 2 loss trajectory against the port's one-rank fit and the JAX
    unsharded fit on the same draws; every rank ends with the same
    parameters as the one-rank fit."""
    losses, params = job["ranks4"][0][f"fit {kind}"]
    want_losses, want_params = job["ref"][f"fit {kind}"]
    jax_losses, _ = job["ref"][f"jax {kind}"]
    assert len(losses) == len(job["job4"]["fits"][kind])
    _close(losses, want_losses)
    _close(losses, jax_losses)
    for r in job["ranks4"]:
        _close(r[f"fit {kind}"][1], want_params)
        if r["rank"]:
            assert r[f"fit {kind}"][0] == []  # rank 0 keeps the history


@pytest.mark.parametrize("kind", ["packed", "affine"])
def test_dp_sp_grads_match_jax_step(job, kind):
    """The first draw's reduced loss and gradients on every rank against
    ``jax.value_and_grad`` of the JAX fitter's loss."""
    want_loss = job["ref"][f"jax {kind}"][0][0]
    want = job["ref"][f"jax {kind}"][1]
    for r in job["ranks4"]:
        got = r[f"grads {kind}"]
        _close(got["loss"], want_loss)
        assert got["grads"].keys() == want.keys()
        for k in want:
            _close(got["grads"][k], want[k], atol=GRAD_TOL)


@pytest.mark.parametrize("mesh", ["ranks4", "ranks2"])
@pytest.mark.parametrize("est", ["rep", "path"])
def test_flagship_logq_logp_grads_sharded(job, mesh, est):
    """The small flagship with its PSD block under 2 x 2 and 1 x 2: logq,
    logp, the loss and every gradient leaf on every rank equal the
    unsharded run's."""
    want = job["ref"][f"flagship {est}"]
    for r in job[mesh]:
        got = r[f"flagship {est}"]
        for k in ("logq", "logp", "loss"):
            _close(got[k], want[k])
        for k in want["grads"]:
            _close(got["grads"][k], want["grads"][k])


@pytest.mark.parametrize("case", range(len(W.CONV_CASES)))
def test_circular_conv_on_slabs(job, case):
    """A 2-D conv with dilation 2, one with an even kernel (a one-sided
    halo) and a 4-D conv (its roll along the first lattice axis a halo
    read), each on two slabs: the outputs and the input gradients, halo
    cotangents sent back, equal the whole lattice's."""
    from normflow__tpu_torch.models.nets import CircularConv

    conv_dim, k, d = W.CONV_CASES[case]
    x, g = (torch.from_numpy(a) for a in job["convs"][case])
    conv = CircularConv(2, 3, k, conv_dim=conv_dim, dilation=d,
                        generator=torch.Generator().manual_seed(5),
                        **W.F64)
    x.requires_grad_(True)
    y = conv(x)
    gx = torch.autograd.grad((g * y).sum(), x)[0]
    for r in job["ranks2"]:
        rows = slice(r["rank"] * 4, (r["rank"] + 1) * 4)
        got_y, got_gx = r["convs"][case]
        _close(got_y, y.detach()[:, :, rows], atol=1e-12)
        _close(got_gx, gx[:, :, rows], atol=1e-12)


def test_sharded_sample_chain_equals_unsharded(job):
    ref = job["ref"]["samplers"]
    for r in job["ranks4"]:
        got = r["samplers"]
        for k in ("logq", "logp", "samples", "accept_rate"):
            assert got["chain"][k].shape == ref["chain"][k].shape
            _close(got["chain"][k], ref["chain"][k])
        for g, w in zip(got["chain_ref"], ref["chain_ref"]):
            _close(g, w)


def test_sharded_parallel_chains_equal_unsharded(job):
    ref = job["ref"]["samplers"]["parallel"]
    for r in job["ranks4"]:
        got = r["samplers"]["parallel"]
        for k in ("logq", "logp", "samples", "final_samples"):
            assert got[k].shape == ref[k].shape
            _close(got[k], ref[k])
        np.testing.assert_array_equal(got["accept_rate"], ref["accept_rate"])


def test_blocked_sweep_on_the_whole_lattice(job):
    """The blocked sampler runs on the whole lattice on every rank, also
    inside a slab block: its sweep equals the unsharded one."""
    ref = job["ref"]["blocked"]
    for r in job["ranks4"]:
        for g, w in zip(r["blocked"]["sweep"], ref["sweep"]):
            _close(g, w)
        assert r["blocked"]["sample_shape"] == (2, *LAT)
        assert r["blocked"]["sample_finite"]


def test_action_one_way_halo(job):
    """With the same cotangent of the totals on every space rank, each
    slab's gradient of the sharded action is the whole lattice's force
    there; with a cotangent of each rank's own partial action that differs
    over the ranks (``1 + space rank``), the one-way halo misses the
    gradient of ``sum_r c_r S_r``: the neighbour's term across the slab's
    edge goes uncounted, which is why the totals' backward must be the
    identity."""
    j = job["job4"]
    x, g = torch.from_numpy(j["x"]), torch.from_numpy(j["g"])
    w = W.flagship().action.get_coef(2)
    whole = phi4.phi4_action_grad_plain(x, g, *w).numpy()
    # the gradient of sum_r c_r S_r, through the plain slab action of a
    # differentiable halo on the whole lattice
    xr = x.clone().requires_grad_(True)
    rows = LAT[0] // 2
    loss = 0.0
    for s in range(2):
        slab = xr[:, s * rows:(s + 1) * rows]
        halo = torch.stack([xr[:, (s * rows - 1) % LAT[0]],
                            xr[:, ((s + 1) * rows) % LAT[0]]], 1)
        loss = loss + ((1.0 + s) * g * phi4.phi4_action_slab_plain(
            slab, halo, *w)).sum()
    weighted = torch.autograd.grad(loss, xr)[0].numpy()
    missed = 0.0
    for r in job["ranks4"]:
        d, s = r["topology"]["data_rank"], r["topology"]["slab"][0]
        rows_b = slice(d * B // 2, (d + 1) * B // 2)
        rows_l = slice(s * rows, (s + 1) * rows)
        equal, unequal = r["action"]
        _close(equal, whole[rows_b, rows_l], atol=1e-12)
        missed = max(missed, float(np.abs(
            unequal - weighted[rows_b, rows_l]).max()))
    assert missed > 1e-3


def test_topology_and_streams(job):
    """Rank ``r`` of ``{"data": 2, "space": 2}`` is ``(r // 2, r % 2)``;
    the prior's generator is the rank's own, the uniforms' the data
    rank's, shared by its two space ranks; the posterior returns the data
    rank's share of whole lattices."""
    tops = [r["topology"] for r in job["ranks4"]]
    for r, t in enumerate(tops):
        assert (t["data_axis"], t["space_axis"], t["n_data"]) == (
            "data", "space", 2)
        assert t["data_rank"] == r // 2
        assert t["slab"] == (r % 2, 2, (r % 2) * 4, 4)
    assert len({t["seed"] for t in tops}) == 4
    assert tops[0]["uniform_seed"] == tops[1]["uniform_seed"] \
        != tops[2]["uniform_seed"] == tops[3]["uniform_seed"]
    assert not {t["uniform_seed"] for t in tops} & {t["seed"] for t in tops}
    for r in job["ranks4"]:
        assert r["sample__"] == ((B // 2, *LAT), True)


def test_axis_order_rule(job):
    """``{"space": 2, "data": 2}`` shards the batch over ``data``; the
    ranks lie space-major, as the JAX mesh's devices do."""
    for r in job["ranks4"]:
        t = r["order"]
        assert (t["data_axis"], t["space_axis"]) == ("data", "space")
        assert t["data_rank"] == r["rank"] % 2
        assert t["slab"][0] == r["rank"] // 2
        assert r["order sample"] == ((4, *LAT), True)


def test_slab_errors_without_a_group():
    """What still raises before any collective: a halo deeper than the
    lattice (a circular pad refuses it too) and a packed mask of odd
    extents; a slab made current is current only inside its block."""
    slab = space.slab_of(None, 0, 4, 10)
    assert (slab.row0, slab.rows, slab.length, slab.per) == (0, 3, 10, 3)
    with pytest.raises(ValueError, match="halo of"):
        space.halo(torch.zeros(2, 1, 3, 8), 2, 11, 0, slab)
    with pytest.raises(ValueError, match="even dims"):
        PackedEvenOddMask(shape=(5, 8))
    with space.active(slab):
        assert space.current() is slab
    assert space.current() is None


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 12), (3, 8, 4, 4),
                                   (4, 16, 8)])
@pytest.mark.parametrize("n", [2, 4])
def test_slab_plain_versions_sum_to_the_whole(rng, shape, n):
    """The slab action's plain version summed over ``n`` slabs with their
    halos is ``phi4_action_plain`` of the whole lattice, and the stacked
    slab forces are ``phi4_action_grad_plain``'s, on numpy inputs."""
    cfgs = torch.from_numpy(rng.standard_normal(shape))
    g = torch.from_numpy(rng.standard_normal(shape[0]))
    w = (0.6, 0.3, 0.5)
    rows = shape[1] // n
    act, force = 0.0, []
    for s in range(n):
        slab = cfgs[:, s * rows:(s + 1) * rows]
        halo = torch.stack([cfgs[:, (s * rows - 1) % shape[1]],
                            cfgs[:, ((s + 1) * rows) % shape[1]]], 1)
        act = act + phi4.phi4_action_slab(slab, halo, *w)
        force.append(phi4.phi4_action_slab_grad(slab, halo, g, *w))
    _close(act, phi4.phi4_action_plain(cfgs, *w), atol=1e-12)
    _close(torch.cat(force, 1), phi4.phi4_action_grad_plain(cfgs, g, *w),
           atol=1e-12)


def test_slab_wrappers_keep_the_device_rule():
    """The plain versions only for CPU tensors: a tensor on another device
    (here ``meta``) raises, as a CUDA one would launch or raise."""
    cfgs, halo = torch.zeros(2, 4, 8, device="meta"), torch.zeros(
        2, 2, 8, device="meta")
    g = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        phi4.phi4_action_slab(cfgs, halo, 0.6, 0.3, 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        phi4.phi4_action_slab_grad(cfgs, halo, g, 0.6, 0.3, 0.5)
    with pytest.raises(ValueError, match="halo"):
        phi4.phi4_action_slab(torch.zeros(2, 4, 8), torch.zeros(2, 3, 8),
                              0.6, 0.3, 0.5)


def test_no_slab_is_the_identity():
    """With no slab current the space functions leave the unsharded code
    alone: the totals are their inputs, ``once`` keeps its term, and the
    handler's helpers return their argument."""
    a, b = torch.arange(3.0), torch.arange(3.0) + 1
    assert space.current() is None
    assert all(x is y for x, y in zip(space.totals(None, a, b), (a, b)))
    assert space.once(a, None) is a
    dh = W.flagship().device_handler
    assert dh.slab is None and dh.local_rows(a) is a and \
        dh.whole_rows(a) is a
    with dh.sharded():
        assert space.current() is None
    assert dh.uniform_generator(None) is None and not dh.captures()
