"""Lattices whose rows do not split evenly over the space ranks, on real
gloo groups on the CPU.

XLA splits a sharded axis into ``ceil(L0 / m)`` rows a rank, the last ranks
shorter or empty (``normflow__tpu/parallel/mesh.py:143-171``); the port's
``space.slab_of`` does the same.  Two spawned jobs (``tests/
_torch_uneven_worker.run_rank``, a group of two ranks and one of three,
run beside the JAX side) drive the small float64 flagship (PSD block, two
couplings, perturbed weights) under ``{"data": 1, "space": m}`` at five
splits: (9, 8) over 2 (5/4, unpacked), packed (10, 8) over 2 (5/5, the
second slab from an odd row), packed (32, 8) over 3 (11/11/10), packed (4,
8) over 3 (2/2/0, an empty slab) and (3, 8) over 2 with dilation-2
conditioners (2/1: a halo of two rows over a slab of one).  Each case's
logq and logp per sample and one step's gradients are held against the JAX
package's unsharded model and the port's unsharded model to 1e-10, and
``sample_chain`` and ``sample_parallel_chains`` on fed rounds against the
unsharded port: the accept decisions bit for bit, the values to 1e-10 (the
totals over the slabs add in another order).  ``torch.autograd.gradcheck``
holds ``space.halo`` and ``space.gather_rows`` at ragged splits; the rest
are checks without a group.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch.models import spectral
from normflow__tpu_torch.models.masks import PackedEvenOddMask
from normflow__tpu_torch.ops.kernels import phi4
from normflow__tpu_torch.parallel import space

import _torch_uneven_worker as W
from test_torch_flagship import perturbed_leaves

B = 6
TOL = 1e-10
CASES = list(W.CASES)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def jax_step(case, leaves, x):
    """The JAX package's unsharded flagship of ``case``: logq, logp, the
    reverse-KL loss and its gradients at the draw ``x``
    (``normflow__tpu/training/fitter.py:250-268``, ``rep``), compiled at
    XLA's lowest backend optimisation level (it runs once)."""
    lat, packed, _, dilation, _ = W.CASES[case]
    jmodel = jax_build(lat, knots=4, hidden=(4,), n_layers=2, packed=packed,
                       conv_dilations=dilation, dtype=jnp.float64)
    net = restore_into(jmodel.net_, leaves)

    def value_and_grad(net, x):
        def loss_of(net):
            y, logj = net.forward(x)
            logq = jmodel.prior.log_prob(x) - logj
            logp = -jmodel.action(y)
            return jlosses.calc_kl_mean(logq, logp), (logq, logp)
        return jax.value_and_grad(loss_of, has_aux=True)(net)

    xj = jnp.asarray(x)
    (loss, (logq, logp)), grads = jax.jit(value_and_grad).lower(
        net, xj).compile(compiler_options={
            "xla_backend_optimization_level": 0})(net, xj)
    return dict(loss=float(loss), logq=np.asarray(logq),
                logp=np.asarray(logp), grads=leaves_of(grads))


@pytest.fixture(scope="module")
def job():
    """Each case's draws and leaves, both jobs' ranks (spawned first, run
    beside the JAX side), the JAX package's steps and the unsharded port's
    runs."""
    rng = np.random.default_rng(20261019)
    cases = {}
    for case in CASES:
        lat, packed, _, dilation, _ = W.CASES[case]
        jnet = jax_build(lat, knots=4, hidden=(4,), n_layers=2,
                         packed=packed, conv_dilations=dilation).net_
        rounds = [(rng.standard_normal((B, *lat)), np.log(rng.random(B)))
                  for _ in range(6)]
        cases[case] = dict(leaves=perturbed_leaves(jnet, rng),
                           x=rng.standard_normal((B, *lat)),
                           chain_rounds=rounds[:3], par_rounds=rounds[3:])
    handler = W.flagship(CASES[0]).device_handler
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = {m: pool.submit(handler.spawnprocesses, W.run_rank, m, dict(
            cases={k: v for k, v in cases.items() if W.CASES[k][2] == m}))
            for m in (2, 3)}
        jax_ref = {case: jax_step(case, c["leaves"], c["x"])
                   for case, c in cases.items()}
        port_ref = {case: W.run_case(W.attached(case, c["leaves"]), c)
                    for case, c in cases.items()}
        ranks = {m: f.result() for m, f in ranks.items()}
    return dict(ranks=ranks, jax=jax_ref, port=port_ref)


def _ranks(job, case):
    """The ranks' results of ``case``."""
    return [r[case] for r in job["ranks"][W.CASES[case][2]]]


@pytest.mark.parametrize("case", CASES)
def test_slabs_split_as_xla(job, case):
    """Each rank holds the rows XLA gives it."""
    assert [r["slab"] for r in _ranks(job, case)] == W.CASES[case][4]


@pytest.mark.parametrize("case", CASES)
def test_logq_logp_match_jax_and_unsharded(job, case):
    """``posterior.sample__`` of the fed batch: the whole samples, and
    logq and logp per sample, against the unsharded port, and logq and
    logp against the JAX package."""
    want_y, want_q, want_p = job["port"][case]["sample"]
    for r in _ranks(job, case):
        y, logq, logp = r["sample"]
        _close(y, want_y)
        _close(logq, want_q)
        _close(logp, want_p)
        _close(logq, job["jax"][case]["logq"])
        _close(logp, job["jax"][case]["logp"])


@pytest.mark.parametrize("case", CASES)
def test_step_gradients_match_jax_and_unsharded(job, case):
    """One step's loss, logq, logp and every gradient leaf, summed over the
    slabs, against the JAX package's and the unsharded port's."""
    want, port = job["jax"][case], job["port"][case]["step"]
    for r in _ranks(job, case):
        got = r["step"]
        for k in ("loss", "logq", "logp"):
            _close(got[k], want[k])
            _close(got[k], port[k])
        assert got["grads"].keys() == want["grads"].keys()
        for k in want["grads"]:
            _close(got["grads"][k], want["grads"][k])
            _close(got["grads"][k], port["grads"][k])


@pytest.mark.parametrize("case", CASES)
def test_sample_chain_matches_unsharded(job, case):
    """``sample_chain`` on fed rounds: every accept decision bit for bit,
    the samples, logq, logp and the carried reference to 1e-10."""
    ref = job["port"][case]["samplers"]
    for r in _ranks(job, case):
        got = r["samplers"]
        np.testing.assert_array_equal(got["chain"]["accept_rate"],
                                      ref["chain"]["accept_rate"])
        for k in ("logq", "logp", "samples"):
            assert got["chain"][k].shape == ref["chain"][k].shape
            _close(got["chain"][k], ref["chain"][k])
        for g, w in zip(got["chain_ref"], ref["chain_ref"]):
            _close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_parallel_chains_match_unsharded(job, case):
    ref = job["port"][case]["samplers"]["parallel"]
    for r in _ranks(job, case):
        got = r["samplers"]["parallel"]
        np.testing.assert_array_equal(got["accept_rate"], ref["accept_rate"])
        for k in ("logq", "logp", "samples", "final_samples"):
            assert got[k].shape == ref[k].shape
            _close(got[k], ref[k])


@pytest.mark.parametrize("split", W.SPLITS)
@pytest.mark.parametrize("which", ["halo", "gather_rows"])
def test_collectives_gradcheck(job, split, which):
    """``gradcheck`` of ``space.halo`` (a halo deeper than a slab at 2/2/1
    and 2/1, an empty slab at 2/2/0, a one-sided halo at 5/4) and of
    ``space.gather_rows`` at the same splits."""
    for r in job["ranks"][split[1]]:
        got = r[split][("halo", "gather_rows").index(which)]
        assert got is True, got


@pytest.mark.parametrize("rows,m,want", [
    (32, 3, [(0, 11), (11, 11), (22, 10)]), (4, 3, [(0, 2), (2, 2), (4, 0)]),
    (6, 4, [(0, 2), (2, 2), (4, 2), (6, 0)]), (9, 2, [(0, 5), (5, 4)]),
    (64, 6, [(0, 11), (11, 11), (22, 11), (33, 11), (44, 11), (55, 9)]),
    (32, 4, [(0, 8), (8, 8), (16, 8), (24, 8)])])
def test_slab_of_splits_as_xla(rows, m, want):
    """``ceil(rows / m)`` rows a rank; ``owner`` inverts the split."""
    slabs = [space.slab_of(None, r, m, rows) for r in range(m)]
    assert [(s.row0, s.rows) for s in slabs] == want
    assert all(s.bounds(r) == want[r] for s in slabs for r in range(m))
    for g in range(-rows, 2 * rows):
        q, i = slabs[0].owner(g)
        row0, n = want[q]
        assert 0 <= i < n and row0 + i == g % rows


def test_psd_volume_counts_the_lattice():
    """The PSD block's volume on each slab of 11/11/10 is the lattice's
    256 sites, and the density the mean field spreads sums to the
    per-sample log-Jacobian over the slabs."""
    logj = torch.tensor([0.25, -1.5], dtype=torch.float64)
    total = 0.0
    for r in range(3):
        slab = space.slab_of(None, r, 3, 32)
        assert spectral._volume((slab.rows, 8), slab) == 256
        dens = spectral._spread_density(logj, (slab.rows, 8), slab)
        assert dens.shape == (2, slab.rows, 8)
        total = total + dens.sum(dim=(1, 2))
    _close(total, logj, atol=1e-14)
    assert spectral._volume((32, 8), None) == 256


@pytest.mark.parametrize("lat,m", [((10, 8), 2), ((32, 8), 3), ((4, 8), 3),
                                   ((12, 4), 5), ((6, 8), 4)])
@pytest.mark.parametrize("parity", [0, 1])
def test_packed_mask_packs_any_slab(lat, m, parity):
    """A slab's packed partitions are the whole lattice's rows of them, at
    odd first rows, odd heights and on an empty slab; ``cat`` undoes
    ``split``."""
    x = torch.arange(2 * lat[0] * lat[1], dtype=torch.float64).reshape(
        2, *lat)
    mask = PackedEvenOddMask(shape=lat, parity=parity)
    whole = mask.split(x)
    for r in range(m):
        slab = space.slab_of(None, r, m, lat[0])
        rows = slice(slab.row0, slab.row0 + slab.rows)
        with space.active(slab):
            parts = mask.split(x[:, rows])
            back = mask.cat(*parts)
        for got, want in zip(parts, whole):
            assert torch.equal(got, want[:, rows])
        assert torch.equal(back, x[:, rows])


@pytest.mark.parametrize("shape,m", [((3, 32, 8), 3), ((3, 4, 8), 3),
                                     ((3, 9, 8), 2), ((2, 5, 4, 4), 3),
                                     ((2, 6, 8, 3, 2), 4)])
def test_slab_plain_action_at_ragged_splits(rng, shape, m):
    """The slab action's and force's plain versions over XLA's split (an
    empty slab included) sum to and stack into the whole lattice's."""
    cfgs = torch.from_numpy(rng.standard_normal(shape))
    g = torch.from_numpy(rng.standard_normal(shape[0]))
    w = (0.6, 0.3, 0.5)
    act, force = 0.0, []
    for r in range(m):
        slab = space.slab_of(None, r, m, shape[1])
        rows = cfgs[:, slab.row0:slab.row0 + slab.rows]
        halo = torch.stack([cfgs[:, (slab.row0 - 1) % shape[1]],
                            cfgs[:, (slab.row0 + slab.rows) % shape[1]]], 1)
        act = act + phi4.phi4_action_slab(rows, halo, *w)
        force.append(phi4.phi4_action_slab_grad(rows, halo, g, *w))
    _close(act, phi4.phi4_action_plain(cfgs, *w), atol=1e-12)
    _close(torch.cat(force, 1), phi4.phi4_action_grad_plain(cfgs, g, *w),
           atol=1e-12)
