"""The port's samplers on the card: the accept kernel and the graphed rounds.

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``, skip
without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_mcmc.py

Held here, with TF32 off:

- ``accept_scan``'s kernel against its plain version, bit for bit, at
  lengths on both sides of one and two of its 1024-proposal chunks, at odd
  ones and at 10,000, with ``-inf`` log uniforms and a ``+inf``
  reference, and on the chains of ``tests/_accept_scan_chains.py`` (all
  accepted, all rejected, NaNs, exact ties, stuck on one heavy state, no
  acceptance from any state); a planted wrong reference must change the
  result; float64 and mixed devices raise;
- ``sample_chain`` and ``sample_parallel_chains`` replayed against their
  eager round bodies from the same generator state, bit for bit, at the
  flagship's 32x32 with B = 1024 and at 8x8, the final ``_ref`` and the
  collected samples included; a ``sample__`` between two chains;
- the launches of replayed rounds by profiler name: 4 ``rqs_coupling``,
  1 ``phi4_action`` and 1 ``accept_scan`` per chain round, 4 / 1 / 0 per
  parallel round, while the wrappers' counters do not move;
- the blocked sampler's replayed block step against the eager one, bit
  for bit, at 8x8 and 32x32 with 4 and 16 blocks, and ``sample__``
  against the eager sweep from one generator state; a second call reuses
  the captured step; a warm call's launches by profiler name, one flow
  forward at B = 1 for the start and one per block proposal, while the
  wrappers' counters do not move.
"""

import math

import numpy as np
import pytest
import torch

from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.ops.kernels.accept_scan import (accept_scan,
                                                         accept_scan_plain)
from normflow__tpu_torch.tools.kernel_times import device_launches
from _accept_scan_chains import SPECIAL, chain
from test_torch_cuda_graphs import _model, _same_bits, cuda  # noqa: F401

pytestmark = pytest.mark.gpu


def _chain_inputs(n, seed, ref=0.3):
    rng = np.random.default_rng(seed)
    logqp = torch.tensor(rng.standard_normal(n) * 1.5, dtype=torch.float32)
    lrand = torch.tensor(np.log(rng.random(n)), dtype=torch.float32)
    lrand[::11] = -math.inf
    return lrand, logqp, torch.tensor(ref, dtype=torch.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 47, 48, 49, 255, 1000, 1023, 1024,
                               1025, 2047, 2048, 2049, 5001, 10000])
def test_kernel_matches_plain(cuda, n):
    lrand, logqp, ref = _chain_inputs(n, n)
    launches = accept_scan.launches
    got = accept_scan(lrand.cuda(), logqp.cuda(), ref.cuda())
    want = accept_scan_plain(lrand, logqp, ref)
    torch.cuda.synchronize()
    assert accept_scan.launches == launches + 1
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("n", [30, 1024, 2049, 10000])
@pytest.mark.parametrize("case", SPECIAL)
def test_kernel_matches_plain_on_special_chains(cuda, case, n):
    lrand, logqp, ref = (torch.tensor(a) for a in chain(case, n))
    got = accept_scan(lrand.cuda(), logqp.cuda(), ref.cuda())
    want = accept_scan_plain(lrand, logqp, ref)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_kernel_inf_reference_and_planted_wrong_reference(cuda):
    lrand, logqp, _ = _chain_inputs(3000, 7)
    logqp[0], lrand[0] = 0.0, -0.25
    inf = torch.tensor(math.inf)
    got = accept_scan(lrand.cuda(), logqp.cuda(), inf.cuda())
    assert bool(got[0][0]) and torch.equal(
        got[0].cpu(), accept_scan_plain(lrand, logqp, inf)[0])
    # ref 0: proposal 0 accepted (-0.25 < 0); a planted ref of -0.5 rejects
    got = accept_scan(lrand.cuda(), logqp.cuda(), torch.zeros((),
                                                             device="cuda"))
    planted = accept_scan_plain(lrand, logqp, torch.tensor(-0.5))
    torch.cuda.synchronize()
    assert bool(got[0][0]) and not bool(planted[0][0])
    assert not torch.equal(got[0].cpu(), planted[0])


def test_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(8, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        accept_scan(x.double(), x.double(), torch.zeros((), device="cuda",
                                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel"):
        accept_scan(x, x.cpu(), 0.0)


def _seed_carry(model, shape=()):
    kw = dict(dtype=torch.float32, device="cuda")
    return [torch.zeros((*shape, *model.prior.shape), **kw),
            torch.full(shape, math.inf, **kw), torch.zeros(shape, **kw)]


def _eager_chain(model, n, batch, carry):
    """``(logq, logp, accept_rate, samples)`` of ``n`` eager rounds."""
    outs = [model.mcmc.chain_body(batch, model.generator, carry)
            for _ in range(n)]
    return tuple(torch.stack([o[k] for o in outs]) for k in (1, 2, 3, 0))


@pytest.mark.parametrize("lat,batch", [((32, 32), 1024), ((8, 8), 64)])
def test_chain_replay_matches_eager_rounds(cuda, lat, batch):
    model = _model(lat)
    model.seed(11)
    out = model.mcmc.sample_chain(4, batch, collect_samples=True)
    ref = model.mcmc._ref
    model.seed(11)
    carry = _seed_carry(model)
    want = _eager_chain(model, 4, batch, carry)
    torch.cuda.synchronize()
    got = (out["logq"], out["logp"], out["accept_rate"], out["samples"])
    assert bool(torch.isfinite(out["logq"]).all())
    assert _same_bits(got, want) and _same_bits(ref, carry)
    assert len(model.mcmc.history.accept_rate) == 4
    # reset drops the reference: the next call starts from +inf again
    model.mcmc.reset()
    model.seed(11)
    again = model.mcmc.sample_chain(4, batch, collect_samples=True)
    assert _same_bits((again["logq"], again["samples"]), (got[0], got[3]))


def test_sample__between_two_chains(cuda):
    model = _model((8, 8))
    model.seed(5)
    a = model.mcmc.sample_chain(2, 64)["logq"]
    y, logq, _ = model.mcmc.sample__(64)
    b = model.mcmc.sample_chain(2, 64, collect_samples=True)
    model.mcmc.reset()
    model.seed(5)
    carry = _seed_carry(model)
    want_a = _eager_chain(model, 2, 64, carry)[0]
    model.mcmc._ref = tuple(t.clone() for t in carry)
    y2, logq2, _ = model.mcmc.sample__(64)
    carry = [t.clone() for t in model.mcmc._ref]
    want_b = _eager_chain(model, 2, 64, carry)
    torch.cuda.synchronize()
    assert _same_bits((a, y, logq), (want_a, y2, logq2))
    assert _same_bits((b["logq"], b["samples"]), (want_b[0], want_b[3]))


@pytest.mark.parametrize("lat,batch", [((32, 32), 1024), ((8, 8), 64)])
def test_parallel_replay_matches_eager_rounds(cuda, lat, batch):
    model = _model(lat)
    model.seed(12)
    out = model.mcmc.sample_parallel_chains(3, batch, collect_samples=True)
    model.seed(12)
    carry = _seed_carry(model, (batch,))
    rows = []
    for _ in range(3):
        accept, _, _ = model.mcmc.parallel_body(batch, model.generator, carry)
        rows.append([t.clone() for t in (*carry, accept)])
    torch.cuda.synchronize()
    want = [torch.stack([r[k] for r in rows]) for k in range(4)]
    assert _same_bits((out["samples"], out["logq"], out["logp"]), want[:3])
    np.testing.assert_array_equal(out["accept_rate"],
                                  want[3].cpu().numpy().mean(axis=1))
    assert _same_bits((out["final_samples"],), (carry[0],))
    assert model.mcmc._ref is None


def test_replayed_rounds_launch_by_profiler_name(cuda):
    model = _model((32, 32))
    mcmc = model.mcmc
    mcmc.sample_chain(1, 1024)
    mcmc.sample_parallel_chains(1, 1024)  # both captured
    counters = (sc.rqs_coupling, phi4.phi4_action, accept_scan)
    before = [c.launches for c in counters]
    chain = {"rqs_coupling": (8, 8), "phi4_action": (2, 2),
             "accept_scan": (2, 0)}
    parallel = {"rqs_coupling": (8, 8), "phi4_action": (2, 2)}
    assert device_launches(lambda: mcmc.sample_chain(2, 1024))[0] == chain
    assert device_launches(
        lambda: mcmc.sample_parallel_chains(2, 1024))[0] == parallel
    assert [c.launches for c in counters] == before


def _blocked_draws(model, batch, n_blocks):
    """``sample__``'s start and draws from the model's generator: the
    prior's sample, then every proposal and log uniform."""
    prior, gen = model.prior, model.generator
    x = prior.sample(1, gen)
    return (x, *model.blocked_mcmc._block_draws(
        prior.chopped(prior.nvar // n_blocks), batch, n_blocks, gen))


@pytest.mark.parametrize("n_blocks", [4, 16])
@pytest.mark.parametrize("lat", [(8, 8), (32, 32)])
def test_blocked_replay_matches_eager_sweep(cuda, lat, n_blocks):
    """The replayed block step against the eager one on the same draws,
    bit for bit, with and without a reference; ``sample__`` (which
    replays) against the eager sweep from the same generator state."""
    model = _model(lat)
    bm = model.blocked_mcmc
    model.seed(13)
    x, proposals, lrand = _blocked_draws(model, 3, n_blocks)
    for ref, has in ((0.0, False), (1.5, True)):
        got = bm.sweep(x, ref, has, proposals, lrand, graphed=True)
        want = bm.sweep(x, ref, has, proposals, lrand)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
        assert got[3].shape == (3, n_blocks)
    model.seed(14)
    cfgs, logq, logp = bm.sample__(3, n_blocks=n_blocks)
    model.seed(14)
    x, proposals, lrand = _blocked_draws(model, 3, n_blocks)
    want = bm.sweep(x, 0.0, False, proposals, lrand)
    torch.cuda.synchronize()
    assert _same_bits((cfgs, logq, logp), want[:3])
    assert bool(torch.isfinite(logq).all())


def test_blocked_second_call_replays_without_a_capture(cuda):
    """A second ``sample__`` (from the carried reference: the inverse flow
    runs eagerly, outside the graphs, as in the JAX package) reuses the
    captured step; the wrappers' counters move only by that inverse."""
    model = _model((32, 32))
    bm = model.blocked_mcmc
    bm.sample__(2, n_blocks=4)
    graphs = bm.block_graphs(256)
    assert len(bm._graphs) == 1
    counters = (sc.rqs_coupling, phi4.phi4_action, accept_scan)
    before = [c.launches for c in counters]
    cfgs, logq, _ = bm.sample__(2, n_blocks=4)
    torch.cuda.synchronize()
    assert bm.block_graphs(256) is graphs and len(bm._graphs) == 1
    n_layers = len(model.net_[2].nets)
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [n_layers, 0, 0]
    assert cfgs.shape == (2, 32, 32) and bool(torch.isfinite(logq).all())
    bm.sample__(1, n_blocks=16)  # another block length: a second capture
    assert len(bm._graphs) == 2


def test_blocked_sampler_on_the_card(cuda):
    """A warm call (it captures), ``reset()``, then a call profiled: its
    launches by profiler name are one flow forward for the start and one
    per block proposal, all replayed, and no wrapper runs."""
    model = _model((8, 8))
    bm = model.blocked_mcmc
    bm.sample__(2, n_blocks=4)
    bm.reset()
    counters = (sc.rqs_coupling, phi4.phi4_action, accept_scan)
    before = [c.launches for c in counters]
    launches, (cfgs, logq, logp) = device_launches(
        lambda: bm.sample__(2, n_blocks=4))
    torch.cuda.synchronize()
    assert cfgs.shape == (2, 8, 8) and bool(torch.isfinite(logq).all())
    # one flow forward for the start and one per block proposal
    n = 1 + 2 * 4
    assert launches["rqs_coupling"][0] == 4 * n
    assert launches["phi4_action"][0] == n
    assert "accept_scan" not in launches
    assert [c.launches for c in counters] == before
    assert torch.allclose(logp, -model.action(cfgs))
