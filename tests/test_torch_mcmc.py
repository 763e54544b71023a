"""Port parity of the MCMC samplers, the other priors and the observables.

The same numpy draws go through the JAX package and the port (float64
unless stated): the recurrence ``accept_scan`` against ``_accept_scan_core``
(identical accepts and indices, float32 and float64); one round, several
rounds carrying ``_ref`` (``sample__`` then ``sample_chain``), parallel
chains and the blocked sweep on the transplanted 8x8 flagship, with the
JAX draws re-made from the JAX keys and fed to the port (identical accepts,
values to 1e-10; the blocked sweep's block step against the jitted
``_blocked_sweep_kernel`` at 1, 4 and 16 blocks, and against the eager
loop it replaced, bit for bit); the host ``Metropolis`` helpers from one numpy seed;
``UniformPrior``, ``PriorList``, ``chopped`` and ``nvar`` and every
observable to 1e-12; the entry API.  A zero-dim model fitted once per
module reproduces the quadrature <phi^2> through ``sample_chain``,
parallel chains and the blocked sampler (``tests/test_mcmc.py``'s bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.mcmc import metropolis as jmcmc
from normflow__tpu.models import priors as jpriors
from normflow__tpu.ops import observables as jobs
import normflow__tpu_torch as nt
from normflow__tpu_torch.models import priors
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.elementwise import DistConvertor
from normflow__tpu_torch.ops import observables as obs
from normflow__tpu_torch.ops.kernels.accept_scan import (accept_scan,
                                                         accept_scan_plain)
from test_torch_flagship import _jax_logq_logp, twin_models

B = 8
F64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture
def twins(rng):
    return twin_models(rng, jnp.float64, torch.float64)


# --------------------------------------------------------------------- #
# the recurrence
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["random", "inf_ref", "neg_inf_uniforms",
                                  "one"])
def test_accept_scan_matches_jax(rng, dtype, case):
    n = 1 if case == "one" else 300
    logqp = (rng.standard_normal(n) * 2).astype(dtype)
    lrand = np.log(rng.random(n)).astype(dtype)
    ref = dtype(logqp[0] + 0.5)
    if case == "inf_ref":
        ref = dtype(np.inf)
    if case == "neg_inf_uniforms":
        lrand[::7] = -np.inf
    got = accept_scan(_t(lrand), _t(logqp), torch.tensor(ref))
    want = jmcmc._accept_scan_core(jnp.asarray(lrand), jnp.asarray(logqp),
                                   jnp.asarray(ref))
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "inf_ref":
        assert bool(got[0][0])
    if case == "neg_inf_uniforms":
        assert got[0][::7].all()


def test_accept_scan_device_rule():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="no kernel"):
        accept_scan(x.to("meta"), x.to("meta"), torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="one"):
        accept_scan(torch.zeros(3), x, 0.0)
    acc, idx = accept_scan_plain(torch.zeros(0), torch.zeros(0), 0.0)
    assert acc.shape == idx.shape == (0,)


# --------------------------------------------------------------------- #
# rounds on the transplanted 8x8 flagship
# --------------------------------------------------------------------- #
def _jax_round_draws(jmodel, key, batch):
    """``(x, lrand)`` of one JAX round from ``key``: ``k1`` for the prior,
    ``k2`` for the uniforms (``_chain_scan``'s and ``sample__``'s split)."""
    k1, k2 = jax.random.split(key)
    x = jmodel.prior.sample(k1, batch)
    lrand = jnp.log(jax.random.uniform(k2, (batch,), x.dtype))
    return np.asarray(x), np.asarray(lrand)


def _feed(sampler, prior, draws):
    """Make ``sampler`` take its rounds' draws from ``draws``, a list of
    ``(x, lrand)`` numpy pairs, in order."""
    it = iter(draws)

    def _draws(batch_size, generator):
        x, lrand = next(it)
        assert x.shape[0] == batch_size
        x = _t(x)
        return x, prior.log_prob(x), _t(lrand)

    sampler._draws = _draws


def test_one_round_matches_accept_reject_core(twins):
    jmodel, model = twins
    key = jax.random.key(11)
    k1, k2 = jax.random.split(key)
    x, lrand = _jax_round_draws(jmodel, key, B)
    y, _, logq, logp = _jax_logq_logp(jmodel.net_, jmodel.prior,
                                      jmodel.action, jnp.asarray(x))
    want = jmcmc._accept_reject_core(k2, y, logq, logp, y[0], logq[0],
                                     logp[0])
    _feed(model.mcmc, model.prior, [(x, lrand)])
    got = model.mcmc.sample__(B, bookkeeping=True)
    for g, w in zip(got, want[:3]):
        _close(g, w)
    np.testing.assert_array_equal(model.mcmc.history.accept_seq[0],
                                  np.asarray(want[3]))
    _close(model.mcmc._ref[1], want[1][-1])


def test_rounds_carry_ref_sample_then_chain(twins):
    """``sample__`` then ``sample_chain(3, B)``: every corrected stream,
    accept rate, collected sample and the final ``_ref`` as JAX's."""
    jmodel, model = twins
    k_a, k_b = jax.random.key(5), jax.random.key(6)
    jy, jlq, jlp = jmodel.mcmc.sample__(B, key=k_a)
    jout = jmodel.mcmc.sample_chain(3, B, key=k_b, collect_samples=True)
    draws = [_jax_round_draws(jmodel, k_a, B)] + [
        _jax_round_draws(jmodel, k, B) for k in jax.random.split(k_b, 3)]
    _feed(model.mcmc, model.prior, draws)
    y, lq, lp = model.mcmc.sample__(B)
    for g, w in zip((y, lq, lp), (jy, jlq, jlp)):
        _close(g, w)
    out = model.mcmc.sample_chain(3, B, collect_samples=True)
    for k in ("logq", "logp", "samples", "accept_rate"):
        _close(out[k], jout[k])
    assert model.mcmc.history.accept_rate == pytest.approx(
        jmodel.mcmc.history.accept_rate, abs=1e-12)
    for g, w in zip(model.mcmc._ref, (jmodel.mcmc._ref[k] for k in
                                      ("sample", "logq", "logp"))):
        _close(g, w)


def test_first_chain_call_seeds_with_inf_reference(twins):
    jmodel, model = twins
    key = jax.random.key(8)
    jout = jmodel.mcmc.sample_chain(2, B, key=key, bookkeeping=True)
    _feed(model.mcmc, model.prior,
          [_jax_round_draws(jmodel, k, B) for k in jax.random.split(key, 2)])
    out = model.mcmc.sample_chain(2, B, bookkeeping=True)
    for k in ("logq", "logp"):
        _close(out[k], jout[k])
    h, jh = model.mcmc.history, jmodel.mcmc.history
    assert h.accept_seq[0][0] and len(h.raw_logq) == 2
    for name in ("raw_logq", "raw_logp", "logq", "logp"):
        for g, w in zip(getattr(h, name), getattr(jh, name)):
            _close(g, w)
    for name in ("accept_seq", "accept_ind"):
        for g, w in zip(getattr(h, name), getattr(jh, name)):
            np.testing.assert_array_equal(g, w)


def test_parallel_chains_match_jax(twins):
    jmodel, model = twins
    key = jax.random.key(9)
    jout = jmodel.mcmc.sample_parallel_chains(3, B, key=key,
                                              collect_samples=True)
    _feed(model.mcmc, model.prior,
          [_jax_round_draws(jmodel, k, B) for k in jax.random.split(key, 3)])
    out = model.mcmc.sample_parallel_chains(3, B, collect_samples=True)
    for k in ("logq", "logp", "samples", "final_samples"):
        _close(out[k], jout[k])
    np.testing.assert_array_equal(out["accept_rate"], jout["accept_rate"])
    assert model.mcmc._ref is None


def _jax_sweep(jmodel, x, logqp_ref, has_ref, proposals, lrand):
    """``normflow__tpu/mcmc/metropolis.py:585-611`` as a loop, with JAX's
    ``net.forward``, ``prior.log_prob`` and ``action``."""
    net, prior, action = jmodel.net_, jmodel.prior, jmodel.action
    shape = x.shape[1:]

    @jax.jit
    def evaluate(x_flat):
        xs = x_flat.reshape(1, *shape)
        y, logj = net.forward(xs)
        return y[0], (prior.log_prob(xs) - logj)[0], -action(y)[0]

    x_flat, ref, has = jnp.asarray(x).reshape(-1), logqp_ref, has_ref
    block_len = proposals.shape[-1]
    y_acc, lq_acc, lp_acc = evaluate(x_flat)
    cfgs, logq, logp, accepts = [], [], [], []
    for props, lrs in zip(proposals, lrand):
        for b in range(len(props)):
            x_new = jax.lax.dynamic_update_slice(
                x_flat, jnp.asarray(props[b]), (b * block_len,))
            y, lq, lp = evaluate(x_new)
            accept = jnp.where(has, lrs[b] < (ref - (lq - lp)), True)
            sel = lambda new, old: jnp.where(accept, new, old)  # noqa: E731
            x_flat, ref = sel(x_new, x_flat), sel(lq - lp, ref)
            has = jnp.logical_or(has, accept)
            y_acc, lq_acc, lp_acc = sel(y, y_acc), sel(lq, lq_acc), sel(
                lp, lp_acc)
            accepts.append(bool(accept))
        cfgs.append(y_acc)
        logq.append(lq_acc)
        logp.append(lp_acc)
    return np.stack(cfgs), np.stack(logq), np.stack(logp), np.reshape(
        accepts, lrand.shape)


def _jax_block_draws(jmodel, key, batch, n_blocks, block_len):
    """Every proposal and log uniform that ``_blocked_sweep_kernel`` draws
    from ``key`` (its ``sample_step``, ``normflow__tpu/mcmc/
    metropolis.py:598-602``), as numpy ``(batch, n_blocks, block_len)``
    and ``(batch, n_blocks)``."""
    chopped = jmodel.prior.chopped(block_len)
    props, lrs = [], []
    for k in jax.random.split(key, batch):
        kp, kr = jax.random.split(k)
        p = chopped.sample(kp, n_blocks)
        props.append(np.asarray(p))
        lrs.append(np.asarray(jnp.log(jax.random.uniform(kr, (n_blocks,),
                                                         p.dtype))))
    return np.stack(props), np.stack(lrs)


@pytest.mark.parametrize("n_blocks", [1, 4, 16])
@pytest.mark.parametrize("has_ref", [False, True])
def test_blocked_sweep_matches_jax_loop(rng, twins, has_ref, n_blocks):
    """The port's block step, driven eagerly by ``sweep`` on the JAX
    package's own draws, against ``_blocked_sweep_kernel`` (the jitted
    scan over samples and blocks) and against the same updates written as
    a loop (:func:`_jax_sweep`): cfgs, logq, logp to 1e-10, the accept
    sequence identical."""
    jmodel, model = twins
    batch, block_len = 3, 64 // n_blocks
    x = rng.standard_normal((1, 8, 8))
    ref = float(rng.standard_normal()) * 3
    key = jax.random.key(40 + n_blocks)
    want = jmcmc._blocked_sweep_kernel(
        jmodel.net_, jmodel.prior, jmodel.action, key, jnp.asarray(x),
        jnp.asarray(ref), has_ref, batch, n_blocks, block_len)
    proposals, lrand = _jax_block_draws(jmodel, key, batch, n_blocks,
                                        block_len)
    loop = _jax_sweep(jmodel, x, ref, has_ref, proposals, lrand)
    got = model.blocked_mcmc.sweep(_t(x), torch.tensor(ref), has_ref,
                                   _t(proposals), _t(lrand))
    for w in (want, loop):
        for g, v in zip(got[:3], w[:3]):
            _close(g, v)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(w[3]))
    assert got[3].shape == (batch, n_blocks)
    if not has_ref:
        assert bool(got[3][0, 0])


def _old_sweep(model, x, logqp_ref, has_ref, proposals, lrand):
    """The blocked sweep as the port ran it before its block step: a
    Python loop over samples and blocks, the proposal written by slice
    assignment into a clone of the state."""
    shape = x.shape[1:]
    block_len = proposals.shape[-1]

    def evaluate(x_flat):
        xs = x_flat.reshape(1, *shape)
        y, logj = model.net_.forward(xs)
        return (y[0], (model.prior.log_prob(xs) - logj)[0],
                -model.action(y)[0])

    x_flat = x.reshape(-1)
    ref = torch.as_tensor(logqp_ref, dtype=x.dtype)
    has = torch.tensor(bool(has_ref))
    y_acc, logq_acc, logp_acc = evaluate(x_flat)
    cfgs, logqs, logps, accepts = [], [], [], []
    for props, lrs in zip(proposals, lrand):
        for b, (proposal, lr) in enumerate(zip(props, lrs)):
            x_new = x_flat.clone()
            x_new[b * block_len:(b + 1) * block_len] = proposal
            y, logq, logp = evaluate(x_new)
            logqp = logq - logp
            accept = (lr < ref - logqp) | ~has
            x_flat = torch.where(accept, x_new, x_flat)
            ref = torch.where(accept, logqp, ref)
            has = has | accept
            y_acc = torch.where(accept, y, y_acc)
            logq_acc = torch.where(accept, logq, logq_acc)
            logp_acc = torch.where(accept, logp, logp_acc)
            accepts.append(accept)
        cfgs.append(y_acc)
        logqs.append(logq_acc)
        logps.append(logp_acc)
    return (torch.stack(cfgs), torch.stack(logqs), torch.stack(logps),
            torch.stack(accepts).reshape(lrand.shape))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_blocks", [1, 4, 16])
def test_block_step_equals_the_old_loop(rng, dtype, n_blocks):
    """``sweep`` through the block step gives the old loop's output bit
    for bit, both with a reference and without one."""
    model = twin_models(rng, jnp.float64, dtype)[1]
    batch, block_len = 3, 64 // n_blocks
    x = torch.tensor(rng.standard_normal((1, 8, 8)), dtype=dtype)
    proposals = torch.tensor(rng.standard_normal((batch, n_blocks,
                                                  block_len)), dtype=dtype)
    lrand = torch.tensor(np.log(rng.random((batch, n_blocks))), dtype=dtype)
    for ref, has_ref in ((0.0, False), (float(rng.standard_normal()), True)):
        with torch.no_grad():
            want = _old_sweep(model, x, ref, has_ref, proposals, lrand)
        got = model.blocked_mcmc.sweep(x, ref, has_ref, proposals, lrand)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_blocked_sample__draws_and_restores_ref(twins):
    """Two calls of the port's blocked sampler: the second restores the
    latent state through ``net_.backward`` and continues the chain."""
    _, model = twins
    cfgs, logq, logp = model.blocked_mcmc.sample__(3, n_blocks=4,
                                                   bookkeeping=True)
    assert cfgs.shape == (3, 8, 8) and torch.isfinite(logq).all()
    _close(logp, -model.action(cfgs))
    _close(logq, model.posterior.log_prob(cfgs), atol=1e-9)
    model.blocked_mcmc.sample__(2, n_blocks=2)
    h = model.blocked_mcmc.history
    assert len(h.accept_rate) == 2 and h.accept_seq[0].shape == (12,)
    with pytest.raises(ValueError, match="divide"):
        model.blocked_mcmc.sample__(1, n_blocks=5)


# --------------------------------------------------------------------- #
# host helpers and history
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3])
def test_metropolis_helpers_identical(seed):
    logqp = np.random.default_rng(seed + 100).standard_normal(200) * 1.5
    got = nt.Metropolis.calc_accept_status(
        logqp, rng=np.random.default_rng(seed))
    want = jmcmc.Metropolis.calc_accept_status(
        logqp, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    for name in ("calc_accept_indices", "calc_accept_count"):
        np.testing.assert_array_equal(getattr(nt.Metropolis, name)(got),
                                      getattr(jmcmc.Metropolis, name)(want))
    np.testing.assert_array_equal(
        nt.Metropolis.calc_tau_rejections_prob(got, max_tau=7),
        jmcmc.Metropolis.calc_tau_rejections_prob(want, max_tau=7))


@pytest.mark.parametrize("tau", [0, 0.1, 2.0])
def test_modified_metropolis_identical(tau):
    logqp = np.random.default_rng(7).standard_normal(300)
    got = nt.ModifiedMetropolis.calc_accept_status(
        logqp, logqp_ref=0.3, tau=tau, rng=np.random.default_rng(1))
    want = jmcmc.ModifiedMetropolis.calc_accept_status(
        logqp, logqp_ref=0.3, tau=tau, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)


def _zerodim(seed=5):
    return nt.Model(net_=DistConvertor(10, **F64),
                    prior=priors.NormalPrior(shape=(1,), **F64),
                    action=ScalarPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5),
                    seed=seed)


def test_report_summary_keys():
    """As ``tests/test_mcmc.py:101-108, 230-243``."""
    model = _zerodim()
    model.mcmc.sample_chain(3, 32)
    out = model.mcmc.history.report_summary()
    assert "accept_rate" in out and "logqp" not in out
    model.mcmc.sample__(16, bookkeeping=True)
    h = model.mcmc.history
    assert len(h.logq) == 1 and len(h.raw_logq) == 1
    assert len(h.accept_seq) == 1 and len(h.accept_ind) == 1
    assert set(h.report_summary(asstr=True)) == {"logqp", "logz",
                                                 "accept_rate"}
    _close(h.logqp[0], h.logq[0] - h.logp[0], atol=0)
    _close(h.raw_logqp[0], h.raw_logq[0] - h.raw_logp[0], atol=0)
    model.mcmc.reset()
    assert model.mcmc._ref is None and not h.accept_rate


def test_scanned_samplers_bookkeeping():
    """As ``tests/test_mcmc.py:207-227``."""
    model = _zerodim()
    model.mcmc.sample_chain(3, 16, bookkeeping=True)
    h = model.mcmc.history
    assert len(h.raw_logq) == 3 and len(h.logq) == 3
    assert len(h.accept_seq) == 3 and len(h.accept_ind) == 3
    assert h.raw_logq[0].shape == (16,)
    for seq, ind in zip(h.accept_seq, h.accept_ind):
        np.testing.assert_array_equal(
            ind, nt.Metropolis.calc_accept_indices(seq))
    assert set(h.report_summary()) == {"logqp", "logz", "accept_rate"}
    model2 = _zerodim()
    model2.mcmc.sample_parallel_chains(4, 8, bookkeeping=True)
    h2 = model2.mcmc.history
    assert len(h2.raw_logq) == 4 and len(h2.logq) == 4
    assert h2.accept_seq[0].shape == (8,) and not h2.accept_ind


def test_chain_sees_sample__between_calls():
    """A ``sample__`` between two chains moves the chain's reference, and
    the second chain starts from it."""
    model = _zerodim()
    model.mcmc.sample_chain(2, 16)
    y, logq, logp = model.mcmc.sample__(16)
    ref = tuple(t.clone() for t in model.mcmc._ref)
    _close(ref[0], y[-1], atol=0)
    seen = []
    body = model.mcmc.chain_body

    def spy(batch_size, generator, carry):
        seen.append(tuple(t.clone() for t in carry))
        return body(batch_size, generator, carry)

    model.mcmc.chain_body = spy
    out = model.mcmc.sample_chain(2, 16, collect_samples=True)
    for g, w in zip(seen[0], ref):
        _close(g, w, atol=0)
    _close(model.mcmc._ref[0], out["samples"][-1, -1], atol=0)
    assert len(model.mcmc.history.accept_rate) == 5


def test_serial_generator_and_the_rest():
    model = _zerodim()
    out = list(model.mcmc.serial_sample_generator(5, batch_size=2))
    assert len(out) == 5 and out[0][0].shape == (1, 1)
    mean, std = model.mcmc.calc_accept_rate(n_samples=64, batch_size=16)
    assert 0 <= mean <= 1 and std >= 0
    assert model.mcmc.estimate_accept_rate(np.zeros(8))[0] == 1.0
    y = torch.tensor([[0.5], [1.0]], dtype=torch.float64)
    _close(model.mcmc.log_prob(y, action_logz=0.2),
           -model.action(y) - 0.2, atol=0)
    assert model.mcmc.sample(4).shape == (4, 1)
    assert len(model.mcmc.sample_(4)) == 2


def test_exports():
    for name in ("MCMCSampler", "BlockedMCMCSampler", "MCMCHistory",
                 "Metropolis", "ModifiedMetropolis", "accept_scan",
                 "estimate_accept_rate"):
        assert getattr(nt.mcmc, name) is getattr(nt, name)
    assert nt.observables.phi2 is obs.phi2
    assert nt.UniformPrior is priors.UniformPrior


# --------------------------------------------------------------------- #
# priors
# --------------------------------------------------------------------- #
def test_uniform_prior_matches_jax(rng):
    low, high = rng.uniform(-2, 0, (3, 4)), rng.uniform(0.5, 2, (3, 4))
    jp = jpriors.UniformPrior.build(low, high)
    p = priors.UniformPrior(low, high, **F64)
    x = rng.uniform(-2.5, 2.5, (5, 3, 4))
    for density in (False, True):
        _close(p.log_prob(_t(x), density=density),
               jp.log_prob(jnp.asarray(x), density=density), atol=1e-12)
    assert p.nvar == jp.nvar == 12
    s = p.sample(100, torch.Generator().manual_seed(0))
    assert s.shape == (100, 3, 4)
    assert bool(((s >= p.low) & (s <= p.high)).all())
    assert torch.isfinite(p.log_prob(s)).all()


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_chopped_matches_jax(rng, kind):
    if kind == "normal":
        jp = jpriors.NormalPrior.build(loc=np.full((4, 4), 0.3),
                                       scale=np.full((4, 4), 1.7))
        p = priors.NormalPrior(np.full((4, 4), 0.3), np.full((4, 4), 1.7),
                               **F64)
    else:
        jp = jpriors.UniformPrior.build(np.full((4, 4), -1.0),
                                        np.full((4, 4), 2.0))
        p = priors.UniformPrior(np.full((4, 4), -1.0), np.full((4, 4), 2.0),
                                **F64)
    c, jc = p.chopped(8), jp.chopped(8)
    assert c.shape == jc.shape == (8,) and c.nvar == 8
    x = rng.uniform(-0.9, 1.9, (6, 8))
    _close(c.log_prob(_t(x)), jc.log_prob(jnp.asarray(x)), atol=1e-12)


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_per_site_prior_cannot_be_chopped(rng, kind):
    a = rng.uniform(0.1, 0.5, (2, 3))
    cls = priors.NormalPrior if kind == "normal" else priors.UniformPrior
    with pytest.raises(ValueError, match="homogeneous"):
        cls(a, a + 1.0, **F64).chopped(3)


def test_prior_list_matches_jax(rng):
    shapes = ((2, 3), (4,))
    jp = jpriors.PriorList(priors=(
        jpriors.NormalPrior.build(shape=shapes[0]),
        jpriors.UniformPrior.build(np.full(4, -1.0), np.full(4, 1.0))))
    p = priors.PriorList([priors.NormalPrior(shape=shapes[0], **F64),
                          priors.UniformPrior(np.full(4, -1.0),
                                              np.full(4, 1.0), **F64)])
    assert p.nvar == jp.nvar == 10
    xs = [rng.standard_normal((5, 2, 3)), rng.uniform(-1.5, 1.5, (5, 4))]
    for density in (False, True):
        for g, w in zip(p.log_prob([_t(x) for x in xs], density=density),
                        jp.log_prob([jnp.asarray(x) for x in xs],
                                    density=density)):
            _close(g, w, atol=1e-12)
    gen = torch.Generator().manual_seed(4)
    a, logr = p.sample_(3, gen)
    gen.manual_seed(4)  # in order, from the one generator
    want = [q.sample(3, gen) for q in p.priors]
    for g, w in zip(a, want):
        _close(g, w, atol=0)
    assert [t.shape for t in logr] == [(3,), (3,)]
    assert p.device == torch.device("cpu") and p.dtype == torch.float64


def test_model_device_from_any_prior():
    for prior in (priors.UniformPrior(shape=(1,), **F64),
                  priors.PriorList([priors.UniformPrior(shape=(1,), **F64)])):
        model = nt.Model(net_=DistConvertor(4, **F64), prior=prior,
                         action=ScalarPhi4Action(kappa=0, m_sq=-1.2,
                                                 lambd=0.5))
        assert model.device == torch.device("cpu")


# --------------------------------------------------------------------- #
# observables
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [
    ("phi2", {}), ("abs_mean_phi", {}), ("susceptibility", {}),
    ("binder_cumulant", {}), ("two_point_function", {}),
    ("two_point_function", dict(axis=2)),
    ("two_point_function", dict(connected=False))])
def test_observables_match_jax(rng, name, kw):
    cfgs = rng.standard_normal((16, 6, 8)) + 0.3
    got = getattr(obs, name)(_t(cfgs), **kw)
    want = getattr(jobs, name)(jnp.asarray(cfgs), **kw)
    _close(got, want, atol=1e-12)


@pytest.mark.parametrize("name", ["integrated_autocorr_time",
                                  "effective_sample_size"])
def test_chain_metrology_matches_jax(rng, name):
    x = np.zeros(500)
    for i in range(1, 500):  # an AR(1) chain
        x[i] = 0.8 * x[i - 1] + rng.standard_normal()
    got = getattr(obs, name)(_t(x))
    want = getattr(jobs, name)(x)
    assert got == pytest.approx(want, rel=1e-12)


# --------------------------------------------------------------------- #
# entry API
# --------------------------------------------------------------------- #
def test_transform_raw_dist_and_posterior_sample(rng, twins):
    jmodel, model = twins
    x = rng.standard_normal((B, 8, 8))
    _close(model.transform(_t(x)).detach(),
           jax.jit(jmodel.transform)(jnp.asarray(x)))
    assert model.raw_dist is model.posterior
    model.seed(3)
    y = model.posterior.sample(4)
    model.seed(3)
    _close(y, model.posterior.sample_(4)[0], atol=0)


def test_preprocess_func(twins):
    """``preprocess_func(x, logr)`` acts on the prior's draw before the
    flow, as in ``normflow__tpu/training/model.py:75-95``."""
    _, model = twins
    pre = lambda x, logr: (2 * x, logr - 64 * np.log(2.0))  # noqa: E731
    model.seed(3)
    y, logq, logp = model.posterior.sample__(4, preprocess_func=pre)
    model.seed(3)
    x, logr = pre(*model.prior.sample_(4, model.generator))
    _close(y, model.transform(x).detach(), atol=0)
    _close(logp, -model.action(y), atol=0)
    with torch.no_grad():
        _, mlogj = model.net_.forward(x)
    _close(logq, logr - mlogj, atol=0)


# --------------------------------------------------------------------- #
# statistical parity: the zero-dim model, fitted once
# --------------------------------------------------------------------- #
def _exact_phi2(m_sq=-1.2, lambd=0.5):
    phi = np.linspace(-6, 6, 20001)
    s = 0.5 * m_sq * phi ** 2 + lambd * phi ** 4
    w = np.exp(-s + s.min())
    return float((phi ** 2 * w).sum() / w.sum())


@pytest.fixture(scope="module")
def fitted():
    model = _zerodim(seed=11)
    model.fit(n_epochs=300, batch_size=256,
              hyperparam=dict(lr=0.01, weight_decay=0.0),
              checkpoint_dict=dict(print_stride=None))
    return model


def _phi2_within(phi2, tau):
    exact = _exact_phi2()
    err = phi2.std() / np.sqrt(len(phi2) / tau)
    assert abs(phi2.mean() - exact) < 5 * err + 0.01, (phi2.mean(), exact)


def test_exactness_sample_chain(fitted):
    fitted.mcmc.reset()
    out = fitted.mcmc.sample_chain(16, 1024, collect_samples=True)
    _phi2_within(out["samples"].numpy().ravel() ** 2, 10)
    assert float(out["accept_rate"].mean()) > 0.8


def test_exactness_parallel_chains(fitted):
    out = fitted.mcmc.sample_parallel_chains(32, 1024, collect_samples=True)
    _phi2_within(out["samples"][4:].numpy().ravel() ** 2, 5)
    assert float(np.mean(out["accept_rate"][1:])) > 0.85
    assert out["final_samples"].shape == (1024, 1)


def test_exactness_blocked(fitted):
    fitted.blocked_mcmc.reset()
    y, logq, logp = fitted.blocked_mcmc.sample__(256, n_blocks=1)
    assert y.shape == (256, 1)
    _phi2_within(y.numpy().ravel() ** 2, 10)
    assert 0.5 < fitted.blocked_mcmc.history.accept_rate[-1] <= 1.0
