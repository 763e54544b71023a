"""Port parity of the model core's leftovers, the profiling hooks, the
package namespaces and the examples' devices, on the CPU.

``FlowList.hack`` and ``PSDBlock.hack`` return the JAX intermediates to
1e-10 in float64; the weight blob round-trips and refuses another
architecture; ``freeze_parameters`` / ``unfreeze_parameters`` return copies;
``DistConvertor``'s layer properties and ``inv_softplus_log2`` agree with
JAX; ``profile_fn``, ``Timer`` and ``trace`` run on the CPU (``trace``
writes the host's operators there);
``models``, ``training``, ``utils``, ``nn``, ``nn.scalar``, the package
top and ``ops`` / ``lib`` export every name the JAX namespaces do, but the
JAX-only ones listed here, and ``segment_gather`` agrees with JAX; the
zero-dim example trains on the CPU, and ``scalar_affine``'s
``n_devices=2`` runs in a 2-rank gloo group.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflow__tpu as jnf
import normflow__tpu.models as jmodels
import normflow__tpu.ops as jops
import normflow__tpu.nn as jnn
import normflow__tpu.nn.scalar as jnn_scalar
import normflow__tpu.training as jtraining
import normflow__tpu.utils as jutils
from normflow__tpu.models import elementwise as je
import normflow__tpu_torch as nt
import normflow__tpu_torch.models as tmodels
import normflow__tpu_torch.nn as tnn
import normflow__tpu_torch.nn.scalar as tnn_scalar
import normflow__tpu_torch.ops as tops
import normflow__tpu_torch.training as ttraining
import normflow__tpu_torch.utils as tutils
from normflow__tpu_torch.models import elementwise as te
from normflow__tpu_torch.models.core import Frozen
from normflow__tpu_torch.tools import kernel_times as kt
from normflow__tpu_torch.utils.profiling import Timer, profile_fn, trace
from normflow__tpu_torch.zoo import build_phi4_model
from test_torch_flagship import twin_models

import _torch_ddp_worker as W

TOL = 1e-10
# JAX-only names: the flax leaf-dict helpers behind the JAX blob and
# snapshot formats (the port's blob is its own torch.save of the
# state_dict)
JAX_ONLY = {"utils": {"serialization"},
            "package": {"jax", "jnp", "np", "struct"}}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@pytest.fixture
def twins(rng):
    return twin_models(rng, jnp.float64, torch.float64)


def test_flowlist_and_psd_block_hack_match_jax(twins, rng):
    jmodel, model = twins
    x = rng.standard_normal((4, 8, 8))
    with torch.no_grad():
        got = model.net_.hack(torch.from_numpy(x))
        got_psd = model.net_[0].hack(torch.from_numpy(x), 0.5)
    want = jmodel.net_.hack(jnp.asarray(x))
    want_psd = jmodel.net_.flows[0].hack(jnp.asarray(x), 0.5)
    assert len(got) == len(want) == 5 and len(got_psd) == len(want_psd) == 4
    for (gx, gl), (wx, wl) in zip(got + got_psd, want + want_psd):
        _close(gx, wx)
        _close(gl, wl)
    with torch.no_grad():
        y, logj = model.net_.forward(torch.from_numpy(x))
    _close(got[-1][0], y)
    _close(got[-1][1], logj)
    assert model.net_[0]._hack == model.net_[0].hack


def test_weights_blob_round_trip_and_shape_error():
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device="cpu", dtype=torch.float64, seed=1)
    blob = model.net_.get_weights_blob()
    assert isinstance(blob, str)
    other = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device="cpu", dtype=torch.float64, seed=2)
    restored = other.net_.set_weights_blob(blob + "\n")
    assert restored is not other.net_  # a copy, as in JAX
    for p, q in zip(restored.parameters(), model.net_.parameters()):
        assert torch.equal(p, q)
    assert not all(torch.equal(p, q) for p, q in zip(
        other.net_.parameters(), model.net_.parameters()))
    wider = build_phi4_model((8, 8), knots=4, hidden=(6,), n_layers=2,
                             device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="architecture mismatch"):
        wider.net_.set_weights_blob(blob)


def test_freeze_and_unfreeze_parameters_return_copies():
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device="cpu")
    frozen = model.net_.freeze_parameters()
    assert all(isinstance(f, Frozen) for f in frozen.flows)
    assert not any(p.requires_grad for p in frozen.parameters())
    assert all(p.requires_grad for p in model.net_.parameters())
    assert not any(tmodels.trainable_mask(frozen).values())
    thawed = frozen.unfreeze_parameters()
    assert not any(isinstance(f, Frozen) for f in thawed.flows)
    assert all(p.requires_grad for p in thawed.parameters())
    assert not any(p.requires_grad for p in frozen.parameters())
    x = torch.randn(3, 8, 8)
    with torch.no_grad():
        for net in (frozen, thawed):
            y, logj = net.forward(x)
            assert torch.equal(y, model.net_.forward(x)[0])


@pytest.mark.parametrize("kw", [dict(), dict(sgnbias=True, final_scale=True),
                                dict(initial_scale=True)])
@pytest.mark.parametrize("knots", [1, 6])
def test_dist_convertor_layers(kw, knots):
    jflow = je.DistConvertor.build(knots, symmetric=True, **kw)
    tflow = te.DistConvertor(knots, **kw)
    for name in ("spline_layer", "scale_layer", "sgnbias_layer"):
        j, t = getattr(jflow, name), getattr(tflow, name)
        assert (j is None) == (t is None), name
        if t is not None:
            assert type(t).__name__ == type(j).__name__
            assert t is next(f for f in tflow.flows if type(f) is type(t))


def test_inv_softplus_log2_matches_jax():
    y = np.array([1e-3, 0.5, 1.0, 2.0, 30.0])
    got = te.inv_softplus_log2(torch.from_numpy(y))
    _close(got, je.inv_softplus_log2(jnp.asarray(y)))
    _close(te.softplus_log2(got), y, 1e-12)


def test_profile_fn_and_timer_on_the_cpu(capsys, tmp_path):
    calls = []
    stats = profile_fn(lambda a, b=0: calls.append(a + b), 1, b=2, iters=5,
                       warmup=3)
    assert len(calls) == 8 and stats["iters"] == 5
    assert 0 <= stats["min"] <= stats["median"] and stats["mean"] >= 0
    with Timer("block") as t:
        torch.ones(3).sum()
    assert t.elapsed >= 0 and "[block]" in capsys.readouterr().out
    with Timer(verbose=False) as quiet:
        pass
    assert quiet.elapsed >= 0 and capsys.readouterr().out == ""
    if not torch.cuda.is_available():  # a CPU window: no card needed
        with trace(str(tmp_path / "tr")) as logdir:
            torch.ones(3).sum()
        assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    """Without a card ``trace`` records the block's host operators to
    ``logdir/trace.json``, as JAX's trace does on any backend."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: trace opens the card's window")
    model = build_phi4_model((4, 4), hidden=(4,), n_layers=2, knots=4,
                             device="cpu")
    with trace(str(tmp_path / "tr")) as logdir:
        model.posterior.logqp_stream(1, 8)
    with open(f"{logdir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any("conv" in n for n in names)


def test_profiler_window_body():
    """The body of a profiled window lies between its two marker kernels;
    a window that lost its closing marker still has its opening one
    followed by the body; one that lost the opening marker raises."""
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    head = [(t, "add", 1.0) for t in range(3)]
    body = [(5, "rqs_coupling_tiled_kernel", 2.0), (6, "add", 3.0)]
    closes = len(kt.CLOSE_LOSSES)
    full = head + [(4, mark, 1.0)] + body + [(7, mark, 1.0)]
    want = [(n, us) for _, n, us in body]
    assert kt.window_body(full) == want
    assert kt.HEAD_LOSSES[-1] == kt.HEAD_NODES - 3
    assert kt.window_body(full[:-1]) == want  # the closing marker lost
    assert len(kt.CLOSE_LOSSES) == closes + 1
    for lost in (head + body + [(7, mark, 1.0)], head + body):
        with pytest.raises(RuntimeError, match="marker kernels"):
            kt.window_body(lost)


def test_gc_paused_around_a_capture():
    """A capture runs with the cyclic collector off, after one collection
    (a dead graph freed inside a capture would fail it), and the collector
    comes back on after, also when the body raises."""
    import gc
    import weakref

    from normflow__tpu_torch.utils.graphs import gc_paused

    class Cycle:
        pass

    def dead_cycle():
        a = Cycle()
        a.self = a
        return weakref.ref(a)

    assert gc.isenabled()
    gc.disable()  # the cycle stays until gc_paused collects it
    try:
        ref = dead_cycle()
        assert ref() is not None
    finally:
        gc.enable()
    with gc_paused():
        assert not gc.isenabled() and ref() is None
    assert gc.isenabled()
    with pytest.raises(ZeroDivisionError):
        with gc_paused():
            1 / 0
    assert gc.isenabled()


@pytest.mark.parametrize("name,jax_mod,port_mod", [
    ("models", jmodels, tmodels), ("training", jtraining, ttraining),
    ("utils", jutils, tutils), ("nn", jnn, tnn),
    ("nn.scalar", jnn_scalar, tnn_scalar), ("package", jnf, nt),
    ("ops", jops, tops), ("lib", jnf.lib, nt.lib)])
def test_namespaces_export_the_jax_names(name, jax_mod, port_mod):
    """Every public name of the JAX namespace but its JAX-only ones; the
    same ``__all__``, which the package top extends with the port's own
    entry names."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    jax_only = JAX_ONLY.get(name, set())
    want = public(jax_mod)
    missing = want - public(port_mod) - jax_only
    assert not missing, missing
    if hasattr(jax_mod, "__all__"):
        wanted = set(jax_mod.__all__) - jax_only
        if name == "package":
            assert wanted <= set(port_mod.__all__)
        else:
            assert set(port_mod.__all__) == wanted
    for n in jax_only:
        assert n in want and not hasattr(port_mod, n)


def test_lib_names_resolve():
    """``normflow__tpu_torch.lib.rqs`` and the other 14 names of the JAX
    ``lib``, and ``segment_gather`` against the JAX one on numpy inputs."""
    from normflow__tpu.ops import spline as jspline

    for n in jnf.lib.__all__:
        assert getattr(nt.lib, n) is getattr(tops, n)
    assert nt.lib.rqs is nt.ops.spline.rqs
    rng = np.random.default_rng(3)
    params = rng.standard_normal((5, 7, 9))
    idx = rng.integers(0, 7, (5, 7))
    for offset in (0, 1):
        want = jspline.segment_gather(jnp.asarray(params), jnp.asarray(idx),
                                      offset, 8)
        got = nt.lib.spline.segment_gather(torch.from_numpy(params),
                                           torch.from_numpy(idx), offset, 8)
        _close(got, want, tol=0.0)


def test_cntr_names_everywhere():
    from normflow__tpu_torch.nn.scalar import cntr_couplings_ as scalar

    for n in ("DirectCntrCoupling", "CntrCoupling", "CntrShiftCoupling",
              "CntrAffineCoupling", "CntrRQSplineCoupling",
              "CntrMultiRQSplineCoupling"):
        obj = getattr(tmodels, n)
        assert getattr(tnn, n) is obj and getattr(tnn, n + "_") is obj
        assert getattr(scalar, n + "_") is obj
    assert tmodels.couplings.has_controls is not None
    assert nt.zoo.with_conv_compute_dtype is not None


def test_scalar_zerodim_example_on_the_cpu():
    from normflow__tpu_torch.examples import scalar_zerodim

    model = scalar_zerodim.main(n_epochs=30, batch_size=128, device="cpu")
    loss = model.fit.train_history["loss"]
    assert len(loss) == 30 and np.isfinite(loss).all()
    assert loss[-1] < loss[0]
    assert model.device.type == "cpu" and model.prior.shape == (1,)


def test_scalar_affine_n_devices_in_a_two_rank_group():
    """``n_devices=2``: the batch shards over a 2-rank gloo group, and both
    ranks end with the same parameters."""
    handler = W.small_model().device_handler
    ranks = handler.spawnprocesses(W.affine_rank, 2, 3)
    (r0, n0, p0, loss0), (r1, n1, p1, loss1) = ranks
    assert (r0, r1) == (0, 1) and n0 == n1 == 2
    assert np.array_equal(p0, p1)
    assert len(loss0) == 3 and np.isfinite(loss0).all() and loss1 == []
