#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``normflow__tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc`` (the kernels are built from
``normflow__tpu_torch/csrc/`` into ``normflow__tpu_torch/_build/`` at first
use) and imports nothing of JAX.  Phases, each of which raises on failure:

1. the card's name and power limit; TF32 off; build the kernels;
2. every kernel of the sampling path against its plain PyTorch version on
   the card, at the flagship's shapes, with the tolerances stated below;
3. each kernel's time (CUDA events, median), its plain version's time, and
   the least time the card could take (bytes or operations over the peak);
4. the main path: the full-width 32x32 phi^4 flagship with seeded perturbed
   weights, compared GPU vs CPU, then ``logqp_stream`` -> ESS and
   acceptance, ``mcmc.sample__`` twice, ``backward_sanitychecker``, with
   every launch counter set to 0 just before the stream and read after it.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# tolerances (float32 on the card)
RQS_TOL = 1e-4          # max |dy| and max |d log g|, as the Pallas tests use
PHI4_REL_TOL = 2e-5     # max |dS| / max(1, |S|), as the Pallas tests use
LOGQ_REL_TOL = 1e-5     # GPU vs CPU per-sample logq, TF32 off
SANITY_TOL = 1e-5       # mean per-site |x - backward(forward(x))|

# the card's published peaks (NVIDIA data sheets), keyed by a part of the
# name nvidia-smi reports: memory bytes/s and float32 (non-tensor) FLOP/s
PEAKS = (("H100 NVL", 3.9e12, 60e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))

N_BATCHES, BATCH = 32, 1024
LAT = (32, 32)


def card_peaks(name):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks recorded for the card {name!r}")


def time_ms(fn, reps=50, warmup=5):
    """Median milliseconds of ``fn()`` on the card, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, reps):
    """Run ``fn()`` ``reps`` times under ``torch.profiler``.  Returns the
    host wall seconds of the loop (ending in a synchronise) and
    ``(name, microseconds)`` of every device activity it caused."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_times(fn, plain_fn):
    """Per-call times of a kernel's wrapper and of its plain version:
    device time from the profiler (``ms``, ``plain_ms``), and the CUDA-event
    median of one call, host overhead included (``call_ms``,
    ``plain_call_ms``).  Where the profiler sees no device activity, the
    event times stand in for the device times and ``timing`` says so."""
    out = dict(call_ms=time_ms(fn), plain_call_ms=time_ms(plain_fn, reps=20))
    reps = 20
    dev = [device_profile(f, reps)[1] for f in (fn, plain_fn)]
    if all(dev):
        out.update(ms=sum(us for _, us in dev[0]) / reps / 1e3,
                   plain_ms=sum(us for _, us in dev[1]) / reps / 1e3,
                   timing="torch.profiler device time per call")
    else:
        out.update(ms=out["call_ms"], plain_ms=out["plain_call_ms"],
                   timing="CUDA events per call (profiler saw no device "
                          "time)")
    return out


def bound_ms(nbytes, nops, peaks):
    bw, flops = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(name, t, nbytes, nops, peaks, kernels):
    bms, by = bound_ms(nbytes, nops, peaks)
    kernels[name].update(bound_ms=bms, bound_by=by, **t)
    print(f"{name} {t['timing']}: {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms; one call with host overhead "
          f"{t['call_ms']:.5f} ms, plain {t['plain_call_ms']:.5f} ms; bound "
          f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB); library n/a")


def check_rqs(torch, kernels, peaks, rng):
    """rqs_coupling vs its plain version at B=1024, K3=22, S=32x16.
    Returns the function that times it."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc

    m, b, lat = 8, BATCH, (LAT[0], LAT[1] // 2)
    out = torch.tensor(rng.standard_normal((b, 3 * m - 2, *lat)),
                       dtype=torch.float32, device="cuda")
    worst = 0.0
    for extrap in (None, "linear"):
        if extrap is None:  # no extrapolation: stay inside the box
            x_np = rng.uniform(-3.6, 3.6, (b, *lat))
        else:
            x_np = rng.standard_normal((b, *lat))
        x = torch.tensor(x_np, dtype=torch.float32, device="cuda")
        for inverse in (False, True):
            kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left=extrap,
                      right=extrap, inverse=inverse)
            y, g = sc.rqs_coupling(x, out, **kw)
            yp, gp = sc.rqs_coupling_plain(x, out, **kw)
            torch.cuda.synchronize()
            dy = float((y - yp).abs().max())
            dg = float((g - gp).abs().max())
            print(f"rqs_coupling extrap={extrap} inverse={inverse}: "
                  f"max|dy| {dy:.3e}  max|dlogg| {dg:.3e}  (tol {RQS_TOL})")
            if not (dy <= RQS_TOL and dg <= RQS_TOL):
                raise AssertionError("rqs_coupling disagrees with its plain "
                                     "version")
            worst = max(worst, dy, dg)

    kernels["rqs_coupling"] = dict(
        name="rqs_coupling", route="cuda",
        source="normflow__tpu_torch/csrc/rqs_coupling.cu",
        replaces="normflow__tpu/ops/kernels/spline_coupling.py:121",
        max_abs_err=worst, library_ms=None)

    def time_it():
        """Time the main path's variant: forward, linear extrapolation."""
        kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                  right="linear", inverse=False)
        t = kernel_times(lambda: sc.rqs_coupling(x, out, **kw),
                         lambda: sc.rqs_coupling_plain(x, out, **kw))
        report("rqs_coupling", t, nbytes, nops, peaks, kernels)

    sites = b * math.prod(lat)
    k = m + 2
    nbytes = sites * 4 * (1 + (3 * m - 2) + 2)
    # per site: 2 softmax-cumsum coordinate sets (~7m), m softplus (~8m),
    # K comparisons, 6(K-1) selects, ~40 for the rational map and its log
    nops = sites * (22 * m + k + 6 * (k - 1) + 40)
    return time_it


def check_phi4(torch, kernels, peaks, rng, action):
    """phi4_action vs its plain version, 1-D, 2-D (flagship) and 3-D.
    Returns the function that times it."""
    from normflow__tpu_torch.ops.kernels import phi4

    worst_abs = 0.0
    for shape in ((BATCH, 64), (BATCH, *LAT), (64, 8, 8, 8)):
        cfgs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")
        w = action.get_coef(len(shape) - 1)
        got = phi4.phi4_action(cfgs, *w)
        want = phi4.phi4_action_plain(cfgs, *w)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        rel = float((diff / want.abs().clamp(min=1.0)).max())
        print(f"phi4_action {shape}: max rel {rel:.3e} (tol {PHI4_REL_TOL}),"
              f" max abs {float(diff.max()):.3e}")
        if not rel <= PHI4_REL_TOL:
            raise AssertionError("phi4_action disagrees with its plain "
                                 "version")
        worst_abs = max(worst_abs, float(diff.max()))

    kernels["phi4_action"] = dict(
        name="phi4_action", route="cuda",
        source="normflow__tpu_torch/csrc/phi4_action.cu",
        replaces="normflow__tpu/ops/kernels/phi4.py:30",
        max_abs_err=worst_abs, library_ms=None)
    cfgs = torch.tensor(rng.standard_normal((BATCH, *LAT)),
                        dtype=torch.float32, device="cuda")
    w = action.get_coef(2)
    sites = cfgs.numel()
    nbytes = 4 * sites + 4 * BATCH
    nops = sites * (6 + 3 * 2)  # phi^2, phi^4 terms, 2 neighbour products

    def time_it():
        """Time the flagship's shape, (1024, 32, 32)."""
        t = kernel_times(lambda: phi4.phi4_action(cfgs, *w),
                         lambda: phi4.phi4_action_plain(cfgs, *w))
        report("phi4_action", t, nbytes, nops, peaks, kernels)

    return time_it


def perturb_(net, rng, scale=0.3):
    """Seeded noise on every weight: ``scale`` times the init bound on the
    conv weights, N(0, scale^2) on every other weight (the spline weights
    are all zero at build), so no part of the map stays at its identity."""
    import torch

    from normflow__tpu_torch.models.nets import CircularConv
    from normflow__tpu_torch.utils.transplant import jax_leaf_order

    with torch.no_grad():
        for owner, _, p in jax_leaf_order(net):
            s = scale
            if isinstance(owner, CircularConv):
                s = scale / math.sqrt(math.prod(p.shape[1:]))
            noise = rng.standard_normal(tuple(p.shape)) * s
            p.add_(torch.tensor(noise, dtype=p.dtype, device=p.device))


def run_main_path(torch, kernels, rng, card):
    """The flagship sampling path, through the port's entry points."""
    from normflow__tpu_torch import (backward_sanitychecker, calc_ess,
                                     estimate_accept_rate)
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling
    from normflow__tpu_torch.zoo import build_phi4_model

    model = build_phi4_model(LAT, seed=0)
    perturb_(model.net_, rng)
    n_par = sum(p.numel() for p in model.net_.parameters())
    print(f"flagship {LAT}: {n_par} parameters on {model.device}")

    # GPU vs a CPU copy of the same model on the same numpy-seeded draws
    net_cpu = copy.deepcopy(model.net_).cpu()
    prior_cpu = copy.deepcopy(model.prior).cpu()
    x = torch.tensor(rng.standard_normal((BATCH, *LAT)), dtype=torch.float32)
    with torch.no_grad():
        y_gpu, logj_gpu = model.net_.forward(x.cuda())
        logq_gpu = (model.prior.log_prob(x.cuda()) - logj_gpu).cpu()
        y_cpu, logj_cpu = net_cpu.forward(x)
        logq_cpu = prior_cpu.log_prob(x) - logj_cpu
    rel = float(((logq_gpu - logq_cpu).abs()
                 / logq_cpu.abs().clamp(min=1.0)).max())
    dy = float((y_gpu.cpu() - y_cpu).abs().max())
    print(f"GPU vs CPU forward: max rel logq {rel:.3e} (tol {LOGQ_REL_TOL}),"
          f" max|dy| {dy:.3e}")
    if not rel <= LOGQ_REL_TOL:
        raise AssertionError("GPU and CPU flagship disagree")

    model.posterior.logqp_stream(2, BATCH)  # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    spline_coupling.rqs_coupling.launches = 0
    phi4.phi4_action.launches = 0
    t0 = time.perf_counter()
    logqp = model.posterior.logqp_stream(N_BATCHES, BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"rqs_coupling": spline_coupling.rqs_coupling.launches,
                "phi4_action": phi4.phi4_action.launches}
    print(f"launches over logqp_stream({N_BATCHES}, {BATCH}): {launches}")
    n_layers = len(model.net_[2].nets)
    want = {"rqs_coupling": n_layers * N_BATCHES, "phi4_action": N_BATCHES}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    for name, n in launches.items():
        kernels[name]["launches"] = n

    if logqp.shape != (N_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("logqp stream is not finite or has the wrong "
                             "shape")
    ess = float(calc_ess(logqp))
    acc, acc_err = estimate_accept_rate(logqp.cpu().numpy(), seed=0)
    if not (0.0 < ess <= 1.0 and 0.0 <= acc <= 1.0):
        raise AssertionError(f"ESS {ess} / accept rate {acc} out of range")
    print(f"logqp_stream: ESS {ess:.5f}; accept {acc:.5f} +- {acc_err:.5f} "
          "(random perturbed weights, untrained)")
    walls = [seconds]
    for _ in range(4):
        t0 = time.perf_counter()
        model.posterior.logqp_stream(N_BATCHES, BATCH)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rates = sorted(N_BATCHES * BATCH / w for w in walls)
    print(f"logqp_stream({N_BATCHES}, {BATCH}) x{len(walls)}: raw samples/s "
          f"median {statistics.median(rates):.1f}, min {rates[0]:.1f}, max "
          f"{rates[-1]:.1f} (first, counted run: "
          f"{N_BATCHES * BATCH / seconds:.1f}) on {card}")

    for _ in range(2):  # the second call runs from the carried _ref state
        y, logq, logp = model.mcmc.sample__(BATCH)
        torch.cuda.synchronize()
        if y.shape != (BATCH, *LAT) or not all(
                bool(torch.isfinite(t).all()) for t in (y, logq, logp)):
            raise AssertionError("MCMC output not finite or wrong shape")
    print(f"mcmc.sample__ x2: accept rates {model.mcmc.history.accept_rate}")

    n = 64
    x_err, logj_err = backward_sanitychecker(model, n_samples=n,
                                             verbose=False)
    per_site = x_err / (n * math.prod(LAT))
    print(f"backward_sanitychecker: mean per-site |dx| {per_site:.3e} "
          f"(tol {SANITY_TOL}), mean |log0| {logj_err / n:.3e}")
    if not per_site <= SANITY_TOL or not math.isfinite(logj_err):
        raise AssertionError("round trip through the flow failed")
    return model


def profile_batch(model):
    """Where the time of one sampled batch goes on the device."""
    reps = 4
    wall, dev = device_profile(
        lambda: model.posterior.logqp_stream(1, BATCH), reps)
    if not dev:
        raise AssertionError("the profiler saw no device activity in the "
                             "sampled batch")
    busy = sum(us for _, us in dev) / 1e6
    by_name: dict = {}
    for kname, us in dev:
        by_name[kname] = by_name.get(kname, 0.0) + us
    print(f"profile of logqp_stream(1, {BATCH}) x{reps}: wall "
          f"{wall / reps * 1e3:.4f} ms/batch, device busy "
          f"{busy / reps * 1e3:.4f} ms/batch, idle share "
          f"{1 - busy / wall:.4f}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / reps / 1e3:9.4f} ms/batch {us / 1e6 / busy:7.2%}  "
              f"{kname[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.ops.kernels import _lib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    print(card)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: cudnn.allow_tf32 = False, cuda.matmul.allow_tf32 = "
          "False")

    t0 = time.perf_counter()
    _lib.library()
    info = _lib.build_info
    print(f"kernels {'built' if info['built'] else 'loaded'} in "
          f"{time.perf_counter() - t0:.2f} s: {info['path']}")
    with open(info["log"]) as f:
        log = f.read()
    release = re.search(r"release ([\d.]+)", log)
    print(f"nvcc {release.group(1) if release else 'version not in the log'}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"ptxas: {len(regs)} kernels, at most {max(regs)} registers, "
          f"{sum(spills)} bytes of spill stores in all")

    rng = np.random.default_rng(20261016)
    kernels: dict = {}
    action = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5)
    timers = [check_rqs(torch, kernels, peaks, rng),
              check_phi4(torch, kernels, peaks, rng, action)]
    model = run_main_path(torch, kernels, rng, card)
    # profiling last: the main path's times are taken with no profiler on
    for time_it in timers:
        time_it()
    profile_batch(model)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "call_ms", "plain_call_ms", "timing")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
