"""The port's bench: effective samples/s of the 32x32 phi^4 flagship::

    python3 -m normflow__tpu_torch.bench [--train_epochs 96000] [--reps 5]

Counterpart of the JAX package's bench protocol (root ``bench.py:225-436``),
run through the port's entry points on one CUDA card (``--device cpu`` for
a small check on the CPU):

1. build the flagship (``zoo.build_phi4_model`` with ``--lat``,
   ``--n_layers``, ``--knots``, ``--hidden``, ``--seed``), float32, TF32
   off for the convolutions;
2. train ``--train_epochs`` steps at ``--train_batch`` with the protocol's
   settings (AdamW lr 3e-3, weight decay 1e-4, cosine decay to 0.05, path
   gradient, gradient-norm clip 25, ``--steps_per_call`` steps per
   segment) through ``model.fit``, which replays one captured training
   step;
3. the sampling arms (:func:`sampling_arms`), root ``bench.py``'s
   ``xla`` / ``xla_bf16`` / ``pallas_reg`` (l.289-352): ``cuda``, the
   trained flow, ``cuda_bf16``, the same weights with bf16 conditioners
   (``zoo.with_conv_compute_dtype``), and ``cuda_reg``, the same weights
   with float32 conditioners on the channels-last route
   (``zoo.with_coupling_backend(net_, "pallas_reg")``), each on a
   ``Model`` of its own so that each keeps its captured batches; on the
   CPU the one arm ``cpu`` (root ``bench.py`` runs its other arms on its
   accelerator only); root ``bench.py``'s ``pallas`` arm, the NCHW layout
   of the same kernels, is the ``cuda`` arm's route already;
4. pick the sampling batch from 128/256/512/1024 by raw rate at the
   official ``--sample_iters`` on the bf16 arm where there is one
   (:func:`autotune_batch`), unless ``--batch`` pins it;
5. a first stream of every arm (its capture), then ``--reps`` rounds that
   time ``Posterior.logqp_stream(sample_iters, batch)``, which replays
   one captured batch, of each arm in turn, every round from its own seed
   (:func:`rep_seeds`, :func:`time_reps`; root ``bench.py`` times every
   repetition on one key); no capture falls inside a timed run;
6. each arm's ESS of its last stream and its effective rate (raw rate of
   the median time times ESS); the arm with the higher effective rate is
   kept and reported: its ESS with the bootstrap error
   (:func:`bootstrap_ess_err`), the accept rate with its error, and the
   effective rate with the timing spread and the ESS error in quadrature;
7. the device's idle share over one profiled replay of each graph (the
   kept arm's batch).

Steps 1-2 are the training half (:func:`train`, through
:func:`build_flagship` and :func:`protocol_fit`), steps 3-7 the measuring
half (:func:`measure`), which takes any trained flagship:
``tools/protocol_run.py`` trains it over several calls from snapshots and
then measures it.

It prints one JSON line with root ``bench.py``'s keys (no roofline, no
TPU probe, no ``--rng_impl``), plus
``platform``, the card's name and power limit as ``nvidia-smi`` gives
them, ``train_steps_per_s`` (``model.fit``'s steps over its wall time,
the capture included) and the idle shares.  It keeps its own copies of
root ``bench.py``'s helpers and imports nothing from it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .mcmc.metropolis import estimate_accept_rate
from .ops.stats import calc_ess
from .training.model import Model
from .training.optim import cosine_decay_schedule
from .zoo import (build_phi4_model, with_conv_compute_dtype,
                  with_coupling_backend)

__all__ = ["bootstrap_ess_err", "autotune_batch", "rep_seeds", "time_reps",
           "idle_share", "build_flagship", "protocol_fit", "train",
           "sampling_arms", "measure", "main"]

# The reference implementation's effective samples/s for the identical
# 32x32 architecture on a CPU host, as root bench.py records it
# (REFERENCE_EFF_SAMPLES_PER_SEC): raw 220.6 samples/s, ESS 0.0132.
REFERENCE_EFF_SAMPLES_PER_SEC = 2.915


def bootstrap_ess_err(logqp, n_boot=200, seed=123):
    """Bootstrap standard error of the normalized ESS (root
    ``bench.py:60-71``, the same resamples from the same seed)."""
    rng = np.random.default_rng(seed)
    logqp = np.asarray(logqp)
    n = logqp.shape[0]
    vals = [float(calc_ess(torch.from_numpy(logqp[rng.integers(0, n, n)]),
                           0.0))
            for _ in range(n_boot)]
    return float(np.std(vals))


def _synchronize(model):
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def _timed_stream(model, iters, batch, seed):
    """``(seconds, logqp)`` of one ``logqp_stream(iters, batch)`` from the
    model's generator seeded with ``seed``, ending in a synchronise."""
    model.generator.manual_seed(seed)
    _synchronize(model)
    t0 = time.perf_counter()
    logqp = model.posterior.logqp_stream(iters, batch)
    _synchronize(model)
    return time.perf_counter() - t0, logqp


def autotune_batch(model, candidates=(128, 256, 512, 1024), iters=50,
                   reps=3, seed=2):
    """Pick the sampling batch by raw rate: a first stream at each
    candidate (its capture), then ``reps`` rounds that time each candidate
    in turn at the caller's ``iters``, the scan length that will be timed.
    Returns ``(best_batch, {batch: raw samples/s})``, the rate of the
    median time."""
    for b in candidates:
        _timed_stream(model, iters, b, seed)
    times = {b: [] for b in candidates}
    for _ in range(reps):
        for b in candidates:
            times[b].append(_timed_stream(model, iters, b, seed)[0])
    rate = {b: iters * b / statistics.median(ts) for b, ts in times.items()}
    best = max(rate, key=rate.get)
    return best, {b: round(r, 1) for b, r in rate.items()}


def rep_seeds(seed, reps):
    """A distinct generator seed for each timed repetition."""
    return [seed + 101 + r for r in range(reps)]


def time_reps(arms, iters, batch, seeds):
    """``arms`` maps a name to a model.  One warm-up stream of each arm,
    then for each seed one timed ``logqp_stream(iters, batch)`` of each
    arm in turn.  Returns ``({arm: seconds per run}, {arm: its last run's
    logqp})``."""
    for model in arms.values():
        _timed_stream(model, iters, batch, seeds[0])
    times, logqp = {a: [] for a in arms}, {}
    for s in seeds:
        for a, model in arms.items():
            dt, logqp[a] = _timed_stream(model, iters, batch, s)
            times[a].append(dt)
    return times, logqp


def idle_share(fn, reps=3):
    """The card's idle share over ``reps`` calls of ``fn()``: one minus
    the device time of every activity the profiler saw over the host wall
    time of the loop (ending in a synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    if busy <= 0:
        raise RuntimeError("the profiler saw no device activity")
    return 1.0 - busy / wall


def card_name_and_power():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m normflow__tpu_torch.bench",
        description="Effective samples/s of the 32x32 phi^4 flagship on "
                    "one CUDA card (root bench.py's protocol).")
    p.add_argument("--train_epochs", type=int, default=96000)
    p.add_argument("--train_batch", type=int, default=512)
    p.add_argument("--batch", type=int, default=0,
                   help="sampling batch; 0 picks it from 128/256/512/1024 "
                        "by raw rate")
    p.add_argument("--sample_iters", type=int, default=400)
    p.add_argument("--steps_per_call", type=int, default=1000)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--lat", type=int, default=32)
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--knots", type=int, default=8)
    p.add_argument("--hidden", type=int, nargs="*", default=[24, 24])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grad_estimator", default="path",
                   choices=["rep", "path"])
    p.add_argument("--clip", type=float, default=25.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu, for a small check")
    return p.parse_args(argv)


def build_flagship(args):
    """The flagship of ``args`` (``--lat``, ``--n_layers``, ``--knots``,
    ``--hidden``, ``--seed``, ``--device``), float32; on the card TF32
    off for the convolutions and matrix products."""
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench: no CUDA device (pass --device cpu "
                               "for a check on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return build_phi4_model((args.lat, args.lat), knots=args.knots,
                            hidden=tuple(args.hidden),
                            n_layers=args.n_layers, seed=args.seed,
                            device=args.device)


def protocol_fit(model, args, n_epochs, decay_steps, save_every=None,
                 snapshot_path=None):
    """``n_epochs`` steps of ``model.fit`` with the protocol's settings
    (AdamW lr 3e-3, weight decay 1e-4, cosine decay over ``decay_steps``
    to 0.05, ``--train_batch``, ``--steps_per_call``,
    ``--grad_estimator``, ``--clip``); with ``snapshot_path`` the fit
    loads it where it exists and saves every ``save_every`` steps.
    Returns the wall seconds, ending in a synchronise."""
    t0 = time.perf_counter()
    model.fit(n_epochs=n_epochs, batch_size=args.train_batch,
              save_every=save_every,
              hyperparam=dict(lr=3e-3, weight_decay=1e-4),
              scheduler=cosine_decay_schedule(
                  1.0, decay_steps=max(decay_steps, 1), alpha=0.05),
              steps_per_call=args.steps_per_call,
              grad_estimator=args.grad_estimator, clip_grad_norm=args.clip,
              checkpoint_dict=dict(print_stride=None,
                                   snapshot_path=snapshot_path))
    _synchronize(model)
    return time.perf_counter() - t0


def train(args):
    """The training half: build the flagship and fit ``--train_epochs``
    steps, the cosine over all of them.  Returns ``(model, seconds)``."""
    model = build_flagship(args)
    return model, protocol_fit(model, args, args.train_epochs,
                               args.train_epochs)


def sampling_arms(model, on_card, seed):
    """The sampling arms of a trained flagship ``model``, by name: on the
    card ``cuda`` (``model`` itself), ``cuda_bf16`` and ``cuda_reg``, each
    copy a ``Model`` of its own on ``model``'s weights, seeded with
    ``seed``; on the CPU ``cpu`` alone."""
    if not on_card:
        return {"cpu": model}

    def arm(net_):
        return Model(net_=net_, prior=model.prior, action=model.action,
                     seed=seed)

    return {"cuda": model,
            "cuda_bf16": arm(with_conv_compute_dtype(model.net_,
                                                     torch.bfloat16)),
            "cuda_reg": arm(with_coupling_backend(model.net_,
                                                  "pallas_reg"))}


def measure(model, args, train_time):
    """The measuring half on a trained ``model``: the sampling arms, the
    autotuned batch (unless ``--batch`` pins it), the timed repetitions,
    ESS and accept with their errors, the idle shares; prints and returns
    the JSON record, which reports ``--train_epochs`` steps trained in
    ``train_time`` seconds."""
    on_card = args.device == "cuda"
    arms = sampling_arms(model, on_card, args.seed)

    batch, batch_table = args.batch, None
    if batch == 0:
        batch, batch_table = autotune_batch(
            arms.get("cuda_bf16", model), iters=args.sample_iters,
            seed=args.seed + 2)
        print(f"[bench] autotuned sampling batch: {batch} "
              f"(raw/s {batch_table})", flush=True)

    seeds = rep_seeds(args.seed, args.reps)
    times_by, logqp_by = time_reps(arms, args.sample_iters, batch, seeds)
    n_per_program = args.sample_iters * batch
    med = {a: statistics.median(t) for a, t in times_by.items()}
    eff_by = {a: n_per_program / med[a] * float(calc_ess(logqp_by[a], 0.0))
              for a in arms}
    best = max(eff_by, key=eff_by.get)
    kept, times, logqp = arms[best], times_by[best], logqp_by[best]
    dt = med[best]
    samples_per_sec = n_per_program / dt
    logqp_np = logqp.cpu().numpy()
    ess = float(calc_ess(logqp, 0.0))
    ess_err = bootstrap_ess_err(logqp_np)
    accept, accept_err = estimate_accept_rate(logqp_np, seed=args.seed)
    eff = samples_per_sec * ess
    rel_t = float(np.std(times) / dt) if len(times) > 1 else 0.0
    rel_e = ess_err / max(ess, 1e-12)
    eff_err = eff * float(np.hypot(rel_t, rel_e))

    idle = {"sample": None, "train": None}
    if on_card:
        idle = {"sample": idle_share(
                    lambda: kept.posterior.logqp_stream(1, batch)),
                "train": idle_share(model.fit.step)}

    out = {
        "metric": f"effective samples/s/chip, {args.lat}x{args.lat} phi^4",
        "value": round(eff, 3),
        "unit": "eff_samples/s/chip",
        "vs_baseline": round(eff / REFERENCE_EFF_SAMPLES_PER_SEC, 3),
        "value_err": round(eff_err, 3),
        "raw_samples_per_sec": round(samples_per_sec, 1),
        "timing_spread_s": [round(t, 4) for t in times],
        "ess": round(ess, 4),
        "ess_err": round(ess_err, 4),
        "accept_rate": round(accept, 4),
        "accept_rate_err": round(accept_err, 4),
        "train_epochs": args.train_epochs,
        "n_layers": args.n_layers,
        "grad_estimator": args.grad_estimator,
        "sampling_backend": best,
        "backend_medians_s": {a: round(v, 4) for a, v in med.items()},
        "backend_eff_per_s": {a: round(v, 1) for a, v in eff_by.items()},
        "train_time_s": round(train_time, 1),
        "train_steps_per_s": round(args.train_epochs / train_time, 3),
        "platform": args.device,
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
        "card": card_name_and_power() if on_card else None,
        "sampling_batch": batch,
        "knots": args.knots,
        "rng_impl": "philox" if on_card else "mt19937",
        "rep_seeds": seeds,
        "tf32": False if on_card else None,
        "idle_share_sample_replay": idle["sample"],
        "idle_share_train_replay": idle["train"],
        "baseline": {
            "eff_per_s": REFERENCE_EFF_SAMPLES_PER_SEC,
            "config": "jkomijani/normflow_ (torch), identical 32x32 "
                      "architecture, a CPU host -- the reference's only "
                      "runnable configuration there",
            "caveat": "vs_baseline is a cross-hardware+framework ratio, "
                      "not a same-silicon speedup",
        },
    }
    if batch_table is not None:
        out["batch_autotune_raw_per_s"] = batch_table
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    """Run the protocol: :func:`train`, then :func:`measure`; print and
    return its JSON record."""
    args = parse_args(argv)
    model, train_time = train(args)
    return measure(model, args, train_time)


if __name__ == "__main__":
    main()
