#!/usr/bin/env python3
"""The flagship's whole training protocol, resumable across calls::

    python3 -m normflow__tpu_torch.tools.protocol_run --dir runs/protocol \
        [--budget_s S] [bench flags]

Root ``bench.py`` and the port's bench train the 32x32 phi^4 flagship for
96,000 steps (``--train_epochs``' default).  This tool runs that protocol
in pieces, on one CUDA card:

1. build the flagship with the bench's defaults (seed 0, 8 knots, hidden
   24, 24, 4 layers; ``bench.build_flagship``);
2. find the newest ``<dir>/flagship.E<n>.pt`` and train from it: each
   piece is one ``model.fit`` through ``bench.protocol_fit`` with that
   snapshot as ``snapshot_path``, which loads the weights, the optimizer
   state (its float64 step count among it) and the generator, trains the
   piece and saves ``flagship.E<n + piece>.pt``.  The cosine schedule
   decays over ``TOTAL`` (96,000) steps in every piece, so it goes on
   from the restored count.  Pieces end on multiples of ``SAVE_EVERY``
   (4000 steps, four of the protocol's 1000-step segments), so a resumed
   run's segments fall where an unbroken run's do;
3. after each piece, a short ESS of the current weights
   (``logqp_stream(50, 1024)`` from a generator of its own, seeded with the
   step count, so the training stream is untouched) and the piece's
   steps/s, appended to ``<dir>/trajectory.jsonl``;
4. with ``--budget_s S`` it starts a piece only where it fits in what is
   left of ``S`` seconds at the rate the last piece measured (the first
   piece is one 1000-step segment, to measure it);
5. once the count reaches ``TOTAL``, on the last snapshot's weights:
   the production samplers (``mcmc.sample_chain``,
   ``mcmc.sample_parallel_chains`` and the blocked sampler), then the
   bench's measuring half (``bench.measure``, whose idle share replays a
   few training steps, which is why it comes last).  It prints the
   trajectory and the samplers' accept rates, then the bench's JSON record
   as its last line.

A call that is cut loses only the piece it was in: the next call resumes
from the newest snapshot (and measures again if the training was done).
Any flag it does not know is the bench's.  The protocol's length is no
flag: ``train`` and ``finish`` take ``total`` for a shorter run (a test's
or the smoke's), and ``main`` always runs ``TOTAL``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import time

import torch

from .. import bench
from ..ops.stats import calc_ess

__all__ = ["TOTAL", "SAVE_EVERY", "newest_snapshot", "read_trajectory",
           "train", "finish", "main"]

TOTAL = 96000        # the protocol's steps (root bench.py's default)
SAVE_EVERY = 4000    # a multiple of the protocol's 1000 steps per segment
ESS_STREAM = (50, 1024)  # the ESS at each snapshot: batches, batch size
BASE = "flagship"
TRAJECTORY = "trajectory.jsonl"


def newest_snapshot(directory):
    """``(path, steps)`` of the newest ``<directory>/flagship.E<n>.pt``,
    ``(None, 0)`` where there is none."""
    best = (None, 0)
    for path in glob.glob(os.path.join(directory, f"{BASE}.E*.pt")):
        m = re.fullmatch(rf"{BASE}\.E(\d+)\.pt", os.path.basename(path))
        if m and (best[0] is None or int(m.group(1)) > best[1]):
            best = (path, int(m.group(1)))
    return best


def read_trajectory(directory):
    """The records of ``<directory>/trajectory.jsonl``, in order."""
    path = os.path.join(directory, TRAJECTORY)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _ess(model, generator, step, stream):
    """ESS of ``logqp_stream(*stream)`` drawn from ``generator`` seeded
    with ``step``."""
    generator.manual_seed(step)
    return float(calc_ess(model.posterior.logqp_stream(
        *stream, generator=generator), 0.0))


def _piece(n, total, save_every, steps_per_call, rate, left, steps_left):
    """Steps of the next piece from count ``n``: to the next multiple of
    ``save_every``, at most ``total - n`` and ``steps_left``; with a budget
    (``left`` seconds finite) only whole segments that fit at ``rate``
    steps/s, one segment while the rate is unknown."""
    steps = min(save_every - n % save_every, total - n, steps_left)
    if math.isfinite(left):
        fits = steps_per_call if rate is None else int(left * rate)
        steps = min(steps, fits // steps_per_call * steps_per_call)
    return max(steps, 0)


def train(directory, args, total=TOTAL, budget_s=math.inf,
          max_steps=None, save_every=SAVE_EVERY, stream=ESS_STREAM):
    """Build the flagship of ``args`` (``bench.parse_args``) and train it
    from the newest snapshot in ``directory`` toward ``total`` steps, in
    pieces (module docstring), at most ``max_steps`` steps and
    ``budget_s`` seconds of training in this call.  Returns ``(model,
    steps)``: the model after its last piece (with no piece trained, fresh
    weights) and the count it reached."""
    if save_every % args.steps_per_call:
        raise ValueError(f"save_every {save_every} is not a multiple of "
                         f"steps_per_call {args.steps_per_call}")
    os.makedirs(directory, exist_ok=True)
    model = bench.build_flagship(args)
    gen = torch.Generator(device=model.device)
    path, n = newest_snapshot(directory)
    done = read_trajectory(directory)
    call = 1 + max((r["call"] for r in done), default=0)
    print(f"[protocol] {directory}: {n} of {total} steps trained "
        f"(call {call})", flush=True)
    steps_left = total if max_steps is None else max_steps
    t0, rate = time.perf_counter(), None
    while n < total:
        steps = _piece(n, total, save_every, args.steps_per_call, rate,
                       budget_s - (time.perf_counter() - t0), steps_left)
        if steps == 0:
            break
        seconds = bench.protocol_fit(
            model, args, steps, total, save_every=steps,
            snapshot_path=path or os.path.join(directory, f"{BASE}.pt"))
        n += steps
        steps_left -= steps
        rate = steps / seconds
        path = os.path.join(directory, f"{BASE}.E{n}.pt")
        rec = dict(step=n, ess=_ess(model, gen, n, stream), steps=steps,
                   seconds=round(seconds, 3), steps_per_s=round(rate, 3),
                   call=call, device=str(model.device))
        with open(os.path.join(directory, TRAJECTORY), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[protocol] {json.dumps(rec)}", flush=True)
    return model, n


def finish(model, directory, args, total=TOTAL):
    """On the weights of ``directory``'s ``flagship.E<total>.pt``, with
    ``B`` the bench's ``--batch`` (1024 where it autotunes):
    ``sample_chain(64, B)``, ``sample_parallel_chains(64, B)`` and the
    blocked sampler (``sample__(B, n_blocks=4)`` and ``sample__(B / 4,
    n_blocks=16)``), then the bench's measuring half.  Prints the
    trajectory and the samplers' accept rates, then the bench's JSON
    record; returns ``(record, accept rates)``."""
    path, n = newest_snapshot(directory)
    if n != total:
        raise ValueError(f"{directory} holds {n} steps, not {total}")
    # loads the snapshot and sets up the fitter, whose step the measuring
    # half's idle share replays
    bench.protocol_fit(model, args, 0, total, snapshot_path=path)
    trajectory = read_trajectory(directory)
    for rec in trajectory:
        print(f"[protocol] trajectory {json.dumps(rec)}", flush=True)
    b = args.batch or 1024
    mcmc, blocked = model.mcmc, model.blocked_mcmc
    rates = {f"sample_chain(64, {b})": float(
        mcmc.sample_chain(64, b)["accept_rate"].mean())}
    rates[f"sample_parallel_chains(64, {b}), rounds 1-63"] = float(
        mcmc.sample_parallel_chains(64, b)["accept_rate"][1:].mean())
    for batch, n_blocks in ((b, 4), (b // 4, 16)):
        blocked.reset()
        blocked.sample__(batch, n_blocks=n_blocks)
        rates[f"blocked_mcmc.sample__({batch}, n_blocks={n_blocks})"] = \
            blocked.history.accept_rate[-1]
    print(f"[protocol] accept rates on the trained weights: "
        f"{json.dumps(rates)}", flush=True)
    args.train_epochs = total
    train_time = sum(r["seconds"] for r in trajectory)
    return bench.measure(model, args, train_time), rates


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m normflow__tpu_torch.tools.protocol_run",
        description="Train the flagship through the bench's protocol in "
                    "pieces that resume from snapshots, then measure it. "
                    "Flags it does not know go to the bench.")
    p.add_argument("--dir", default="runs/protocol",
                   help="where the snapshots and trajectory.jsonl live")
    p.add_argument("--budget_s", type=float, default=math.inf,
                   help="seconds of training this call may take")
    own, rest = p.parse_known_args(argv)
    return own, bench.parse_args(rest)


def main(argv=None):
    own, args = parse_args(argv)
    model, n = train(own.dir, args, total=TOTAL, budget_s=own.budget_s)
    if n < TOTAL:
        print(f"[protocol] stopped at {n} of {TOTAL} steps: run again "
              f"to resume from {own.dir}", flush=True)
        return None
    return finish(model, own.dir, args, total=TOTAL)[0]


if __name__ == "__main__":
    main()
