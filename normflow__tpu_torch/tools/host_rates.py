#!/usr/bin/env python3
"""Host-side rates of one checkout of the port, on one CUDA card::

    python3 normflow__tpu_torch/tools/host_rates.py CHECKOUT LABEL

``CHECKOUT`` is the root of a checkout (it holds ``normflow__tpu_torch/``);
the port is imported from there, so two commits compare on the same card
by running the script on each in turn (parent, change, change, parent).  It
prints, each line starting with ``LABEL``:

- the host microseconds of one wrapper call (``rqs_coupling``,
  ``phi4_action``) under ``torch.no_grad`` at a launch-bound shape (2000
  calls, then a synchronise; median of 5 repeats);
- raw samples/s of ``logqp_stream(32, 1024)`` on the full-width 32x32
  flagship with seeded perturbed weights (median of 7 runs);
- where the checkout has them, proposals/s of ``mcmc.sample_chain(32,
  1024)`` and ``mcmc.sample_parallel_chains(32, 1024)`` on that flagship
  (median of 7 runs);
- where the checkout has a ``Fitter``, training steps/s of ``model.fit``
  with the bench protocol's settings at batch 512 (20 steps per call,
  ``steps_per_call=10``, each call capturing its step; median of 5
  calls), then of the replayed step alone (``fit.step()``, 10 steps per
  run; median of 7 runs).
"""

import math
import os
import statistics
import sys
import time


def _median_min_max(xs):
    xs = sorted(xs)
    return f"median {statistics.median(xs):.2f} min {xs[0]:.2f} max {xs[-1]:.2f}"


def main(src, label):
    src = os.path.abspath(src)
    sys.path.insert(0, src)
    import numpy as np
    import torch

    import normflow__tpu_torch as nt
    from normflow__tpu_torch.models.nets import CircularConv
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
    from normflow__tpu_torch.utils.transplant import jax_leaf_order
    from normflow__tpu_torch.zoo import build_phi4_model

    if not nt.__file__.startswith(src):
        raise RuntimeError(f"imported {nt.__file__}, not the port in {src}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    xs = torch.zeros((1, 8, 4), device="cuda")
    outs = torch.zeros((1, 22, 8, 4), device="cuda")
    cfg = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
               right="linear")
    for name, fn in (
            ("rqs_coupling", lambda: sc.rqs_coupling(xs, outs, **cfg)),
            ("phi4_action", lambda: phi4.phi4_action(xs, 0.6, 0.4, 0.5))):
        per = []
        with torch.no_grad():
            for _ in range(6):  # the first repeat warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn()
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) / 2000 * 1e6)
        print(f"{label}: {name} host us per call under no_grad x5 "
              f"{_median_min_max(per[1:])}")

    rng = np.random.default_rng(1)
    model = build_phi4_model((32, 32), seed=0)
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(model.net_):
            s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                if isinstance(owner, CircularConv) else 0.3
            p.add_(torch.tensor(rng.standard_normal(tuple(p.shape)) * s,
                                dtype=p.dtype, device=p.device))
    model.posterior.logqp_stream(4, 1024)
    torch.cuda.synchronize()
    rates = []
    for _ in range(7):
        t0 = time.perf_counter()
        model.posterior.logqp_stream(32, 1024)
        torch.cuda.synchronize()
        rates.append(32 * 1024 / (time.perf_counter() - t0))
    print(f"{label}: logqp_stream(32, 1024) x7 raw samples/s "
          f"{_median_min_max(rates)}")
    if hasattr(model.mcmc, "sample_chain"):
        for name, fn in (
                ("sample_chain", model.mcmc.sample_chain),
                ("sample_parallel_chains",
                 model.mcmc.sample_parallel_chains)):
            fn(4, 1024)
            rates = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(32, 1024)
                torch.cuda.synchronize()
                rates.append(32 * 1024 / (time.perf_counter() - t0))
            print(f"{label}: {name}(32, 1024) x7 proposals/s "
                  f"{_median_min_max(rates)}")

    if not hasattr(model, "fit"):
        return
    kw = dict(batch_size=512, hyperparam=dict(lr=3e-3, weight_decay=1e-4),
              grad_estimator="path", clip_grad_norm=25.0, steps_per_call=10,
              checkpoint_dict=dict(print_stride=None))
    model = build_phi4_model((32, 32), seed=0)
    model.fit(n_epochs=10, **kw)
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.fit(n_epochs=20, **kw)
        torch.cuda.synchronize()
        rates.append(20 / (time.perf_counter() - t0))
    print(f"{label}: model.fit(20 steps, steps_per_call=10) x5 steps/s "
          f"{_median_min_max(rates)}")
    rates = []
    for _ in range(7):  # the replayed step alone, no capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model.fit.step()
        torch.cuda.synchronize()
        rates.append(10 / (time.perf_counter() - t0))
    print(f"{label}: fit.step() x10, x7 steps/s {_median_min_max(rates)}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
