"""Profiling and tracing hooks (``normflow__tpu/utils/profiling.py``).

- :func:`trace`: a context manager that records its block's activity as
  a Chrome trace (``chrome://tracing``, Perfetto) on any device, as JAX's
  ``jax.profiler`` trace does on any backend: on the card the host's and
  the card's, through ``tools/kernel_times.profiled_window``
  (``torch.profiler``), without a card the host's alone (a
  ``torch.profiler`` CPU window, no marker kernels);
- :func:`profile_fn`: wall-clock seconds of a callable, warm-up excluded,
  the card synchronised after each call where JAX waits with
  ``block_until_ready``;
- :class:`Timer`: a scoped wall-clock timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["trace", "profile_fn", "Timer"]


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace('traces/run1'): step()`` writes the block's activity to
    ``logdir/trace.json``: with a CUDA device the host's and the card's,
    in a window that synchronises the card and marks its edges with spin
    kernels; without one the host's operators."""
    os.makedirs(logdir, exist_ok=True)
    if torch.cuda.is_available():
        from ..tools.kernel_times import profiled_window

        with profiled_window(head=0, tail=0) as window:
            yield logdir
        prof = window.prof
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
               **kwargs) -> dict:
    """Wall-clock ``fn(*args, **kwargs)``: ``warmup`` untimed calls, then
    ``iters`` timed ones, each ending in a synchronise of the card where
    CUDA is in use.  Returns ``min``, ``median`` and ``mean`` seconds and
    ``iters``."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"min": times[0], "median": times[len(times) // 2],
            "mean": sum(times) / len(times), "iters": iters}


class Timer:
    """``with Timer('fit') as t: ...`` prints and keeps (``t.elapsed``) the
    block's wall-clock seconds."""

    def __init__(self, label: str = "", verbose: bool = True):
        self.label = label
        self.verbose = verbose
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.label}] {self.elapsed:.4g} s")
        return False
