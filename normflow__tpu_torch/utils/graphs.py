"""CUDA graphs: one captured sampled batch or training step, replayed.

Counterparts of the JAX package's scanned device programs,
``_logqp_scan`` (``normflow__tpu/training/model.py:149-160``) and
``multi_step`` (``normflow__tpu/training/fitter.py:299-311``).  PyTorch
launches every operation of a batch or a step from the host, hundreds of
small kernels whose launches the card waits on; a CUDA graph records them
once and replays them with one launch.  ``Posterior.logqp_stream`` and
``Fitter.step`` replay their graph on a CUDA model and run the same body
eagerly on the CPU.

:func:`capture` warms the body up on a side stream (cuDNN picks its
algorithms, cuFFT its plans, the allocator its blocks), puts back the
generators' states and the tensors the body writes in place, so that the
warm-up leaves no trace, and captures one run under ``torch.cuda.graph``
with Python's garbage collector paused (:func:`gc_paused`).
The body draws from explicit ``torch.Generator``s: each is registered with
the graph (``CUDAGraph.register_generator_state``), so a replay reads the
generator's seed and offset when it starts and advances the offset as the
eager body would; a replay draws what the eager body draws from the same
state, ``manual_seed`` between replays takes effect, and eager draws after
replays continue the stream.  A capture that fails raises: nothing falls
back to the eager body on the card.

A kernel wrapper's ``launches`` count grows when the wrapper runs, so under
a graph it counts the warm-up and the capture, not the replays; the
profiler names each replayed kernel (``tools/kernel_times.KERNEL_RE``).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, NamedTuple

import torch

__all__ = ["WARMUP", "Captured", "capture", "gc_paused", "GraphCache"]

WARMUP = 2  # eager runs of the body on a side stream before the capture


class Captured(NamedTuple):
    """A captured graph and the body's outputs, which every replay
    overwrites in place."""

    graph: "torch.cuda.CUDAGraph"
    outputs: tuple


def capture(body: Callable[[], tuple], *, generators=(),
            keep=()) -> Captured:
    """Capture ``body()`` (no arguments, returns a tuple of tensors) in a
    CUDA graph after :data:`WARMUP` eager runs of it.  ``generators`` are
    the generators it draws from, ``keep`` the tensors it writes in place
    (a training step's parameters and optimizer state): both are as they
    were before the warm-up when the capture starts, and the capture
    itself draws nothing and writes nothing.  Raises if this PyTorch
    cannot register a generator with a graph or if the capture fails."""
    if generators and not hasattr(torch.cuda.CUDAGraph,
                                  "register_generator_state"):
        raise RuntimeError("this PyTorch cannot capture draws from an "
                           "explicit generator in a CUDA graph "
                           "(CUDAGraph.register_generator_state)")
    states = [g.get_state() for g in generators]
    with torch.no_grad():
        kept = [t.detach().clone() for t in keep]
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            body()
    main.wait_stream(side)
    for g, s in zip(generators, states):
        g.set_state(s)
    with torch.no_grad():
        for t, v in zip(keep, kept):
            t.copy_(v)
    del kept
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with gc_paused(), torch.cuda.graph(graph):
        outputs = body()
    return Captured(graph, tuple(outputs))


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off inside the block, after one
    collection.  A dead graph that a collection frees during a capture
    resets its CUDA graph there, which CUDA refuses while a stream
    captures, and the capture fails ("operation not permitted when stream
    is capturing")."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class GraphCache:
    """Captured graphs by key, valid while ``stamp`` stays equal.

    ``stamp`` is a tuple of what a graph holds to without seeing it at
    replay: the modules it runs (compared as objects) and the addresses of
    their weights.  Weights loaded in place keep the stamp, so the next
    replay computes with them; a swapped net, prior or action, or a weight
    given new storage, changes it, and every graph of the old stamp is
    dropped before the next capture."""

    def __init__(self):
        self._stamp = None
        self._graphs: dict = {}

    def get(self, key, stamp: tuple, make: Callable[[], Captured]) \
            -> Captured:
        if stamp != self._stamp:
            self._graphs.clear()
            self._stamp = stamp
        if key not in self._graphs:
            self._graphs[key] = make()
        return self._graphs[key]

    def clear(self):
        self._stamp = None
        self._graphs.clear()

    def __len__(self):
        return len(self._graphs)
