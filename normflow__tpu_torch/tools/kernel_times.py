#!/usr/bin/env python3
"""Device times and outputs of the port's four kernels in one checkout::

    python3 normflow__tpu_torch/tools/kernel_times.py CHECKOUT LABEL OUT.pt \\
        [CASES]
    python3 normflow__tpu_torch/tools/kernel_times.py --compare A.pt B.pt

``CHECKOUT`` is the root of a checkout (it holds ``normflow__tpu_torch/``);
the port is imported from there, so two commits compare on one card by
running the first form on each in turn (parent, change, change, parent).
For each kernel at the main path's shapes (``rqs_coupling`` forward and
inverse at B = 1024, the sampling batch, and at B = 512, the training
batch; ``rqs_coupling_bwd`` at B = 512 forward and inverse; all with
linear tails on the flagship's 32x16 sites and m = 8; ``phi4_action`` at
(1024, 32, 32); ``phi4_action_grad`` at (512, 32, 32)), and at the
unpacked flagship's and the 8x8 affine example's shapes (the coupling at
32x32 = 1024 sites at B = 1024 and 512 and its VJP at B = 512; the action
and its force at (128, 8, 8), which take the general kernels), and for the
channels-last kernels (the ``pallas_reg`` route's) on the packed flagship's
values channels-last, and for ``accept_scan`` at n = 1024 (a chain round)
and 10,000 on four chains (the smoke's random one, one stuck on a heavy
state, one whose logqp rises so steeply that no state ever accepts again,
and the flagship's own ``logq - logp`` at seeded perturbed weights), and
for the 4-D flagship's shapes (the action and its force at (1024, 8, 8, 8,
8) and (512, 8, 8, 8, 8), the slab kernels on the first of two slabs of
the (1024, 8, 8, 8, 8) field, (1024, 4, 8, 8, 8), and the kernels at 1-D
(general) and 3-D (the tiled nd kernels since they were added; a
checkout's own variant at each shape) beside them; a checkout whose
wrappers refuse a case, as one from before the kernels took a fourth
lattice axis does, leaves it out), and for the channels-last kernels at
the 8^4 flagship's shapes on its ``pallas_reg`` route (``rqs_coupling``
forward and inverse at (1024, 22, 8, 8, 8, 8) and (512, 22, 8, 8, 8, 8),
``rqs_coupling_bwd`` forward and inverse at (512, 22, 8, 8, 8, 8)), it
prints, each
line starting with ``LABEL``, the median device time per launch from CUDA
events around each call, the device held behind a spin kernel so that the
host is ahead, less what the events add around nothing (:func:`warm_ms`;
that is printed first, :func:`event_floor_ms`), with the inputs warm in
L2 and with L2 flushed before every launch (a 256 MB buffer written
between launches), the least time the card could take (:func:`bound_ms`)
and the share of it each time reaches.  It saves every kernel's outputs on
the seeded inputs to ``OUT.pt`` (about 180 MB).  ``CASES``, a regular
expression, keeps the cases whose name it matches.  It also prints the SASS
instructions of each device function's flagship instance in the built
library (``cuobjdump -sass``, :func:`sass_counts`) and the time their issue
alone needs at the path's shapes (:func:`issue_ms`).  Where an
``accept_scan`` case is kept it first times an empty kernel launched as
the wrappers launch theirs, through ``ctypes``, one block of 256 or 1024
threads (:func:`empty_kernel_ms`): the floor any one-launch kernel pays.

``--compare`` holds two such files against each other: ``rqs_coupling``,
``rqs_coupling_bwd``, ``phi4_action_grad``, the slab force and
``accept_scan`` bit for bit, ``phi4_action`` and the slab action to max
|dS| / max(1, |S|) <= 2e-5 (and says whether their bits agree too); it
exits 1 if one differs
(cases that only one file holds are left out).  :func:`warm_ms`,
:func:`cold_ms`, :func:`event_floor_ms`, :func:`bound_ms`, :func:`work`,
:func:`card_peaks`, :func:`device_window`, :func:`device_launches` and
:func:`perturb_` serve ``chip_smoke.py`` and the ``gpu`` tests too, and
:func:`profiled_window` ``tools/profiler_windows.py`` and
``utils.profiling.trace``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

PHI4_REL_TOL = 2e-5
FLUSH_BYTES = 256 * 2 ** 20  # > 2 x the H100's 50 MB L2
HEAD_CYCLES = 1 << 20  # the spin ahead of a timed call: ~0.5 ms on an H100
# the card's published peaks (NVIDIA data sheets), keyed by a part of the
# name nvidia-smi reports: memory bytes/s and float32 (non-tensor) FLOP/s
PEAKS = (("H100 NVL", 3.9e12, 60e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))
# each kernel's device function, as the profiler names its launches
KERNEL_RE = {
    "rqs_coupling": r"\brqs_coupling(_tiled)?_kernel\b",
    "rqs_coupling_bwd": r"\brqs_coupling_bwd(_tiled)?_kernel\b",
    # the channels-last kernels (the pallas_reg route), counted apart
    "rqs_coupling_cl": r"\brqs_coupling_cl(_tiled)?_kernel\b",
    "rqs_coupling_bwd_cl": r"\brqs_coupling_bwd_cl(_tiled)?_kernel\b",
    # the 2-D tiled kernels and, at 3-D and 4-D, the tiled nd ones
    "phi4_action": r"\bphi4_action(_tiled(?:_nd)?)?_kernel\b",
    "phi4_action_grad": r"\bphi4_action_grad(_tiled(?:_nd)?)?_kernel\b",
    # the slab kernels: the 2-D tile and, at 3-D and 4-D, the tiled nd ones
    "phi4_action_slab": r"\bphi4_action_slab(_tiled(?:_nd)?)?_kernel\b",
    "phi4_action_slab_grad":
        r"\bphi4_action_grad_slab(_tiled(?:_nd)?)?_kernel\b",
    "accept_scan": r"\baccept_scan_kernel\b",
}
M, LAT, BATCH, TRAIN_BATCH = 8, (32, 32), 1024, 512
LIM = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear", right="linear")


def card_peaks(name):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks recorded for the card {name!r}")


def bound_ms(nbytes, nops, peaks):
    """``(ms, "bytes" | "operations")``: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    bw, flops = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _event_us(fn, reps, between=None):
    """Device microseconds of each of ``reps`` calls of ``fn()``,
    ``between()`` before each: the span between two CUDA events recorded
    on the stream just before and just after the call.  A spin kernel
    (``torch.cuda._sleep``) is queued ahead of each call, so the host has
    enqueued the whole call before the device reaches it and the span is
    the call's device time plus the events' own latency
    (:func:`event_floor_ms`), not the host's.  A call whose spin the device
    finished before the host had enqueued it is timed again behind a spin
    twice as long; after 8 doublings it raises.  No profiler is involved:
    :func:`device_launches` counts by kernel name."""
    import torch

    spans, cycles = [], HEAD_CYCLES
    torch.cuda.synchronize()
    while len(spans) < reps:
        if between is not None:
            between()
        torch.cuda._sleep(cycles)
        ready = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ready.record()
        start.record()
        fn()
        end.record()
        if not ready.query():
            spans.append((start, end))
        elif cycles < HEAD_CYCLES << 8:
            cycles *= 2
        else:
            raise RuntimeError(f"the device caught up with the host behind "
                               f"a spin of {cycles} cycles")
    torch.cuda.synchronize()
    return [start.elapsed_time(end) * 1e3 for start, end in spans]


def event_floor_ms(reps=50):
    """Median ms between two CUDA events with nothing between them, timed
    as :func:`_event_us` times a call: what the events add to a call."""
    return statistics.median(_event_us(lambda: None, reps)) / 1e3


def _call_ms(fn, reps, between=None):
    """Median device ms of one call of ``fn()`` (:func:`_event_us`) less
    :func:`event_floor_ms`.  What is left holds the device's latency in
    starting the call's kernel after the first event (about a microsecond
    more than the profiler's kernel time on an H100)."""
    call = statistics.median(_event_us(fn, reps, between)) / 1e3
    return call - event_floor_ms(reps)


# the spin kernel of torch.cuda._sleep, which marks a profiled window's
# edges (~2 us on an H100)
MARKER_RE = re.compile(r"\bspin_kernel\b")
MARKER_CYCLES = 1 << 12
# a window's opening: on an H100 the profiler at times lost what started
# in its first ~4 ms (0 of 400 windows at 5 or 10 ms of pause), and after a
# long profiled window each later one lost its first device activities: 1
# in tools/profiler_windows.py's windows, more than 8 in the smoke's kernel
# times (a head of 2048 has held in every run of the smoke)
WINDOW_PAD_S = 0.01
HEAD_NODES = 2048  # one-element kernels that open a window
# a window's close: on an H100 the profiler at times lost the last device
# activities of a window, up to the final 65 of 152 replayed chain rounds,
# so the window pauses after the closing marker for the profiler to take
# them in, then runs a tail of one-element kernels that it may lose instead
TAIL_PAD_S = 0.1
TAIL_NODES = 2048
HEAD_LOSSES = []  # the head activities each device_window lost, in order
TAIL_LOSSES = []  # the tail activities each device_window lost, in order
CLOSE_LOSSES = []  # the windows (indices into HEAD_LOSSES) that lost their
# closing marker
_HEADS = {}


def _head(nodes):
    """A CUDA graph of ``nodes`` one-element adds on the current card (a
    window's head or tail), captured once per size and card.  The cache holds the tensor the graph
    writes with the graph: freed, it would be handed to other tensors
    while the graph still writes it."""
    import torch

    from normflow__tpu_torch.utils.graphs import gc_paused

    key = (nodes, torch.cuda.current_device())
    if key not in _HEADS:
        x = torch.zeros(1, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1.0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with gc_paused(), torch.cuda.graph(graph):
            for _ in range(nodes):
                x.add_(1.0)
        _HEADS[key] = graph, x
    return _HEADS[key][0]


@contextlib.contextmanager
def profiled_window(pad_s=WINDOW_PAD_S, head=HEAD_NODES, tail=TAIL_NODES,
                    tail_s=TAIL_PAD_S):
    """The mechanics of :func:`device_window`: a ``torch.profiler`` window
    (CPU and CUDA activities) that opens with a pause of ``pad_s`` seconds
    and a replay of ``head`` one-element kernels (none for 0), then
    synchronises and runs a marker spin, the body, a second marker and a
    synchronise, and closes with a pause of ``tail_s`` seconds and a
    replay of ``tail`` one-element kernels (none for 0) and a synchronise.
    Yields a namespace whose ``events`` holds, once the
    window has closed, ``(start_ns, name, duration_us, correlation_id,
    on_device)`` of every event the profiler reported, sorted by start,
    the host's runtime calls among them, and whose ``start_ns`` is the
    profiler's start on the same clock.  The raw
    events are read: the profiler's event tree takes minutes to build for
    a thousand replayed steps.  (A window that traces the device alone saw
    no events on the card.)  ``prof``, the closed profiler, exports the
    window (``utils.profiling.trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    window = types.SimpleNamespace(events=[], start_ns=None)
    graph = _head(head) if head else None
    closing = _head(tail) if tail else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        if graph is not None:
            graph.replay()
            torch.cuda.synchronize()
        torch.cuda._sleep(MARKER_CYCLES)
        yield window
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        if closing is not None:
            time.sleep(tail_s)
            closing.replay()
            torch.cuda.synchronize()
    window.prof = prof
    cuda = torch.autograd.DeviceType.CUDA
    results = prof.profiler.kineto_results
    window.start_ns = results.trace_start_ns()
    window.events.extend(sorted(
        (e.start_ns(), e.name(), e.duration_ns() / 1e3, e.correlation_id(),
         e.device_type() == cuda) for e in results.events()))


@contextlib.contextmanager
def device_window():
    """A ``torch.profiler`` window around the body, yielding a list that
    holds ``(name, microseconds)`` of every device activity the body
    caused once the window has closed (:func:`profiled_window`).

    The card's profiler has dropped device activities at a window's
    opening in two ways: now and then what started in its first few
    milliseconds, and, after a long profiled window, the first device
    activities of every later window; and now and then a window's last
    ones.  So the window opens with :data:`WINDOW_PAD_S` of pause and
    :data:`HEAD_NODES` one-element kernels that may be lost, closes with
    :data:`TAIL_PAD_S` of pause and :data:`TAIL_NODES` such kernels, and
    only the activities that start between the two marker kernels count.
    A window whose one marker is followed by other activities lost its
    closing marker: the body is everything after the opening one but the
    last :data:`TAIL_NODES` (so a tail the profiler lost in part leaves
    the counts short), and the window is kept in :data:`CLOSE_LOSSES`.  If
    the profiler reports the opening marker missing, the window lost more
    than its head, and this raises rather than return counts short of what
    ran.  What each head and tail lost is kept in :data:`HEAD_LOSSES` and
    :data:`TAIL_LOSSES`."""
    events = []
    with profiled_window() as window:
        yield events
    events.extend(window_body([(t, n, us) for t, n, us, _, on_device
                               in window.events if on_device], TAIL_NODES))


def window_body(dev, tail=0):
    """``(name, microseconds)`` of the body's activities among a window's
    device activities ``dev``, ``(start, name, microseconds)`` sorted by
    start, the last ``tail`` of them run after the closing marker (see
    :func:`device_window`); appends to :data:`HEAD_LOSSES`,
    :data:`TAIL_LOSSES` and :data:`CLOSE_LOSSES`, and raises if the
    opening marker is missing or cannot be told from the closing one (one
    marker, followed by no more than ``tail`` activities)."""
    marks = [t for t, n, _ in dev if MARKER_RE.search(n)]
    after = [t for t, _, _ in dev if marks and t > marks[0]]
    if len(marks) == 1 and len(after) > tail:  # the opening marker's
        CLOSE_LOSSES.append(len(HEAD_LOSSES))
        marks.append(after[-tail] if tail else math.inf)
        tail = 0
    if len(marks) < 2:
        raise RuntimeError(
            f"the profiler reported {len(marks)} of the 2 marker kernels of "
            f"its window ({len(dev)} device events, {HEAD_NODES} of them "
            "the head's at most): it lost device activities, and its "
            "counts would be short")
    first, last = marks[-2:]
    HEAD_LOSSES.append(HEAD_NODES - sum(t < first for t, _, _ in dev))
    if tail:
        TAIL_LOSSES.append(tail - sum(t > last for t, _, _ in dev))
    return [(n, us) for t, n, us in dev if first < t < last]


def device_launches(fn):
    """``({kernel: (launches, tiled launches)}, fn())``: the launches of
    the port's kernels in one profiled call of ``fn()``
    (:func:`device_window`), counted by name in the profiler's device
    events (:data:`KERNEL_RE`; the tiled variants' names hold ``_tiled``,
    and a kernel with no tiled variant counts 0 tiled launches), and what
    ``fn`` returned.  Under a CUDA graph a wrapper's ``launches`` counts
    its warm-up and capture, not the replays; this counts every launch on
    the card."""
    pats = {k: re.compile(v) for k, v in KERNEL_RE.items()}
    counts = {k: [0, 0] for k in pats}
    with device_window() as events:
        out = fn()
    for name, _ in events:
        for k, pat in pats.items():
            m = pat.search(name)
            if m:
                counts[k][0] += 1
                counts[k][1] += bool(pat.groups) and m.group(1) is not None
    return {k: tuple(v) for k, v in counts.items() if v[0]}, out


def warm_ms(fn, reps=50):
    """Median device ms of one call of ``fn()`` (:func:`_call_ms`) when
    it runs again and again on the same tensors (they stay in L2 where
    they fit)."""
    for _ in range(5):
        fn()
    return _call_ms(fn, reps)


def cold_ms(fn, reps=30):
    """Median device ms of one call of ``fn()`` (:func:`_call_ms`) with
    L2 flushed before it: a 256 MB buffer is written between calls."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    return _call_ms(fn, reps, between=lambda: flush.fill_(1.0))


def work(name, shape):
    """``(bytes, operations)`` one launch must move and do: each input read
    once and each output written once; the per-site operation counts of
    ``chip_smoke.py``'s notes.  A channels-last kernel (``_cl``) does its
    layout's twin's work; ``shape`` is ``out``'s, ``(B, 3m-2, *lat)``.  A
    tiled nd kernel (``_tiled_nd``) does its wrapper's."""
    name = name.removesuffix("_cl").removesuffix("_tiled_nd")
    if name in ("rqs_coupling", "rqs_coupling_bwd"):
        b, k3, *lat = shape
        m, sites, k = (k3 + 2) // 3, b * math.prod(lat), (k3 + 2) // 3 + 2
        # 2 softmax-cumsum coordinate sets (~7m), m softplus (~8m), K
        # comparisons, 6(K-1) selects, ~40 for the rational map and its log
        fwd = 22 * m + k + 6 * (k - 1) + 40
        if name == "rqs_coupling":
            return sites * 4 * (1 + k3 + 2), sites * fwd
        # reads x, ybar, loggbar and 3m-2 channels, writes xbar and 3m-2;
        # the forward again, ~100 scalar operations, 2 softmax
        # transpositions (~8m), m sigmoids (~6m) and the selects (~6m)
        return sites * 4 * (4 + 2 * k3), sites * (fwd + 100 + 20 * m)
    if name == "accept_scan":
        # reads lrand, logqp and the ref, writes a bool and an int64 index
        # per proposal; a subtract and a compare each
        n = shape[0]
        return n * (4 + 4 + 1 + 8) + 4, 2 * n
    # nd lattice dims: the action's phi^2 and phi^4 terms and 3 operations
    # per dimension for its neighbour product; the force's terms, 2
    # neighbours per dimension and 3 more operations
    nd = len(shape) - 1
    act_ops, force_ops = 6 + 3 * nd, 5 + 2 * nd + 3
    if name in ("phi4_action_slab", "phi4_action_slab_grad"):
        # a slab (B, l0, *rest) and its halo rows: the action reads the row
        # before the slab, the force both; the same work per site
        b, row = shape[0], math.prod(shape[2:])
        sites = math.prod(shape)
        if name == "phi4_action_slab":
            return 4 * (sites + b * row) + 4 * b, sites * act_ops
        return 4 * (2 * sites + 2 * b * row) + 4 * b, sites * force_ops
    b, sites = shape[0], math.prod(shape)
    if name == "phi4_action":
        return 4 * sites + 4 * b, sites * act_ops
    # reads cfgs and g, writes grad
    return 4 * sites * 2 + 4 * b, sites * force_ops


def sass_counts(lib_path):
    """:func:`parse_sass` of ``cuobjdump -sass`` of a built kernel
    library."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(
        CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    return parse_sass(subprocess.run([tool, "-sass", lib_path],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(text):
    """``{mangled device function: (instructions, site instructions)}`` of
    ``cuobjdump -sass``'s listing.  ``instructions`` counts the whole
    function once (the padding NOPs and the closing branch to itself left
    out), the slow paths of the IEEE divisions and a tiled kernel's ring
    code included; ``site instructions`` are those from the first load of
    an input (``LDG`` or ``LDS``) to the last store of a result (``STG``,
    or ``STS`` into the stage that the tiled VJP's bulk stores send) in
    address order: the code one thread runs for one site, or for one
    float4 of sites in the tiled force, where the division slow paths,
    placed after the function's last ``EXIT``, are not taken."""
    counts = {}
    for block in re.split(r"\n\s*Function : ", "\n" + text)[1:]:
        ops = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", block)]
        ops = [(a, op) for a, op in ops if not op.startswith("NOP") and
               op != f"BRA {a:#x}"]
        kinds = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
                 for _, op in ops]
        loads = [i for i, k in enumerate(kinds) if k in ("LDG.E.CONSTANT",
                 "LDG.E", "LDS", "LDG.E.128.CONSTANT", "LDS.128")]
        stores = [i for i, k in enumerate(kinds)
                  if k.startswith(("STG", "STS"))]
        site = stores[-1] - loads[0] + 1 if loads and stores else 0
        counts[block.split()[0]] = (len(ops), site)
    return counts


def issue_ms(threads, instructions, n_sm, clock_mhz):
    """Milliseconds the card needs to issue ``instructions`` SASS
    instructions on each of ``threads`` threads: one warp instruction per
    clock on each of an SM's 4 schedulers."""
    return threads / 32 * instructions / (n_sm * 4 * clock_mhz * 1e3)


EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int threads, void* stream) {
  empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


@functools.cache
def _empty_lib():
    """:data:`EMPTY_SOURCE` built with the port's ``nvcc`` flags into its
    build directory, loaded with ``ctypes``."""
    from normflow__tpu_torch.ops.kernels import _lib

    out = _lib.BUILD_ROOT / "empty"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_SOURCE)
    so = out / "libempty.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(out / "empty.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.empty_launch.argtypes = (ctypes.c_int, ctypes.c_void_p)
    return lib


def empty_kernel_ms(threads, reps=50):
    """Warm device ms of an empty kernel, one block of ``threads``, launched
    through ``ctypes`` as the wrappers launch theirs (:func:`warm_ms`)."""
    import torch

    lib = _empty_lib()

    def launch():
        err = lib.empty_launch(threads, torch.cuda.current_stream()
                               .cuda_stream)
        if err:
            raise RuntimeError(f"the empty kernel failed to launch: {err}")

    return warm_ms(launch, reps)


def perturb_(net, rng, scale=0.3):
    """Seeded noise on every weight: ``scale`` times the init bound on the
    conv weights, N(0, scale^2) on every other weight (the spline weights
    are all zero at build), so no part of the map stays at its identity.
    ``chip_smoke.py`` perturbs its flagships so."""
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


def flagship_chain(torch, rng, n_batches=10):
    """``(lrand, logqp, ref)`` of the sampling flagship's own chain: ``logq
    - logp`` of ``n_batches`` sampled batches of 1024 at seeded perturbed
    weights (cuDNN deterministic, so every checkout draws the same), log
    uniforms from a seeded generator, the reference the first logqp."""
    from normflow__tpu_torch.zoo import build_phi4_model

    torch.backends.cudnn.deterministic = True
    model = build_phi4_model(LAT, seed=0)
    perturb_(model.net_, rng)
    logqp = model.posterior.logqp_stream(n_batches, BATCH).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    lrand = torch.log(torch.rand(logqp.shape, generator=gen, device="cuda"))
    return lrand, logqp, logqp[0].clone()


def scan_inputs(torch, rng):
    """``accept_scan``'s cases: ``{case: (kernel, shape, call)}``, as
    :func:`inputs`, at n = 1024 and 10,000 on each chain.  The rising
    chain is the search's worst case: every state, the incoming one
    included, tests every candidate to the chunk's end and accepts none.
    The flagship's chain is drawn at its first call."""
    import importlib

    import numpy as np

    mod = importlib.import_module("normflow__tpu_torch.ops.kernels"
                                  ".accept_scan")
    n_max = 10000
    logqp = torch.tensor(rng.standard_normal(n_max) * 1.5,
                         dtype=torch.float32, device="cuda")
    lrand = torch.log(torch.tensor(rng.random(n_max), dtype=torch.float32,
                                   device="cuda"))
    stuck = logqp.clone()
    stuck[5] = -1e4  # no proposal after it is accepted
    stuck_lrand = lrand.clone()
    lrand[::11] = -math.inf  # the smoke's random chain
    # ref - logqp[i] <= -40 from every state: below any log u drawn here
    rising = torch.arange(n_max, dtype=torch.float32, device="cuda") * 40
    ref = torch.tensor(0.5, device="cuda")
    chains = {"random": (lrand, logqp, ref),
              "stuck": (stuck_lrand, stuck, ref),
              "rising": (stuck_lrand, rising,
                         torch.tensor(-40.0, device="cuda"))}
    flagship_rng = np.random.default_rng(20261019)

    def get(chain):
        if chain not in chains:
            chains[chain] = flagship_chain(torch, flagship_rng)
        return chains[chain]

    def scan(chain, n):
        def call(sc, ph):
            lr, lq, r = get(chain)
            return mod.accept_scan(lr[:n], lq[:n], r)
        return "accept_scan", (n,), call

    return {f"accept_scan {chain} n={n}": scan(chain, n)
            for chain in ("random", "stuck", "rising", "flagship")
            for n in (BATCH, n_max)}


def inputs(torch, rng, coef):
    """Seeded inputs at the path's shapes: ``{case: (kernel, shape, call)}``
    where ``call(mod_sc, mod_phi4)`` launches the kernel's wrapper;
    ``coef(nd)`` gives the action's coefficients ``(w0, w2, w4)`` on ``nd``
    lattice dims."""
    w = coef(2)
    def f32(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    lat = (LAT[0], LAT[1] // 2)
    k3 = 3 * M - 2
    x1, out1 = f32((BATCH, *lat)), f32((BATCH, k3, *lat))
    x2, out2 = f32((TRAIN_BATCH, *lat)), f32((TRAIN_BATCH, k3, *lat))
    ybar, loggbar = f32((TRAIN_BATCH, *lat)), f32((TRAIN_BATCH, *lat))
    cfgs3, cfgs4 = f32((BATCH, *LAT)), f32((TRAIN_BATCH, *LAT))
    g4 = f32((TRAIN_BATCH,))
    # the unpacked flagship: every site; the affine example: 8x8, B = 128
    xu, outu = f32((BATCH, *LAT)), f32((BATCH, k3, *LAT))
    xu2, outu2 = xu[:TRAIN_BATCH], outu[:TRAIN_BATCH]
    ybaru, loggbaru = f32((TRAIN_BATCH, *LAT)), f32((TRAIN_BATCH, *LAT))
    cfgs8, g8 = f32((128, 8, 8)), f32((128,))

    def coupling(x, out, inverse):
        return ("rqs_coupling", tuple(out.shape), lambda sc, ph:
                sc.rqs_coupling(x, out, inverse=inverse, **LIM))

    def vjp(inverse):
        return ("rqs_coupling_bwd", tuple(outu2.shape), lambda sc, ph:
                sc.rqs_coupling_bwd(xu2, outu2, ybaru, loggbaru,
                                    inverse=inverse, **LIM))

    cl1, cl2 = (o.contiguous(memory_format=torch.channels_last)
                for o in (out1, out2))

    def cl(inverse):
        return ("rqs_coupling_cl", tuple(cl1.shape), lambda sc, ph:
                sc.rqs_coupling(x1, cl1, inverse=inverse, **LIM))

    def cl_vjp(inverse):
        return ("rqs_coupling_bwd_cl", tuple(cl2.shape), lambda sc, ph:
                sc.rqs_coupling_bwd(x2, cl2, ybar, loggbar, inverse=inverse,
                                    **LIM))

    return {
        "rqs_coupling forward": coupling(x1, out1, False),
        "rqs_coupling inverse": coupling(x1, out1, True),
        "rqs_coupling forward B=512": coupling(x2, out2, False),
        "rqs_coupling inverse B=512": coupling(x2, out2, True),
        "rqs_coupling_bwd forward": (
            "rqs_coupling_bwd", tuple(out2.shape), lambda sc, ph:
            sc.rqs_coupling_bwd(x2, out2, ybar, loggbar, inverse=False,
                                **LIM)),
        "rqs_coupling_bwd inverse": (
            "rqs_coupling_bwd", tuple(out2.shape), lambda sc, ph:
            sc.rqs_coupling_bwd(x2, out2, ybar, loggbar, inverse=True,
                                **LIM)),
        "phi4_action": ("phi4_action", tuple(cfgs3.shape), lambda sc, ph:
                        ph.phi4_action(cfgs3, *w)),
        "phi4_action_grad": ("phi4_action_grad", tuple(cfgs4.shape),
                             lambda sc, ph: ph.phi4_action_grad(cfgs4, g4,
                                                                *w)),
        "rqs_coupling forward S=1024": coupling(xu, outu, False),
        "rqs_coupling inverse S=1024": coupling(xu, outu, True),
        "rqs_coupling forward S=1024 B=512": coupling(xu2, outu2, False),
        "rqs_coupling inverse S=1024 B=512": coupling(xu2, outu2, True),
        "rqs_coupling_bwd forward S=1024": vjp(False),
        "rqs_coupling_bwd inverse S=1024": vjp(True),
        "phi4_action (128, 8, 8)": ("phi4_action", tuple(cfgs8.shape),
                                    lambda sc, ph: ph.phi4_action(cfgs8,
                                                                  *w)),
        "phi4_action_grad (128, 8, 8)": (
            "phi4_action_grad", tuple(cfgs8.shape),
            lambda sc, ph: ph.phi4_action_grad(cfgs8, g8, *w)),
        # the channels-last route's kernels on the same values
        "rqs_coupling_cl forward": cl(False),
        "rqs_coupling_cl inverse": cl(True),
        "rqs_coupling_bwd_cl forward": cl_vjp(False),
        "rqs_coupling_bwd_cl inverse": cl_vjp(True),
        **scan_inputs(torch, rng),
        **phi4_inputs(torch, f32, coef),
        **coupling4_inputs(torch, f32),
    }


def coupling4_inputs(torch, f32):
    """The channels-last coupling kernels and VJP at the 8^4 flagship's
    shapes on its ``pallas_reg`` route: 4096 sites a sample, ``out``
    channels-last as the route's conditioners emit it."""
    lat = (8, 8, 8, 8)
    k3 = 3 * M - 2
    x, out = f32((BATCH, *lat)), f32((BATCH, *lat, k3)).movedim(-1, 1)
    ybar, loggbar = f32((TRAIN_BATCH, *lat)), f32((TRAIN_BATCH, *lat))
    cases = {}
    for b in (BATCH, TRAIN_BATCH):
        for what, inverse in (("forward", False), ("inverse", True)):
            cases[f"rqs_coupling_cl {what} {(b, k3, *lat)}"] = (
                "rqs_coupling_cl", (b, k3, *lat),
                lambda sc, ph, b=b, inverse=inverse: sc.rqs_coupling(
                    x[:b], out[:b], inverse=inverse, **LIM))
    for what, inverse in (("forward", False), ("inverse", True)):
        cases[f"rqs_coupling_bwd_cl {what} {(TRAIN_BATCH, k3, *lat)}"] = (
            "rqs_coupling_bwd_cl", (TRAIN_BATCH, k3, *lat),
            lambda sc, ph, inverse=inverse: sc.rqs_coupling_bwd(
                x[:TRAIN_BATCH], out[:TRAIN_BATCH], ybar, loggbar,
                inverse=inverse, **LIM))
    return cases


def phi4_inputs(torch, f32, coef):
    """The action's, its force's and the slab kernels' cases on the 4-D
    flagship's 8^4 lattice, and at 1-D and 3-D."""
    cases = {}
    for lat in ((8, 8, 8, 8), (64,), (8, 8, 8)):
        w = coef(len(lat))
        field, g = f32((BATCH, *lat)), f32((BATCH,))
        for b in ((BATCH, TRAIN_BATCH) if len(lat) == 4 else (BATCH,)):
            shape = (b, *lat)
            cases[f"phi4_action {shape}"] = (
                "phi4_action", shape,
                lambda sc, ph, c=field[:b], w=w: ph.phi4_action(c, *w))
            cases[f"phi4_action_grad {shape}"] = (
                "phi4_action_grad", shape,
                lambda sc, ph, c=field[:b], gb=g[:b], w=w:
                ph.phi4_action_grad(c, gb, *w))
        if len(lat) == 1:
            continue
        rows = lat[0] // 2  # the first of two slabs, as a space rank holds
        slab = field[:, :rows].contiguous()
        halo = torch.stack([field[:, -1], field[:, rows]], 1).contiguous()
        shape = tuple(slab.shape)
        cases[f"phi4_action_slab {shape}"] = (
            "phi4_action_slab", shape,
            lambda sc, ph, s=slab, h=halo, w=w: ph.phi4_action_slab(s, h,
                                                                    *w))
        cases[f"phi4_action_slab_grad {shape}"] = (
            "phi4_action_slab_grad", shape,
            lambda sc, ph, s=slab, h=halo, g=g, w=w:
            ph.phi4_action_slab_grad(s, h, g, *w))
    return cases


def measure(src, label, path, cases=""):
    src = os.path.abspath(src)
    sys.path.insert(0, src)
    import numpy as np
    import torch

    import normflow__tpu_torch as nt
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc

    if not nt.__file__.startswith(src):
        raise RuntimeError(f"imported {nt.__file__}, not the port in {src}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    saved = {"card": card}
    print(f"{label}: CUDA events alone {event_floor_ms():.5f} ms on {card}")
    with torch.no_grad():
        coef = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef
        kept = {case: v for case, v in inputs(
            torch, np.random.default_rng(20261016), coef).items()
            if re.search(cases, case)}
        if any(name == "accept_scan" for name, _, _ in kept.values()):
            for threads in (256, 1024):
                print(f"{label}: an empty kernel, one block of {threads} "
                      f"threads, warm {empty_kernel_ms(threads):.5f} ms on "
                      f"{card}", flush=True)
        for case, (name, shape, call) in kept.items():
            if name.endswith("_cl") and not hasattr(sc, "coupling_layout"):
                print(f"{label}: {case} left out: this checkout has no "
                      "channels-last kernels")
                continue
            fn = lambda: call(sc, phi4)  # noqa: E731
            try:
                got = fn()
            except ValueError as e:  # a shape this checkout refuses
                print(f"{label}: {case} left out: {e}")
                continue
            torch.cuda.synchronize()
            saved[case] = [t.cpu() for t in
                           (got if isinstance(got, tuple) else (got,))]
            warm, cold = warm_ms(fn), cold_ms(fn)
            bms, by = bound_ms(*work(name, shape), peaks)
            print(f"{label}: {case} warm {warm:.5f} ms ({bms / warm:.3f} of "
                  f"bound), cold {cold:.5f} ms ({bms / cold:.3f}); bound "
                  f"{bms:.5f} ms ({by}) on {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(saved, path)
    print(f"{label}: outputs saved to {path}")
    print_sass(label, torch, card)


# the device functions whose SASS measure() counts, and the threads the
# path gives each launch (one per site; per float4 in the tiled force)
SASS_FUNCTIONS = (
    ("rqs_coupling_kernel", BATCH * LAT[0] * LAT[1] // 2),
    ("rqs_coupling_tiled_kernel", BATCH * LAT[0] * LAT[1] // 2),
    ("rqs_coupling_bwd_kernel", TRAIN_BATCH * LAT[0] * LAT[1] // 2),
    ("rqs_coupling_bwd_tiled_kernel", TRAIN_BATCH * LAT[0] * LAT[1] // 2),
    ("phi4_action_grad_kernel", TRAIN_BATCH * LAT[0] * LAT[1]),
    ("phi4_action_grad_tiled_kernel", TRAIN_BATCH * LAT[0] * LAT[1] // 4),
    # the tiled nd kernels at the 8^4 flagship's batch and step, per float4
    # group: their loop over a thread's groups is one group's code, and the
    # once-a-sample wait (and the action's reduction) inside the counted
    # range is charged to every group, so the issue time is an upper bound
    ("phi4_action_tiled_nd_kernel", BATCH * 8 ** 4 // 4),
    ("phi4_action_grad_tiled_nd_kernel", TRAIN_BATCH * 8 ** 4 // 4),
    # the tiled nd slab kernels on a slab of half the 8^4 lattice at
    # B = 1024, (1024, 4, 8, 8, 8), per float4 group
    ("phi4_action_slab_tiled_nd_kernel", BATCH * 8 ** 4 // 8),
    ("phi4_action_grad_slab_tiled_nd_kernel", BATCH * 8 ** 4 // 8),
    ("rqs_coupling_cl_kernel", BATCH * LAT[0] * LAT[1] // 2),
    ("rqs_coupling_cl_tiled_kernel", BATCH * LAT[0] * LAT[1] // 2),
    ("rqs_coupling_bwd_cl_kernel", TRAIN_BATCH * LAT[0] * LAT[1] // 2),
    ("rqs_coupling_bwd_cl_tiled_kernel", TRAIN_BATCH * LAT[0] * LAT[1] // 2))
FLAGSHIP_INSTANCE = "ILi8ELb1ELb1E"  # m = 8, linear tails, as mangled
ND4_INSTANCE = "ILi4EE"  # the tiled nd kernels' 4-D instance


def print_sass(label, torch, card):
    """The SASS instructions of the flagship's instance (forward and
    inverse; the tiled nd kernels' 4-D one) of each of
    :data:`SASS_FUNCTIONS` that the library built, and
    the time the issue of the site instructions alone needs at the path's
    shapes at the card's highest SM clock."""
    from normflow__tpu_torch.ops.kernels import _lib

    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _lib.library()  # built already, unless no case was timed
    counts = sass_counts(_lib.build_info["path"])
    for fn, threads in SASS_FUNCTIONS:
        for inst, (n, site) in sorted(counts.items()):
            if f"{len(fn)}{fn}" not in inst or (
                    "rqs" in fn and FLAGSHIP_INSTANCE not in inst) or (
                    "tiled_nd" in fn and ND4_INSTANCE not in inst):
                continue
            what = ("" if "rqs" not in fn else " inverse" if inst.split(
                FLAGSHIP_INSTANCE)[1].startswith("Lb1") else " forward")
            ms = issue_ms(threads, site, n_sm, clock)
            print(f"{label}: SASS {fn}{what}: {n} instructions, {site} from "
                  f"the first load to the last store; their issue for "
                  f"{threads} threads {ms:.5f} ms ({n_sm} SMs at {clock:.0f} "
                  f"MHz) on {card}")


def _bits(torch, t):
    """A float32 tensor's bits; any other tensor as it is."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def compare(path_a, path_b):
    """Hold the outputs of two runs against each other; 0 if they agree."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    ok = True
    for case in a:
        if case == "card" or case not in b:
            continue
        if case.split()[0] in ("phi4_action", "phi4_action_slab"):
            want, got = a[case][0].double(), b[case][0].double()
            rel = float(((got - want).abs() / want.abs().clamp(min=1.0))
                        .max())
            same = rel <= PHI4_REL_TOL
            bits = torch.equal(_bits(torch, a[case][0]),
                               _bits(torch, b[case][0]))
            what = (f"max |dS|/max(1,|S|) {rel:.3e} (tol {PHI4_REL_TOL}), "
                    f"{'bit for bit' if bits else 'not bit-identical'}")
        else:
            pairs = list(zip(a[case], b[case]))
            same = all(torch.equal(_bits(torch, p), _bits(torch, q))
                       for p, q in pairs)
            diff = max(float((p.double() - q.double()).abs().max())
                       for p, q in pairs)
            what = ("bit for bit" if same
                    else f"not bit-identical: max |d| {diff:.3e}")
        print(f"{case}: {what}{'' if same else ' FAILED'}")
        ok &= same
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    measure(*sys.argv[1:5])
