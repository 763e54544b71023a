#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``normflow__tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc`` (the kernels are built from
``normflow__tpu_torch/csrc/`` into ``normflow__tpu_torch/_build/`` at first
use) and imports nothing of JAX.  Phases, each of which raises on failure:

1. the card's name and power limit; TF32 off; build the kernels;
2. every kernel, forward and backward, against its plain PyTorch version
   on the card, at the flagship's shapes, with the tolerances stated below;
   ``accept_scan`` bit for bit at lengths 1 to 10,000 on random chains,
   one stuck on a heavy state and one that accepts from no state; the
   coupling and its
   VJP at the unpacked flagship's 1024 sites per sample (tiled), the
   action and its force at the affine example's (128, 8, 8) (general);
   the coupling and the action on one sample, the blocked sampler's batch;
3. rates in turns: raw samples/s and training steps/s of the eager bodies
   in a Python loop and of the graphed entry points, alternating, on
   flagships of their own, before any profiler has run in the process;
   proposals/s of ``logqp_stream``, ``sample_chain`` and
   ``sample_parallel_chains``; the packed against the unpacked flagship's
   graphed samples/s and steps/s; the float32 against the bf16
   conditioners' graphed samples/s, and the plain against the controlled
   couplings' graphed steps/s; the blocked sampler's block proposals/s,
   eager against graphed sweeps on the same draws, at 4 and 16 blocks;
4. the sampling path: the full-width 32x32 phi^4 flagship with seeded
   perturbed weights, compared GPU vs CPU, then ``logqp_stream`` -> ESS
   and acceptance, ``mcmc.sample__`` twice, ``backward_sanitychecker``,
   with every launch counter set to 0 just before the stream, the stream
   profiled, and the counts read after it; then on the same flagship, each
   with its counters set to 0 just before and read after:
   ``mcmc.sample_chain`` (32 rounds of 1024, profiled; 8 graphed rounds
   against their eager bodies bit for bit; ``accept_scan`` on the
   flagship's ``logq - logp``; observables of the samples),
   ``mcmc.sample_parallel_chains`` (32 rounds of 1024 chains, profiled;
   graphed against eager bit for bit) and ``blocked_mcmc.sample__(4,
   n_blocks=K)`` for K = 4 and 16 (its first call profiled; replayed
   against the eager sweep on the same draws bit for bit; a warm call's
   replays by profiler name, no wrapper call);
5. the training path: one path-gradient loss and its gradients, GPU vs a
   CPU copy; then ``model.fit`` with the bench protocol's settings
   (``bench.py:278-286``) for ``N_STEPS`` steps on a fresh seeded
   flagship, counters set to 0 just before, the fit profiled, and the
   counts read after;
6. the zero-dim fit (``examples/scalar_zerodim.py``) on the card, whose
   one-site lattice takes the general kernels; a zero-dim model fitted
   300 steps, whose <phi^2> through each of the three samplers must match
   the quadrature;
7. replay against eager at full width: three replayed sampled batches
   against their eager bodies from one generator state, bit for bit, and
   10 replayed training steps against 10 eager bodies from one state, and
   10 eager bodies against 10 more from that state, within the tolerance
   stated below; then the protocol resumed (``tools/protocol_run``): 24 +
   24 steps of the full-width flagship with the bench's settings in two
   fresh ``Model``s, the second from the first's snapshot, against 48
   unbroken steps, within the same tolerances, under cuDNN's
   deterministic algorithms;
8. replays alone, profiled: the launches of each path by kernel name, and
   the device idle share of one eager and one replayed batch and step and
   of one replayed round of each graphed sampler and of one eager and one
   replayed block step;
9. the unpacked flagship (``build_phi4_model(packed=False)``, the
   reference's multiplicative checkerboard: the conditioners and the
   coupling kernel on all 1024 sites): logq against a float64 CPU copy,
   ``logqp_stream(32, 1024)`` profiled with its counters set to 0 just
   before, a replayed batch bit for bit with its eager body and its
   launches by name; one path-gradient step against a float64 CPU copy,
   ``UNPACKED_STEPS`` steps of ``model.fit`` profiled likewise, 10 replayed
   steps against 10 eager bodies and two replays' launches by name;
10. the reference's 8x8 affine example (``normflow__tpu_torch.examples.
    scalar_affine``, BASELINE config 2) at its defaults, trained 1000
    epochs (the first 200 profiled) and sampled with ``sample_chain(150,
    128)`` (profiled), each with the counters set to 0 just before (the
    action and its force take their general kernels: 8x8 has no tile); <phi^2> and chi must lie within 3
    combined sigma of the JAX package's record (``PARITY.md:170-171``);
11. the port's bench (``python3 -m normflow__tpu_torch.bench
    --train_epochs 200 --reps 2``), in process;
12. each kernel's time at the path's shapes (``rqs_coupling`` forward and
    inverse at the sampling and the training batch, ``rqs_coupling_bwd``
    in both training variants, forward and inverse; ``accept_scan`` at a
    chain round's 1024 proposals): the median device
    time of a wrapper call, from CUDA events around it with the device held
    behind a spin kernel, less the events around nothing (printed first),
    warm (the same tensors again and again) and cold (L2 flushed before
    each launch), its plain version's device time from the profiler, and
    the least time the card could take (bytes or operations over the
    peak), with
    ``normflow__tpu_torch/tools/kernel_times.py``'s helpers; the new paths'
    shapes under each kernel's ``variants`` (the coupling forward and the
    action at B = 1 among them, the blocked sampler's);
13. the U(1) gauge sector, BASELINE config 5 at full width
    (``zoo.build_u1_model()``: 32 plaquette couplings, 107,168
    parameters): the flow's angles (modulo 2 pi) and logq against a
    float64 CPU copy, seeded perturbed weights; ``logqp_stream(16, 512)``
    profiled with every counter set to 0 just before (no kernel of the
    port runs: the gauge flow is plain PyTorch, as it is plain XLA in the
    JAX package) and a replayed batch bit for bit with its eager body;
14. one path-gradient step of a fresh config 5 model against float64,
    then ``model.fit`` for ``U1_STEPS`` steps at batch 256 (clip 25, path
    gradient, lr 1e-3), the first ``U1_PROFILED`` profiled with the
    counters set to 0 just before, and 10 replayed steps bit for bit with
    10 eager bodies under cuDNN's deterministic algorithms;
15. ``mcmc.sample_chain`` on it in calls of 32 rounds of 512 (the first
    profiled: 1 ``accept_scan`` per round) until <cos P>'s binned error is
    at most 0.002; <cos P> within 3 sigma of I1(2)/I0(2) from
    ``scipy.special``;
16. the Schwinger model: the exact Schur log-det in float32 on the card
    against the dense float64 ``slogdet`` on the CPU and its gauge
    invariance on the card; ``examples/schwinger.py``'s ``main()`` at its
    defaults with every counter set to 0 just before and read after;
    replayed steps (no port kernel) and 64 replayed chain rounds of 128
    profiled, then calls of 64 more until <cos P>'s binned error is at
    most 0.002 (at most 1024 rounds); <cos P> more than 3 binned sigma
    above I1(2)/I0(2);
17. the stochastic log-det: its gradient's mean over 256 probe draws at
    4x4 against the exact gradient on the card, and a 16x16 Schwinger fit
    with ``StochasticStaggeredLogDet(n_probes=2, cg_tol=1e-5)``: 32
    replayed steps, replays bit for bit with eager bodies under cuDNN's
    deterministic algorithms, the CG iterations a step's probe systems
    need, and sampling with the exact, keyless action;
18. BASELINE config 4 at full width (64x64, 4 couplings, hidden (16,
    16), 8 knots, batch 512, 1024 chains): the coupling and its VJP at
    S = 2048 and the action and its force at 64x64 (1024-thread tiles)
    against their plain versions; a world-size-1 NCCL group on a free
    localhost port; ``examples.scalar_64x64_distributed.main()`` with the
    coarse fit and the epochs cut for time (``C4_*`` below), the wrapper
    counts set to 0 just before and read after; the transferred flow's
    logq against a float64 CPU copy and a quality bar on the zero-shot
    loss per site; a profiled fine-tune (4 / 4 / 1 / 1 per step: the
    example's reparametrization gradient; the gradients' all-reduce
    inside every replayed step), profiled parallel
    chains (4 / 1 per round) and ``sample_chain`` (4 / 1 / 1 per round,
    the proposals' gather inside), all tiled; 10 replayed steps against
    10 eager bodies bit for bit under cuDNN's deterministic algorithms;
    rates, idle shares, the data-parallel bucket's time per step (at world
    size 1 its flat copy and division: a one-rank NCCL all-reduce launches
    no kernel), and the kernels' times at these shapes; its added wall
    time;
19. (after phase 8) the bf16 sampling path: the sampling flagship through
    ``zoo.with_conv_compute_dtype(net_, torch.bfloat16)`` on a ``Model`` of
    its own (the bench's ``cuda_bf16`` arm): kernels 1 and 3 against their
    plain versions at the inputs this path gives them (the conditioner's
    output cast back to float32); logq against the float32 flow on the
    same draws, max and mean gap per sample, on the card and on the CPU
    (the card's gap at most twice the CPU's); ``logqp_stream(32, 1024)``
    profiled with the counters set to 0 just before (4 / 1 per batch, all
    tiled); 3 replayed batches bit for bit with their eager bodies under
    cuDNN's deterministic algorithms; where a replayed float32 and bf16
    batch's time goes, and the conv kernels' share;
20. the controlled coupling training: the flagship with its four
    couplings as one ``CntrRQSplineCoupling`` whose conditioners' first
    layer reads a normal control of the frozen partition's shape, trained
    ``N_STEPS`` steps with the bench protocol, profiled with the counters
    set to 0 just before (8 / 8 / 1 / 1 per step, all tiled), the loss
    finite and falling; two replays drawing different controls into one
    buffer; 10 replayed steps against 10 eager bodies bit for bit under
    cuDNN's deterministic algorithms; where a replayed step's time goes;
21. lattice (space) sharding.  Step 1 (with the kernel checks of phase
    2): the slab variants of the action and its force
    (``phi4_action_slab``, ``phi4_action_slab_grad``) on two slabs of a
    (1024, 32, 32) and of a (1024, 64, 64) field with halos built by hand,
    summed and stacked, against the whole-lattice tiled kernels and the
    plain slab versions (``PHI4_REL_TOL``, ``FORCE_*``), on the tiled
    kernels; (1024, 8, 8, 8, 8) as two slabs of 4 rows and as 3 / 3 / 2
    and (64, 8, 8, 8) as two on the tiled nd slab kernels, each slab's
    force bit for bit against the general slab entry; the general ones at
    1-D, (128, 8, 8), an odd (64, 3, 5, 4, 6) and on (1024, 32, 32) split
    over three ranks as XLA splits it, slabs of 11, 11 and 10 rows, the
    tiled and tiled nd forces bit for bit against the general one on an
    offset copy, a slab of no rows with no launch; timed with phase 12,
    (1024, 11, 32) and (1024, 10, 32) too, and the tiled nd slab kernels
    named by the profiler and timed in turns with the general entries at
    (1024, 4, 8, 8, 8), (128, 4, 8, 8, 8), (1024, 3, 8, 8, 8) and (1024,
    4, 8, 8).  Step 2: two processes on the one card in a gloo
    group of two (NCCL refuses two ranks on one device),
    ``use_mesh(axes={"data": 1, "space": 2})``, the kernels built by the
    parent first: the full-width flagship's logq and logp of a fed batch of
    1024 (seeded perturbed weights) against the unsharded flagship on the
    card, ``SPACE_STEPS`` (12) eager steps of the bench protocol on fed
    draws from the fresh weights against the unsharded eager fit (step 1
    to ``LOGQ_REL_TOL``, the rest to ``SPACE_LOSS_TOL`` or ``SPACE_FLOOR``
    times the unsharded fit's own spread), 8 / 8 / 1 / 1 wrapper launches
    per step (``rqs_coupling``, ``rqs_coupling_bwd``, ``phi4_action_slab``,
    ``phi4_action_slab_grad``, all tiled) and ``sample_chain(4, 1024)`` at
    4 / 1 / 1 per round, with
    the counters set to 0 just before and read just after each; then, on
    the perturbed weights, ``blocked_mcmc.sample__(2, n_blocks=K)`` for K
    = 4 and 16 on each rank, captured over gloo (the whole lattice, no
    collective inside): its replays against the eager sweep on the same
    draws bit for bit, against the unsharded flagship's replays on the
    same generator state (logq and logp to ``LOGQ_REL_TOL``, accepts
    equal), and a warm call with no wrapper launch; rates and the phase's
    wall time (gloo stages every collective through the host: no speed
    claim).  Step 3: three processes, ``{"data": 1, "space": 3}``, slabs
    of 11 / 11 / 10 rows (odd heights, the second from an odd row): logq
    and logp of the fed batch, ``sample_chain(3, 1024)`` on fed rounds
    (its proposals against the unsharded flagship's eager rounds, its
    decisions bit for bit against the plain recurrence) and 8 eager steps
    against the unsharded fit, the wrappers' launches per batch, round and
    step with the variant each took (the couplings tiled, the slab
    kernels general);
22. the channels-last route (``build_phi4_model(coupling_backend=
    "pallas_reg")``, the JAX package's ``pallas_reg`` backend), last, on a
    numpy stream of its own (``CL_SEED``): the channels-last coupling
    kernels and VJPs at S = 512 and 1024 bit for bit against the NCHW
    kernels on the same values and against their plain versions (the
    element-by-element VJP bar on ``check_coupling_at``'s inputs), an
    ``out`` of other strides refused; the full-width flagship on the route
    against a float64 CPU copy, ``logqp_stream(32, 1024)`` profiled with
    its counters set to 0 just before (4 channels-last couplings and 1
    tiled action per batch, no NCHW coupling), replays bit for bit with
    eager bodies and by name, ``mcmc.sample__``; phase 5's training step
    on the route against float64, ``CL_STEPS`` steps of ``model.fit``
    profiled likewise (8 / 8 / 1 / 1 per step, couplings and VJPs
    channels-last), 10 replayed steps against eager ones bit for bit under
    cuDNN's deterministic algorithms; the bf16 copy on the route; then,
    printed only, samples/s and steps/s against the NCHW
    route in turns, where a replayed batch's (float32 and bf16) and step's
    time goes on both routes, and the channels-last kernels' times with
    the NCHW ones on the same values;
23. phi^4 on 4-D lattices.  Step 1 (with the kernel checks of phase 2):
    the action and its force on the tiled nd kernels at (1024, 8, 8, 8,
    8), (512, 8, 8, 8, 8) and (1024, 8, 8, 8) against their plain versions
    and the general kernels' C entries (the force bit for bit); at (64, 3,
    5, 4, 6) on the general kernels against their plain versions; a 5-D
    field refused;
    with phase 12, the tiled nd kernels named by the profiler and timed in
    turns with the general ones.  Step 2 (last, ``run_4d``): the
    4-D flagship at 8^4 (``build_phi4_model((8, 8, 8, 8), packed=False)``:
    ConvNet 1->24->24->22 with 3^4 circular kernels by roll-and-sum, the
    PSD block's 4-D FFT) with seeded perturbed weights: logq against a
    float64 CPU copy; ``logqp_stream(LAT4_BATCHES, 1024)`` profiled with its
    counters set to 0 just before (4 ``rqs_coupling``, tiled, and 1
    ``phi4_action``, tiled nd, per batch), a replayed batch bit for bit
    with its eager body and by name, its profile, raw samples/s eager and
    graphed in turns; one graphed chain round of 1024 (4 / 1 / 1
    ``accept_scan``) profiled likewise and bit for bit with its eager
    body; a fresh 8^4 flagship's path-gradient step against float64 (at
    ``LAT4_STEP_BATCH``: see there), ``LAT4_STEPS`` steps of the bench
    protocol's fit at 512 with the learning rate ``LAT4_LR`` (see there)
    profiled likewise (8 / 8 / 1 / 1 per step), a replayed step by name,
    its profile, a replayed step bit for bit with an
    eager one, under cuDNN's deterministic algorithms; the free field at
    4^4 (kappa 1, m^2 1, lambda 0) trained ``FREE_STEPS`` steps, then
    ``sample_chain``: <phi^2> within 3 binned sigma of the exact
    (1/V) sum_p 1 / (m^2 + 4 kappa sum_mu sin^2(p_mu / 2)).  Its graphed
    steps/s are taken in phase 24, in turns with the route's;
24. the channels-last route (``pallas_reg``) at 1-, 3- and 4-D
    (``run_cl_nd``): kernels 1 and 2 channels-last and tiled at the
    8^4 shapes, (1024, 22, 8^4) and (512, 22, 8^4), against the NCHW
    tiled kernels bit for bit and their plain versions to phase 22's bars,
    timed warm and cold; phase 23's weights through
    ``with_coupling_backend``: logq against phase 23's float64 logq, every
    conv and conditioner output channels-last (float32 and bf16),
    ``logqp_stream(CL4_BATCHES, 1024)`` profiled with its counters set to
    0 just before (4 channels-last tiled couplings, no NCHW one, 1 tiled
    nd action per batch), a replayed batch bit for bit under cuDNN's
    deterministic algorithms and by name, a graphed chain round by name
    and bit for bit; a fresh route flagship's step against float64,
    ``CL4_STEPS`` deterministic steps profiled likewise (8 / 8 / 1 / 1),
    a replayed step by name and bit for bit; printed, raw samples/s and
    steps/s against the NCHW 8^4 flagship in turns and where a replayed
    batch's and step's time goes; then small route flagships at (64,) and
    (8, 8, 8): logq against float64, layouts, launches by name and
    wrapper (the action general at (64,), tiled nd at (8, 8, 8)), a
    replayed batch bit for bit;
25. every training loss over two data ranks (``run_losses``): two
    gloo processes on the one card, ``{"data": 2}``, one eager step of the
    fresh full-width flagship at the global batch 512 on fed draws for
    each loss of ``training/losses.py`` (the gather of logq and logp over
    the data axis, the summed bucket), its loss and every gradient leaf
    against the unsharded eager step and a float64 CPU copy with phase 5's
    float64-anchored bars, both ranks bit for bit alike, ``calc_kl_mean``
    against the old flat-mean route (``FLAT_ROUTE_TOL``), 4 / 4 / 1 / 1
    wrapper launches a step;
26. the 8^4 flagship over two space ranks (``run_space4``, last): two
    gloo processes on the one card, ``{"data": 1, "space": 2}``, each a
    slab of 4 rows, eager, on phase 23's perturbed weights at the global
    batch 128 on fed draws: ``posterior.sample__``, one ``sample_chain``
    round, the first step's path gradient and two steps of the bench
    protocol at ``LAT4_LR``, held against the unsharded 8^4 flagship on the
    card with phase 21's bars (logq, logp, the chain's proposals and
    accepts, the loss and every gradient leaf), with the wrappers'
    launches per batch, round, gradient and step, every slab launch to the
    tiled nd slab kernels.

The gauge paths' rates (eager bodies against graphed entry points, in
turns) are taken in a phase of their own right after phase 3's, before any
profiler has run in the process; their idle shares are 1 - the profiled
device busy time / a wall time taken without the profiler, which slows
the replay of a graph of thousands of short kernels.

On a CUDA model ``logqp_stream``, ``model.fit``, ``mcmc.sample_chain``,
``mcmc.sample_parallel_chains`` and ``blocked_mcmc.sample__`` replay a
captured batch, step, round or block proposal
(``normflow__tpu_torch/utils/graphs.py``).  The main path's runs (phases
4, 5, 9, 10, 19 and 20) are profiled, and their launches are counted on the
card by kernel name: the ``WARMUP`` eager bodies before the capture and every
replay launch 4 ``rqs_coupling`` and 1 ``phi4_action`` per sampled batch,
8 / 8 / 1 / 1 per training step, 4 / 1 and 1 ``accept_scan`` per chain
round and 4 / 1 per parallel round, every one to the tiled kernel where
the kernel has one (the variant that phase 12 times), and the capture
launches nothing; the affine example's 8x8 lattice has no tile, so its
1 / 1 per training step and 1 ``phi4_action`` / 1 ``accept_scan`` per
chain round go to the general kernels.  The blocked sampler replays a
captured start and a captured block step, one flow forward on one sample
each (4 / 1 per forward: its first call shows 2 x ``WARMUP`` eager bodies,
one start and one step per proposal by profiler name, and 2 x (``WARMUP``
+ 1) per wrapper).  The record's ``launches_by_path`` are
these counts and ``launches`` their sum over the paths.  A wrapper's
launch counter runs with the wrapper, so it counts the warm-up and the
capture, ``WARMUP + 1`` calls per batch, step or round, not the replays:
it must show exactly that too, every call to the tiled kernel where
there is one.  Phase 8 profiles replays alone, which
must launch the same per batch or step with no wrapper call
(``replay_launches_per_unit`` in the record).  Phase 22's runs count the
channels-last kernels (records ``rqs_coupling_cl`` and
``rqs_coupling_bwd_cl``; the wrappers' ``cl_launches``) in the couplings'
place, every one tiled, and no NCHW coupling kernel.

Kernels 1 and 2 are read cold (the training backward finds ``out`` cold:
it was written during the forward, and the other conditioners' outputs
came after it), kernels 3 and 4 warm (their input is the flow output just
written); ``headline`` in the kernels' record says which.

Phase 23's runs take the tiled nd kernels for the action and its force
and the tiled coupling kernels (4096 sites a sample): records ``4d
sample``, ``4d chain`` and ``4d train`` in ``launches_by_path``, of the
wrappers' records and of the tiled nd kernels' own, ``phi4_action_tiled_nd``
and ``phi4_action_grad_tiled_nd``.  Phase 24's route counts the
channels-last records there: ``4d channels-last sample`` / ``train``,
``1d`` and ``3d channels-last sample`` (the tiled nd kernels' at 3-D and
4-D).

Phase 21's sharded runs are eager (a gloo collective cannot sit in a CUDA
graph) and are counted by the wrappers in each rank's process: 8 / 8 / 1 /
1 per step, the slab kernels in place of kernels 3 and 4 (tiled at two
ranks' 16 rows, general at three ranks' 11 / 11 / 10: records ``space3
sample``, ``space3 chain``, ``space3 fit``); the record's
``launches_by_path`` sum the ranks.  Phase 25 counts 4 / 4 / 1 / 1 a step
of each loss over two data ranks (record ``losses``).  Phase 26 (last)
counts the 8^4 slabs' launches the same way (records ``space4 sample``,
``space4 chain``, ``space4 grads``, ``space4 fit``), every slab launch
also under the tiled nd slab kernels' own records,
``phi4_action_slab_tiled_nd`` and ``phi4_action_slab_grad_tiled_nd``.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import copy
import functools
import gc
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
# rqs_coupling_bwd against its plain versions, element by element:
# |got - plain| <= VJP_ATOL + rtol |plain|.  VJP_ATOL is the JAX gradient
# tests' atol (tests/test_kernels.py:148-149); the relative term serves the
# sites where the spline is steep and the adjoints reach 1e3 and more.
# The whole-tensor bar max|d| / max(1, max|plain|) <= VJP_ATOL must hold
# too, but a few steep sites set its denominator, so it alone would pass
# an adjoint wrong on every ordinary site.
# VJP_RTOL holds the kernel against the plain VJP (the same formulas in the
# same order).  That the hand-derived VJP is the derivative is held in
# float64: the plain VJP against autograd of the plain forward, both on the
# float64 copies of the same inputs, element by element within F64_VJP_TOL
# (|d| <= F64_VJP_TOL (1 + |autograd|); they agree to about 1e-12 at the
# steepest sites).  Autograd of the float32 forward is a different float32
# computation (for the inverse it differentiates the citardauq root) whose
# rounding at the steep sites depends on the draw: it is printed against
# AUTOGRAD_RTOL, not gated.
VJP_ATOL, VJP_RTOL, AUTOGRAD_RTOL = 2e-4, 2e-4, 1e-3
F64_VJP_TOL = 1e-8
# The channels-last phase's fresh draws hold the kernel to the plain VJP
# per element within max(VJP_ATOL + VJP_RTOL |plain|, VJP_FLOOR_FACTOR
# |plain - plain64|), plain64 the float64 plain VJP on the same inputs: at
# an ill-conditioned adjoint (the softmax transposition's suffix - A) no
# float32 evaluation holds the relative bar (one outbar element once read
# 1.686 of it, float64 putting the kernel 2.513e-3 and the plain version
# 2.091e-3 off).  |got - plain| <= |got - plain64| + |plain - plain64|, and
# two float32 evaluations of the same formulas err by amounts of one order
# there, so a factor of 4 admits a kernel up to three times as far from
# float64 as the plain version; on the ordinary sites the plain version is
# float32-exact and the floor adds nothing, so a planted wrong adjoint (1%
# of the median |plain| on every element) stays far above the bar.
VJP_FLOOR_FACTOR = 4.0
FORCE_RTOL, FORCE_ATOL = 2e-4, 2e-5  # tests/test_kernels.py:36-37
# GPU (float32, TF32 off) vs a float64 CPU copy, one path-gradient step at
# batch 512: the loss, relative, and |g_gpu - g_cpu| / |g_cpu| per leaf.
# The float64 copy is the reference because a float32 CPU copy is itself up
# to 3.4e-3 off it on the mean-field leaves (this check's printout on an
# H100 80GB HBM3: card vs float64 1.7e-6 / 2.6e-4, CPU float32 vs float64
# 2.3e-6 / 3.4e-3).
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
# The unpacked flagship's leaves each take the larger of TRAIN_GRAD_TOL and
# FLOOR_FACTOR times the float32 CPU copy's own |dg|/|g| against float64:
# the mean-field leaves' gradients sum the action's force over all 1024
# sites, where float32 cancels to 4.5e-3 on the CPU too (this check's
# printout on an H100 80GB HBM3: card 5.7e-3, CPU float32 4.5e-3 there,
# both <= 2.2e-4 on every other leaf).
FLOOR_FACTOR = 2.0
# 10 replayed training steps vs 10 eager bodies from one state, full width:
# the losses, relative, and the parameters, absolute.  Both run the same
# kernels on the same draws, but cuDNN's default weight-gradient algorithms
# may sum in another order on every run, eager or replayed.
REPLAY_LOSS_TOL = 1e-5
REPLAY_PARAM_TOL = 1e-5
# the protocol resumed on the card (tools/protocol_run): each piece's steps
RESUME_STEPS = 24

N_BATCHES, BATCH = 32, 1024
# the blocked sampler: sweeps per sample__ call on the main path, and the
# block proposals of each run that phase 3 times
BLOCKED_BATCH, BLOCKED_PROPOSALS = 4, 256
LAT = (32, 32)
TRAIN_BATCH, N_STEPS = 512, 48  # the bench protocol's batch, a few steps
UNPACKED_STEPS = 16  # the unpacked flagship's profiled fit
# the 8x8 affine example (examples/scalar_affine.py, BASELINE config 2) as
# scripts/parity_observables.py:run_ours trains and samples it, and the JAX
# package's record of it (PARITY.md:170-172): <phi^2>, chi, accept
AFFINE_EPOCHS, AFFINE_BATCH, AFFINE_ROUNDS = 1000, 128, 150
# the first AFFINE_PROFILED epochs are profiled: the profiler takes ~0.1 s
# per replayed step of this flow (1000 steps: 107 s on an H100 80GB HBM3)
AFFINE_PROFILED = 100
AFFINE_ACTION = dict(kappa=0.67, m_sq=-4 * 0.67, lambd=0.5)
JAX_RECORD = {"phi2": (0.84888, 0.00157), "chi": (3.565, 0.278)}
JAX_ACCEPT = 0.586
OBS_SIGMAS = 3.0
# BASELINE config 5, zoo.build_u1_model() at its defaults: logqp_stream and
# chain rounds of U1_BATCH, U1_STEPS training steps at U1_TRAIN_BATCH (the
# first U1_PROFILED profiled), chain calls of U1_CHUNK rounds until <cos P>'s
# binned error is U1_COSP_ERR or less (at most U1_MAX_ROUNDS rounds).  After
# 300 steps the chain accepted 0.05 and stuck for long runs: 196,608
# configurations left the error at 0.0034; 400 and 600 steps reached 0.002
# with 64 and 32 rounds (accept 0.075, 0.095; H100 80GB HBM3 runs), so the
# fit takes 600 steps, which keeps the smoke inside its time limit
U1_LAT = (16, 16)
U1_STREAM, U1_BATCH = 16, 512
U1_TRAIN_BATCH, U1_STEPS, U1_PROFILED = 256, 600, 2
U1_CHUNK, U1_MAX_ROUNDS, U1_COSP_ERR = 32, 512, 0.002
# U(1) flow angles on the card vs float64, modulo 2 pi: at least this, and
# FLOOR_FACTOR times the float32 CPU copy's own error (the spline of 32
# couplings with perturbed weights is steep: 2.5e-4 on the CPU in float32)
U1_ANGLE_TOL = 1e-4
# the Schwinger example (examples/schwinger.py's defaults) and the JAX
# package's records of its <cos P> (docs/EXPERIMENTS.md:684-693, 1060-1063)
SCHWINGER_LAT, SCHWINGER_ROUNDS = (8, 8), 64
# its chain runs on in calls of SCHWINGER_ROUNDS until <cos P>'s binned
# error is U1_COSP_ERR or less: 64 rounds (8192 configurations, accept 0.14)
# left it at 0.0074 and the shift 2.51 sigma (an H100 80GB HBM3 run, 700 W)
SCHWINGER_MAX_ROUNDS = 1024
SCHWINGER_RECORDS = "0.7338, 0.7236, 0.7315 (stochastic)"
# the stochastic log-det's fit at 16x16 (docs/EXPERIMENTS.md:1055's settings)
STOCH_LAT, STOCH_BATCH, STOCH_STEPS, STOCH_CG_TOL = (16, 16), 64, 32, 1e-5
# Schur log-det in float32 vs float64, relative to max(1, |log det|): a
# float32 CPU Schur path is ~4e-7 off float64 at 8x8 and 16x16 on random
# links; the bar gives ten times that
LOGDET_REL_TOL = 5e-6


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
    """Run ``fn()`` ``reps`` times in a profiled window
    (``kernel_times.device_window``).  Returns the host wall seconds of
    the loop (ending in a synchronise) and ``(name, microseconds)`` of
    every device activity it caused."""
    import torch

    from normflow__tpu_torch.tools.kernel_times import device_window

    with device_window() as events:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, events


def kernel_times(name, fn, plain_fn, plain_reps=20):
    """Per-call times of a kernel's wrapper and of its plain version: the
    median device time of one wrapper call, which launches the kernel
    once, from CUDA events around it with the device held behind a spin
    kernel, less what the events add around nothing
    (``kernel_times.warm_ms``), warm (``ms``) and with L2 flushed
    before each (``ms_cold``); the plain version's device time per
    call over ``plain_reps`` calls (``plain_ms``); the CUDA-event median of
    one call, host overhead included (``call_ms``, ``plain_call_ms``)."""
    from normflow__tpu_torch.tools.kernel_times import cold_ms, warm_ms

    dev = device_profile(plain_fn, plain_reps)[1]
    if not dev:
        raise AssertionError(f"the profiler saw no device time in {name}'s "
                             "plain version")
    return dict(ms=warm_ms(fn), ms_cold=cold_ms(fn),
                plain_ms=sum(us for _, us in dev) / plain_reps / 1e3,
                call_ms=time_ms(fn), plain_call_ms=time_ms(
                    plain_fn, reps=plain_reps, warmup=min(5, plain_reps)))


def report(name, t, shape, peaks, kernels, headline):
    """Record a kernel's times and bound; ``headline`` ("warm" or "cold")
    names the reading that stands for the path."""
    from normflow__tpu_torch.tools.kernel_times import (FLUSH_BYTES,
                                                         bound_ms, work)

    nbytes, nops = work(name, shape)
    bms, by = bound_ms(nbytes, nops, peaks)
    kernels[name].update(
        bound_ms=bms, bound_by=by, bound_share=bms / t["ms"],
        bound_share_cold=bms / t["ms_cold"], headline=headline, **t,
        timing="device time of one wrapper call (one launch), median, from "
               "CUDA events around it, the device held behind a spin kernel"
               ", less the events around nothing; warm: the same tensors "
               f"again and again; cold: {FLUSH_BYTES >> 20} MB written "
               "before each launch; plain: torch.profiler device time per "
               "call")
    print(f"{name} at {shape}: warm {t['ms']:.5f} ms ({bms / t['ms']:.3f} of "
          f"bound), cold {t['ms_cold']:.5f} ms ({bms / t['ms_cold']:.3f}), "
          f"headline {headline}; plain {t['plain_ms']:.5f} ms; one call with "
          f"host overhead {t['call_ms']:.5f} ms, plain "
          f"{t['plain_call_ms']:.5f} ms; bound {bms:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB); library n/a")


def offset_copy(torch, t):
    """A copy of ``t``, dense in its strides (contiguous or channels-last),
    4 bytes off 16-byte alignment, which the wrappers send to their
    per-site or general kernel."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].as_strided(t.shape, t.stride())
    view.copy_(t)
    return view


def same_bits(torch, a, b):
    """Whether the float32 tensors of ``a`` and ``b`` agree bit for bit."""
    return all(torch.equal(p.view(torch.int32), q.view(torch.int32))
               for p, q in zip(a, b))


def check_rqs(torch, kernels, peaks, rng):
    """rqs_coupling vs its plain version at B=1024, K3=22, S=32x16, and
    its tiled kernel (the path's) vs the per-site kernel, bit for bit.
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
            sites = sc.rqs_coupling(offset_copy(torch, x), out, **kw)
            torch.cuda.synchronize()
            dy = float((y - yp).abs().max())
            dg = float((g - gp).abs().max())
            same = same_bits(torch, (y, g), sites)
            print(f"rqs_coupling extrap={extrap} inverse={inverse}: "
                  f"max|dy| {dy:.3e}  max|dlogg| {dg:.3e}  (tol {RQS_TOL});"
                  f" tiled vs per-site kernel "
                  f"{'bit for bit' if same else 'NOT bit-identical'}")
            if not (dy <= RQS_TOL and dg <= RQS_TOL and same):
                raise AssertionError("rqs_coupling disagrees with its plain "
                                     "version or its per-site kernel")
            worst = max(worst, dy, dg)
    # one sample, the blocked sampler's batch
    for inverse in (False, True):
        kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                  right="linear", inverse=inverse)
        got = sc.rqs_coupling(x[:1], out[:1], **kw)
        want = sc.rqs_coupling_plain(x[:1], out[:1], **kw)
        torch.cuda.synchronize()
        d = max(float((a - b_).abs().max()) for a, b_ in zip(got, want))
        variant = sc.coupling_variant(math.prod(lat), [x.data_ptr(),
                                                       out.data_ptr()])
        print(f"rqs_coupling at B = 1 (the blocked sampler's), inverse="
              f"{inverse}, {variant} kernel: max |d| {d:.3e} (tol {RQS_TOL})")
        if not d <= RQS_TOL:
            raise AssertionError("rqs_coupling disagrees with its plain "
                                 "version at B = 1")
        worst = max(worst, d)

    kernels["rqs_coupling"] = dict(
        name="rqs_coupling", route="cuda",
        source="normflow__tpu_torch/csrc/rqs_coupling.cu",
        replaces="normflow__tpu/ops/kernels/spline_coupling.py:121",
        max_abs_err=worst, library_ms=None)

    ptrs = [t.data_ptr() for t in (x, out)]
    variant = sc.coupling_variant(math.prod(lat), ptrs)
    print(f"rqs_coupling at the flagship's shape takes the {variant} kernel")
    if variant != "tiled":
        raise AssertionError("the flagship's shape does not take the tiled "
                             "rqs_coupling kernel")

    def time_it():
        """Time the tiled kernel forward and inverse, with linear
        extrapolation, at the sampling batch (the record's times: forward,
        read cold) and at the training batch (the first 512 samples of the
        same tensors); all four under ``variants``."""
        times = {}
        for what, inverse, b_ in (("forward", False, BATCH),
                                  ("inverse", True, BATCH),
                                  ("forward B=512", False, TRAIN_BATCH),
                                  ("inverse B=512", True, TRAIN_BATCH)):
            kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                      right="linear", inverse=inverse)
            xb, ob = x[:b_], out[:b_]
            times[what] = kernel_times(
                "rqs_coupling", lambda: sc.rqs_coupling(xb, ob, **kw),
                lambda: sc.rqs_coupling_plain(xb, ob, **kw))
            print(f"rqs_coupling {what}: warm {times[what]['ms']:.5f} ms, "
                  f"cold {times[what]['ms_cold']:.5f} ms")
        report("rqs_coupling", times["forward"], tuple(out.shape), peaks,
               kernels, "cold")
        kernels["rqs_coupling"]["variants"] = times
        kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                  right="linear")
        x1, o1 = x[:1], out[:1]
        record_variant("rqs_coupling", "forward B=1 (blocked sampler)",
                       kernel_times("rqs_coupling",
                                    lambda: sc.rqs_coupling(x1, o1, **kw),
                                    lambda: sc.rqs_coupling_plain(x1, o1,
                                                                  **kw)),
                       tuple(o1.shape), peaks, kernels)

    return time_it


def check_phi4(torch, kernels, peaks, rng, action):
    """phi4_action vs its plain version, 1-D, 2-D (flagship) and 3-D.
    Returns the function that times it."""
    from normflow__tpu_torch.ops.kernels import phi4

    worst_abs = 0.0
    for shape in ((BATCH, 64), (BATCH, *LAT), (64, 8, 8, 8), (128, 1),
                  (BATCH, 16, 30)):
        cfgs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")
        w = action.get_coef(len(shape) - 1)
        variant = phi4.action_variant(shape[1:], cfgs.data_ptr())
        got = phi4.phi4_action(cfgs, *w)
        want = phi4.phi4_action_plain(cfgs, *w)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        rel = float((diff / want.abs().clamp(min=1.0)).max())
        print(f"phi4_action {shape}, {variant} kernel: max rel {rel:.3e} "
              f"(tol {PHI4_REL_TOL}), max abs {float(diff.max()):.3e}")
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
    if phi4.action_variant(LAT, cfgs.data_ptr()) != "tiled":
        raise AssertionError("the flagship's field does not take the tiled "
                             "phi4_action kernel")
    # one sample, the blocked sampler's batch (no draw of its own: the
    # numpy stream of the later phases stays as it was)
    one = cfgs[:1]
    got = phi4.phi4_action(one, *w)
    want = phi4.phi4_action_plain(one, *w)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    print(f"phi4_action {tuple(one.shape)} (the blocked sampler's), "
          f"{phi4.action_variant(LAT, one.data_ptr())} kernel: max rel "
          f"{rel:.3e} (tol {PHI4_REL_TOL})")
    if not rel <= PHI4_REL_TOL:
        raise AssertionError("phi4_action disagrees with its plain version "
                             "at B = 1")

    def time_it():
        """Time the flagship's shape, (1024, 32, 32), read warm, and the
        blocked sampler's one sample under ``variants``."""
        t = kernel_times("phi4_action", lambda: phi4.phi4_action(cfgs, *w),
                         lambda: phi4.phi4_action_plain(cfgs, *w))
        report("phi4_action", t, tuple(cfgs.shape), peaks, kernels, "warm")
        record_variant("phi4_action", "B=1 (blocked sampler)",
                       kernel_times("phi4_action",
                                    lambda: phi4.phi4_action(one, *w),
                                    lambda: phi4.phi4_action_plain(one, *w)),
                       tuple(one.shape), peaks, kernels)

    return time_it


def run_main_path(torch, kernels, rng, card):
    """The flagship sampling path, through the port's entry points."""
    from normflow__tpu_torch import (backward_sanitychecker, calc_ess,
                                     estimate_accept_rate)
    from normflow__tpu_torch.tools.kernel_times import (device_launches,
                                                         perturb_)
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

    # the main path's run, profiled: its first call captures the batch
    # (warm-up bodies and one capture through the wrappers), then replays
    # it 32 times
    counters = {k: c for k, c in _counters().items()
                if k in ("rqs_coupling", "phi4_action")}
    n_layers = len(model.net_[2].nets)
    per_batch = {"rqs_coupling": n_layers, "phi4_action": 1}
    reserved = pool_reserved(torch)
    reset_counts(counters)
    t0 = time.perf_counter()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(N_BATCHES, BATCH))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "sample", per_batch, N_BATCHES, device)
    print(f"the sampled batch's graph holds {pool_reserved(torch, reserved)} "
          f"MiB of device memory (B = {BATCH}) on {card}")

    if logqp.shape != (N_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("logqp stream is not finite or has the wrong "
                             "shape")
    ess = float(calc_ess(logqp))
    acc, acc_err = estimate_accept_rate(logqp.cpu().numpy(), seed=0)
    if not (0.0 < ess <= 1.0 and 0.0 <= acc <= 1.0):
        raise AssertionError(f"ESS {ess} / accept rate {acc} out of range")
    print(f"logqp_stream: ESS {ess:.5f}; accept {acc:.5f} +- {acc_err:.5f} "
          f"(random perturbed weights, untrained); the first call, capture "
          f"included, profiled, {seconds:.2f} s on {card}")

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


# 47-49 (short chains), both sides of one and two of the kernel's
# 1024-proposal chunks, and 10,000
SCAN_LENGTHS = (1, 2, 47, 48, 49, 1000, 1023, 1024, 1025, 2047, 2049, 10000)


def hold_scan(torch, what, lrand, logqp, ref):
    """``accept_scan``'s kernel against its plain version on the card at
    each of :data:`SCAN_LENGTHS`: identical accepts and indices."""
    from normflow__tpu_torch.ops.kernels.accept_scan import (
        accept_scan, accept_scan_plain)

    for n in SCAN_LENGTHS:
        got = accept_scan(lrand[:n], logqp[:n], ref)
        want = accept_scan_plain(lrand[:n], logqp[:n], ref)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"accept_scan on {what}, n = {n}: kernel vs plain "
              f"{'identical' if same else 'DIFFER'}, accept rate "
              f"{float(got[0].float().mean()):.4f}")
        if not same:
            raise AssertionError(f"accept_scan disagrees with its plain "
                                 f"version on {what} at n = {n}")


def check_accept_scan(torch, kernels, peaks):
    """accept_scan vs its plain version on random chains (log uniforms
    with ``-inf`` among them, and a ``+inf`` reference) and on a chain
    stuck on one heavy state (nothing after it is accepted) and on one
    whose logqp rises so steeply that no state accepts again (every state
    searches to its chunk's end), bit for bit; a planted wrong reference
    must change the result.  Its inputs come from a numpy generator of its
    own, which leaves the other phases' draws as they were.  Returns the
    function that times it at the chain's length, 1024."""
    from normflow__tpu_torch.ops.kernels.accept_scan import (
        accept_scan, accept_scan_plain)

    rng = np.random.default_rng(20261017)
    n = max(SCAN_LENGTHS)
    logqp = torch.tensor(rng.standard_normal(n) * 1.5, dtype=torch.float32,
                         device="cuda")
    lrand = torch.log(torch.tensor(rng.random(n), dtype=torch.float32,
                                   device="cuda"))
    stuck, stuck_lrand = logqp.clone(), lrand.clone()
    stuck[5] = -1e4
    lrand[::11] = -math.inf
    for ref in (0.5, math.inf):
        hold_scan(torch, f"a random chain, ref {ref}", lrand, logqp,
                  torch.tensor(ref, device="cuda"))
    hold_scan(torch, "a chain stuck on a heavy state", stuck_lrand, stuck,
              torch.tensor(0.5, device="cuda"))
    # ref - logqp[i] <= -40 from every state: below every log u drawn here
    rising = torch.arange(n, dtype=torch.float32, device="cuda") * 40
    rising_ref = torch.tensor(-40.0, device="cuda")
    hold_scan(torch, "a rising chain", stuck_lrand, rising, rising_ref)
    logqp[0], lrand[0] = 0.0, -0.25  # ref 0 accepts proposal 0, -0.5 not
    got = accept_scan(lrand, logqp, torch.zeros((), device="cuda"))[0]
    planted = accept_scan_plain(lrand, logqp,
                                torch.tensor(-0.5, device="cuda"))[0]
    if torch.equal(got, planted):
        raise AssertionError("the check of accept_scan let a planted wrong "
                             "reference pass")
    print("accept_scan: a planted wrong reference changes the accepts")
    kernels["accept_scan"] = dict(
        name="accept_scan", route="cuda",
        source="normflow__tpu_torch/csrc/accept_scan.cu",
        replaces="normflow__tpu/mcmc/metropolis.py:31",
        max_abs_err=0.0, library_ms=None)
    lr, lq = lrand[:BATCH].clone(), logqp[:BATCH].clone()
    ref = torch.tensor(0.5, device="cuda")

    def time_it():
        """Time one chain round's scan, n = 1024; read warm.  The plain
        version launches ~4,000 kernels a call: 3 calls time it.  Under
        ``variants``: the stuck and rising chains at n = 1024, where the
        searches are longest."""
        t = kernel_times("accept_scan", lambda: accept_scan(lr, lq, ref),
                         lambda: accept_scan_plain(lr, lq, ref),
                         plain_reps=3)
        report("accept_scan", t, (BATCH,), peaks, kernels, "warm")
        for what, (a, b, r) in (
                ("stuck chain", (stuck_lrand[:BATCH], stuck[:BATCH], ref)),
                ("rising chain", (stuck_lrand[:BATCH], rising[:BATCH],
                                  rising_ref))):
            t = kernel_times("accept_scan",
                             lambda a=a, b=b, r=r: accept_scan(a, b, r),
                             lambda a=a, b=b, r=r: accept_scan_plain(a, b, r),
                             plain_reps=3)
            record_variant("accept_scan", f"{what}, n = {BATCH}", t,
                           (BATCH,), peaks, kernels)

    return time_it


def path_counters(kinds):
    """The launch counters of the kernels named in ``kinds``."""
    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan

    return {k: c for k, c in {**_counters(), "accept_scan": accept_scan}
            .items() if k in kinds}


def run_chain_path(torch, kernels, model, card):
    """``mcmc.sample_chain`` on the sampling path's flagship: 32 rounds of
    1024 in one profiled call, the first of which captures the round, the
    counters set to 0 just before; then 8 graphed rounds against 8 eager
    round bodies from the same generator state, bit for bit; accept_scan
    against its plain version on the flagship's own ``logq - logp``; the
    observables of the chain's samples."""
    from normflow__tpu_torch.ops import observables
    from normflow__tpu_torch.tools.kernel_times import device_launches

    mcmc, gen = model.mcmc, model.generator
    per_round = {"rqs_coupling": len(model.net_[2].nets), "phi4_action": 1,
                 "accept_scan": 1}
    counters = path_counters(per_round)
    reserved = pool_reserved(torch)
    reset_counts(counters)
    t0 = time.perf_counter()
    device, out = device_launches(
        lambda: mcmc.sample_chain(N_BATCHES, BATCH))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "chain", per_round, N_BATCHES, device)
    print(f"the chain round's graph holds {pool_reserved(torch, reserved)} "
          f"MiB of device memory (B = {BATCH}) on {card}")
    rates = out["accept_rate"]
    if out["logq"].shape != (N_BATCHES, BATCH) or not bool(
            torch.isfinite(out["logq"]).all() & torch.isfinite(rates).all()):
        raise AssertionError("sample_chain's output is not finite or has "
                             "the wrong shape")
    print(f"sample_chain({N_BATCHES}, {BATCH}): accept rate per round "
          f"{float(rates.min()):.4f}-{float(rates.max()):.4f}, mean "
          f"{float(rates.mean()):.4f} (random perturbed weights); the first "
          f"call, capture included, profiled, {seconds:.2f} s on {card}")

    n = 8
    mcmc.reset()
    model.seed(31)
    got = mcmc.sample_chain(n, BATCH, collect_samples=True)
    ref = mcmc._ref
    model.seed(31)
    carry = [torch.zeros(LAT, device="cuda"),
             torch.tensor(math.inf, device="cuda"),
             torch.zeros((), device="cuda")]
    rounds = [mcmc.chain_body(BATCH, gen, carry) for _ in range(n)]
    want = [torch.stack([r[k] for r in rounds]) for k in (1, 2, 3, 0)]
    same = same_bits(torch, (got["logq"], got["logp"], got["accept_rate"],
                             got["samples"], *ref), (*want, *carry))
    print(f"sample_chain({n}, {BATCH}) graphed vs {n} eager rounds from one "
          f"generator state: logq, logp, accept rates, samples and the final "
          f"_ref {'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("graphed chain rounds differ from their eager "
                             "bodies")

    logqp = model.posterior.logqp_stream(10, BATCH)
    lrand = torch.log(torch.rand(logqp.shape, generator=gen, device="cuda"))
    hold_scan(torch, "the flagship's logq - logp", lrand, logqp, logqp[0])

    cfgs = got["samples"].reshape(-1, *LAT)
    print(f"observables of the chain's {cfgs.shape[0]} samples (random "
          f"perturbed weights): <phi^2> "
          f"{float(observables.phi2(cfgs).mean()):.5f}, susceptibility "
          f"{float(observables.susceptibility(cfgs)):.5f}, <|m|> "
          f"{float(observables.abs_mean_phi(cfgs).mean()):.5f}")


def run_parallel_path(torch, kernels, model, card):
    """``mcmc.sample_parallel_chains`` on the flagship: 32 rounds of 1024
    chains in one profiled call, the first of which captures the round,
    the counters set to 0 just before; then 32 graphed rounds against 32
    eager round bodies from one generator state, bit for bit."""
    from normflow__tpu_torch.tools.kernel_times import device_launches

    mcmc, gen = model.mcmc, model.generator
    per_round = {"rqs_coupling": len(model.net_[2].nets), "phi4_action": 1}
    counters = path_counters(per_round)
    reset_counts(counters)
    t0 = time.perf_counter()
    device, out = device_launches(
        lambda: mcmc.sample_parallel_chains(N_BATCHES, BATCH))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "parallel", per_round, N_BATCHES, device)
    rates = out["accept_rate"]
    if out["final_samples"].shape != (BATCH, *LAT) or not bool(
            torch.isfinite(out["logq"]).all()):
        raise AssertionError("sample_parallel_chains' output is not finite "
                             "or has the wrong shape")
    print(f"sample_parallel_chains({N_BATCHES}, {BATCH}): accept rate "
          f"after round 1 {rates[1:].mean():.4f}; the first call, capture "
          f"included, profiled, {seconds:.2f} s on {card}")

    model.seed(32)
    got = mcmc.sample_parallel_chains(N_BATCHES, BATCH, collect_samples=True)
    model.seed(32)
    carry = [torch.zeros((BATCH, *LAT), device="cuda"),
             torch.full((BATCH,), math.inf, device="cuda"),
             torch.zeros(BATCH, device="cuda")]
    rows = [[t.clone() for t in (*carry, mcmc.parallel_body(
        BATCH, gen, carry)[0])] for _ in range(N_BATCHES)]
    want = [torch.stack([r[k] for r in rows]) for k in range(4)]
    same = same_bits(torch, (got["samples"], got["logq"], got["logp"]),
                     want[:3]) and np.array_equal(
        got["accept_rate"], want[3].cpu().numpy().mean(axis=1))
    print(f"sample_parallel_chains({N_BATCHES}, {BATCH}) graphed vs "
          f"{N_BATCHES} eager rounds from one generator state: samples, "
          f"logq, logp and accept rates "
          f"{'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("graphed parallel rounds differ from their "
                             "eager bodies")


def blocked_draws(model, batch, n_blocks, generator=None):
    """``blocked_mcmc.sample__``'s start and draws from ``generator`` (the
    model's by default), as it takes them: the prior's sample, then every
    proposal and log uniform, on the whole lattice."""
    from normflow__tpu_torch.parallel import space

    prior = model.prior
    gen = model.generator if generator is None else generator
    with space.active(None):
        x = prior.sample(1, gen)
        return (x, *model.blocked_mcmc._block_draws(
            prior.chopped(prior.nvar // n_blocks), batch, n_blocks, gen))


def run_blocked(torch, kernels, model):
    """``blocked_mcmc.sample__(4, n_blocks=K)`` on the flagship for K = 4
    and 16, each block proposal one flow forward on one sample.  For each
    K: the main path's run, its first call, which captures the start and
    the block step, profiled with the counters set to 0 just before and
    read just after (by profiler name the ``WARMUP`` eager bodies of each
    capture, the start's replay and one replay per proposal; by the
    wrappers the two warm-ups and captures); then a call from one
    generator state against the eager sweep on the same draws, bit for
    bit (samples, logq, logp, accepts); then, after ``reset()``, a warm
    call's launches by profiler name: n_layers ``rqs_coupling`` and one
    ``phi4_action`` per flow forward, no ``accept_scan``, no wrapper
    call.  Which variant each kernel takes at B = 1 is recorded by
    path."""
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.utils.graphs import WARMUP

    bm = model.blocked_mcmc
    per_fwd = {"rqs_coupling": len(model.net_[2].nets), "phi4_action": 1}
    counters = path_counters(("rqs_coupling", "phi4_action", "accept_scan"))
    batch = BLOCKED_BATCH
    for n_blocks in (4, 16):
        path = "blocked" if n_blocks == 4 else f"blocked_{n_blocks}"
        n = batch * n_blocks
        bm.reset()
        reset_counts(counters)
        device, (cfgs, logq, logp) = device_launches(
            lambda: bm.sample__(batch, n_blocks=n_blocks))
        torch.cuda.synchronize()
        wrapper = {k: c.launches for k, c in counters.items()}
        tiled = {}
        for k, c in counters.items():
            if hasattr(c, "tiled_launches") and c.launches:
                if c.tiled_launches not in (0, c.launches):
                    raise AssertionError(f"{path}: {k} took both variants")
                tiled[k] = c.tiled_launches == c.launches
        want = {k: (v * (2 * WARMUP + 1 + n),
                    v * (2 * WARMUP + 1 + n) if tiled[k] else 0)
                for k, v in per_fwd.items()}
        want_wrapper = {**{k: v * 2 * (WARMUP + 1)
                           for k, v in per_fwd.items()}, "accept_scan": 0}
        print(f"blocked_mcmc.sample__({batch}, n_blocks={n_blocks}), its "
              f"first call (two captures): launches by profiler name "
              f"(launches, tiled) {device}, want {want}; by the wrappers "
              f"{wrapper}, want {want_wrapper}; at B = 1 the tiled kernel "
              f"{tiled}; accept rate "
              f"{bm.history.accept_rate[-1]:.4f}")
        if cfgs.shape != (batch, *LAT) or not all(
                bool(torch.isfinite(t).all()) for t in (cfgs, logq, logp)):
            raise AssertionError("the blocked sampler's output is not "
                                 "finite or has the wrong shape")
        if device != want or wrapper != want_wrapper:
            raise AssertionError(f"{path}: the blocked sampler's launches "
                                 "are not one flow forward per proposal")
        for k, (launches, n_tiled) in device.items():
            kernels[k].setdefault("launches_by_path", {})[path] = launches
            kernels[k].setdefault("tiled_launches_by_path", {})[path] = \
                n_tiled

        seed = 33 + n_blocks
        bm.reset()
        model.seed(seed)
        got = bm.sample__(batch, n_blocks=n_blocks, bookkeeping=True)
        model.seed(seed)
        x, props, lrand = blocked_draws(model, batch, n_blocks)
        eager = bm.sweep(x, 0.0, False, props, lrand)
        same = same_bits(torch, got, eager[:3]) and np.array_equal(
            bm.history.accept_seq[-1], eager[3].cpu().numpy().ravel())
        print(f"blocked_mcmc.sample__({batch}, n_blocks={n_blocks}) "
              f"replayed vs the eager sweep on the same draws: samples, "
              f"logq, logp and accepts "
              f"{'bit for bit' if same else 'NOT bit-identical'}")
        if not same:
            raise AssertionError("the replayed block steps differ from the "
                                 "eager ones")

        def warm():
            bm.reset()
            return bm.sample__(batch, n_blocks=n_blocks)

        gate_replays(counters, kernels, path, per_fwd, 1 + n, warm,
                     tiled=tiled)


def exact_phi2(m_sq=-1.2, lambd=0.5):
    """<phi^2> of the zero-dim model by quadrature
    (``tests/test_mcmc.py:64-69``)."""
    phi = np.linspace(-6, 6, 20001)
    s = 0.5 * m_sq * phi ** 2 + lambd * phi ** 4
    w = np.exp(-s + s.min())
    return float((phi ** 2 * w).sum() / w.sum())


def run_exactness(torch, card):
    """The zero-dim model fitted on the card (300 steps, lr 0.01, batch
    256), then ``sample_chain(16, 1024)``, ``sample_parallel_chains(32,
    1024)`` (4 rounds of burn-in dropped) and ``blocked_mcmc.sample__(256)``:
    each <phi^2> within 5 sigma + 0.01 of the quadrature and each accept
    rate above its bar (``tests/test_mcmc.py``: 0.8, 0.85, 0.5)."""
    from normflow__tpu_torch import Model
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.models.elementwise import DistConvertor
    from normflow__tpu_torch.models.priors import NormalPrior

    model = Model(net_=DistConvertor(10, device="cuda"),
                  prior=NormalPrior(shape=(1,), device="cuda"),
                  action=ScalarPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5),
                  seed=11)
    model.fit(n_epochs=300, batch_size=256,
              hyperparam=dict(lr=0.01, weight_decay=0.0),
              checkpoint_dict=dict(print_stride=None))
    exact = exact_phi2()
    chain = model.mcmc.sample_chain(16, 1024, collect_samples=True)
    par = model.mcmc.sample_parallel_chains(32, 1024, collect_samples=True)
    y = model.blocked_mcmc.sample__(256)[0]
    ok = True
    for what, phi, tau, acc, bar in (
            ("sample_chain(16, 1024)", chain["samples"], 10,
             float(chain["accept_rate"].mean()), 0.8),
            ("sample_parallel_chains(32, 1024), rounds 4-31",
             par["samples"][4:], 5, float(par["accept_rate"][1:].mean()),
             0.85),
            ("blocked_mcmc.sample__(256)", y, 10,
             model.blocked_mcmc.history.accept_rate[-1], 0.5)):
        phi2 = phi.double().cpu().numpy().ravel() ** 2
        err = phi2.std() / np.sqrt(len(phi2) / tau)
        held = abs(phi2.mean() - exact) < 5 * err + 0.01 and acc > bar
        ok &= held
        print(f"zero-dim exactness, {what}: <phi^2> {phi2.mean():.5f} vs "
              f"quadrature {exact:.5f} (|d| {abs(phi2.mean() - exact):.5f},"
              f" bar 5 x {err:.5f} + 0.01), accept {acc:.4f} (> {bar}) "
              f"{'held' if held else 'FAILED'} on {card}")
    if not ok:
        raise AssertionError("a sampler missed the zero-dim exactness bars")


def vjp_excess(got, want, rtol):
    """How far ``got`` is from ``want`` (pairs of tensors), element by
    element: ``(worst, d, w, k, i)``, the largest ``|got - want| /
    (VJP_ATOL + rtol |want|)`` (at most 1 passes), ``|got - want|`` and
    ``|want|`` where it is reached, and that element's tensor (0: ``xbar``,
    1: ``outbar``) and flat index."""
    worst = (-1.0, 0.0, 0.0, 0, 0)
    for k, (g, w) in enumerate(zip(got, want)):
        d, a = (g - w).abs().flatten(), w.abs().flatten()
        ratio = d / (VJP_ATOL + rtol * a)
        i = int(ratio.argmax())
        if float(ratio[i]) > worst[0]:
            worst = (float(ratio[i]), float(d[i]), float(a[i]), k, i)
    return worst


def floored_excess(got, want, want64):
    """The largest ``|got - want| / max(VJP_ATOL + VJP_RTOL |want|,
    VJP_FLOOR_FACTOR |want - want64|)`` over the pairs of tensors,
    ``want64`` the float64 reference of ``want`` (at most 1 passes)."""
    return max(float(((g - w).abs() / (VJP_ATOL + VJP_RTOL * w.abs()).maximum(
        VJP_FLOOR_FACTOR * (w.double() - w64).abs().to(w.dtype))).max())
               for g, w, w64 in zip(got, want, want64))


def f64_excess(got, want):
    """The largest ``|got - want| / (F64_VJP_TOL (1 + |want|))`` over
    the pairs of tensors (at most 1 passes)."""
    return max(float(((g - w).abs() / (F64_VJP_TOL * (1 + w.abs()))).max())
               for g, w in zip(got, want))


def check_rqs_bwd(torch, kernels, peaks, rng):
    """rqs_coupling_bwd vs its plain version (the hand-derived VJP) at the
    training shape B=512, K3=22, S=32x16, element by element, and the
    plain VJP vs autograd through the plain forward, both in float64 on
    the same inputs.  Autograd of the float32 forward is printed beside
    them, and at the worst element a float64 run says which float32 side
    departs.  A planted wrong adjoint (the result plus 1% of each tensor's
    median |plain| on every element) must fail each gate.  Returns the
    function that times the kernel."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc

    m, b, lat = 8, TRAIN_BATCH, (LAT[0], LAT[1] // 2)
    out = torch.tensor(rng.standard_normal((b, 3 * m - 2, *lat)),
                       dtype=torch.float32, device="cuda")
    ybar, loggbar = (torch.tensor(rng.standard_normal((b, *lat)),
                                  dtype=torch.float32, device="cuda")
                     for _ in range(2))
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
            got = sc.rqs_coupling_bwd(x, out, ybar, loggbar, **kw)
            vjp = sc.rqs_coupling_vjp_plain(x, out, ybar, loggbar, **kw)
            xa, oa = x.clone().requires_grad_(), out.clone().requires_grad_()
            y, logg = sc.rqs_coupling_plain(xa, oa, **kw)
            auto = torch.autograd.grad(
                (y * ybar).sum() + (logg * loggbar).sum(), (xa, oa))
            ref = sc.rqs_coupling_vjp_plain(
                *(t.double() for t in (x, out, ybar, loggbar)), **kw)
            x64, o64 = (t.double().requires_grad_() for t in (x, out))
            y64, logg64 = sc.rqs_coupling_plain(x64, o64, **kw)
            auto64 = torch.autograd.grad(
                (y64 * ybar.double()).sum()
                + (logg64 * loggbar.double()).sum(), (x64, o64))
            medians = [float(w.abs().median()) for w in vjp]
            plant = tuple(g + 0.01 * med for g, med in zip(got, medians))
            f64 = f64_excess(ref, auto64)
            f64_plant = f64_excess(tuple(r + 0.01 * med for r, med in
                                         zip(ref, medians)), auto64)
            torch.cuda.synchronize()
            print(f"rqs_coupling_bwd extrap={extrap} inverse={inverse}: "
                  f"|plain| median {medians[0]:.3g} (xbar), "
                  f"{medians[1]:.3g} (outbar); max "
                  f"{max(float(w.abs().max()) for w in vjp):.4g}")
            excess = {}
            for what, cand, want, rtol in (
                    ("vs vjp_plain", got, vjp, VJP_RTOL),
                    ("vs autograd of plain (printed, not gated)", got, auto,
                     AUTOGRAD_RTOL),
                    ("planted wrong adjoint vs vjp_plain", plant, vjp,
                     VJP_RTOL)):
                e = vjp_excess(cand, want, rtol)
                # the whole-tensor bar, which alone a few steep sites set
                old = max(float((g - w).abs().max()) for g, w in
                          zip(cand, want)) / max(
                              1.0, *(float(w.abs().max()) for w in want))
                excess[what] = (e[0], old)
                k, i = e[3], e[4]
                # which float32 side departs from the float64 plain VJP there
                off = [abs(float(t[k].flatten()[i])
                           - float(ref[k].flatten()[i])) for t in (cand, want)]
                print(f"  {what}: worst |d|/(atol+{rtol:g}|plain|) "
                      f"{e[0]:.3e}, |d| {e[1]:.3e} where |plain| {e[2]:.4g} "
                      f"({('xbar', 'outbar')[k]}); there float64 puts the "
                      f"candidate {off[0]:.3e} off, the reference "
                      f"{off[1]:.3e}; max|d|/max(1,max|plain|) {old:.3e} "
                      f"(tol {VJP_ATOL})")
            print("  each float32 route vs the float64 plain VJP, worst "
                  "|d|/(atol+rtol|plain|) at rtol "
                  f"{VJP_RTOL:g} / {AUTOGRAD_RTOL:g}: " + ", ".join(
                      f"{what} {vjp_excess(t, ref, VJP_RTOL)[0]:.3e} / "
                      f"{vjp_excess(t, ref, AUTOGRAD_RTOL)[0]:.3e}"
                      for what, t in (("kernel", got), ("vjp_plain", vjp),
                                      ("autograd", auto))))
            print(f"  float64 vjp_plain vs float64 autograd of plain: worst "
                  f"|d|/({F64_VJP_TOL:g}(1+|autograd|)) {f64:.3e}; a planted "
                  f"wrong VJP {f64_plant:.3e} (must exceed 1)")
            ratio, old = excess["vs vjp_plain"]
            if not (all(bool(torch.isfinite(g).all()) for g in got)
                    and ratio <= 1.0 and old <= VJP_ATOL):
                raise AssertionError(
                    f"rqs_coupling_bwd disagrees with its plain version "
                    f"(atol {VJP_ATOL}, rtol {VJP_RTOL})")
            if not f64 <= 1.0:
                raise AssertionError(
                    "the plain VJP is not autograd's derivative in float64 "
                    f"(tol {F64_VJP_TOL})")
            if not (excess["planted wrong adjoint vs vjp_plain"][0] > 1.0
                    and f64_plant > 1.0):
                raise AssertionError("the check of rqs_coupling_bwd let a "
                                     "planted wrong adjoint pass")
            worst = max(worst, max(float((g - w).abs().max())
                                   for g, w in zip(got, vjp)))

    kernels["rqs_coupling_bwd"] = dict(
        name="rqs_coupling_bwd", route="cuda",
        source="normflow__tpu_torch/csrc/rqs_coupling_bwd.cu",
        replaces="normflow__tpu/ops/kernels/spline_coupling.py:133",
        max_abs_err=worst, library_ms=None)

    ptrs = [t.data_ptr() for t in (x, out, ybar, loggbar)]
    variant = sc.coupling_variant(math.prod(lat), ptrs)
    print(f"rqs_coupling_bwd at the training shape takes the {variant} "
          "kernel")
    if variant != "tiled":
        raise AssertionError("the training shape does not take the tiled "
                             "rqs_coupling_bwd kernel")

    def time_it():
        """Time both training-path variants, forward and inverse, with
        linear extrapolation; each is launched 4 times per step, so the
        record's times are their means.  Read cold."""
        times = {}
        for what, inverse in (("forward", False), ("inverse", True)):
            kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                      right="linear", inverse=inverse)
            times[what] = kernel_times(
                "rqs_coupling_bwd",
                lambda: sc.rqs_coupling_bwd(x, out, ybar, loggbar, **kw),
                lambda: sc.rqs_coupling_vjp_plain(x, out, ybar, loggbar,
                                                  **kw))
            print(f"rqs_coupling_bwd {what}: warm {times[what]['ms']:.5f} "
                  f"ms, cold {times[what]['ms_cold']:.5f} ms")
        t = {k: (times["forward"][k] + times["inverse"][k]) / 2
             for k in times["forward"]}
        report("rqs_coupling_bwd", t, tuple(out.shape), peaks, kernels,
               "cold")
        kernels["rqs_coupling_bwd"]["variants"] = times

    return time_it


def check_phi4_grad(torch, kernels, peaks, rng, action):
    """phi4_action_grad vs its plain version: the training shape
    (512, 32, 32), 1-D, 3-D, and the zero-dim fit's one site with w0 = 0;
    at the training shape its tiled kernel (the path's) vs the general
    kernel, bit for bit.  Returns the function that times it."""
    from normflow__tpu_torch.ops.kernels import phi4

    worst = 0.0
    zerodim = action.__class__(kappa=0, m_sq=-1.2, lambd=0.5)
    for shape, act in (((TRAIN_BATCH, *LAT), action), ((BATCH, 64), action),
                       ((64, 8, 8, 8), action), ((128, 1), zerodim)):
        cfgs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")
        g = torch.tensor(rng.standard_normal(shape[0]), dtype=torch.float32,
                         device="cuda")
        w = act.get_coef(len(shape) - 1)
        variant = phi4.action_variant(shape[1:], cfgs.data_ptr())
        got = phi4.phi4_action_grad(cfgs, g, *w)
        want = phi4.phi4_action_grad_plain(cfgs, g, *w)
        general = phi4.phi4_action_grad(offset_copy(torch, cfgs), g, *w)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        ok = bool((diff <= FORCE_ATOL + FORCE_RTOL * want.abs()).all())
        same = same_bits(torch, (got,), (general,))
        print(f"phi4_action_grad {shape} w0={w[0]}, {variant} kernel: max "
              f"abs {float(diff.max()):.3e} (rtol {FORCE_RTOL}, atol "
              f"{FORCE_ATOL}) {'ok' if ok else 'FAILED'}; vs the general "
              f"kernel {'bit for bit' if same else 'NOT bit-identical'}")
        if not (ok and same):
            raise AssertionError("phi4_action_grad disagrees with its plain "
                                 "version or its general kernel")
        worst = max(worst, float(diff.max()))

    kernels["phi4_action_grad"] = dict(
        name="phi4_action_grad", route="cuda",
        source="normflow__tpu_torch/csrc/phi4_action.cu",
        replaces="normflow__tpu/ops/kernels/phi4.py:49",
        max_abs_err=worst, library_ms=None)
    cfgs = torch.tensor(rng.standard_normal((TRAIN_BATCH, *LAT)),
                        dtype=torch.float32, device="cuda")
    g = torch.tensor(rng.standard_normal(TRAIN_BATCH), dtype=torch.float32,
                     device="cuda")
    w = action.get_coef(2)
    if phi4.action_variant(LAT, cfgs.data_ptr()) != "tiled":
        raise AssertionError("the training shape does not take the tiled "
                             "phi4_action_grad kernel")

    def time_it():
        """Time the training shape, (512, 32, 32); read warm."""
        t = kernel_times("phi4_action_grad",
                         lambda: phi4.phi4_action_grad(cfgs, g, *w),
                         lambda: phi4.phi4_action_grad_plain(cfgs, g, *w))
        report("phi4_action_grad", t, tuple(cfgs.shape), peaks, kernels,
               "warm")

    return time_it


def _counters():
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc

    return {"rqs_coupling": sc.rqs_coupling,
            "rqs_coupling_bwd": sc.rqs_coupling_bwd,
            "phi4_action": phi4.phi4_action,
            "phi4_action_grad": phi4.phi4_action_grad}


def reset_counts(counters):
    """Set every launch count of ``counters`` to 0, the tiled kernels'
    shares too."""
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "tiled_launches"):
            c.tiled_launches = 0


def check_tiled(counters, path, tiled=True):
    """Raise unless every wrapper launch on ``path`` of a kernel with a
    tiled variant went to the tiled kernel, whose times the record
    reports; with ``tiled=False`` (a lattice with no tile), unless none
    did; ``tiled`` may also map each kernel to its flag."""
    for name, c in counters.items():
        if not hasattr(c, "tiled_launches"):
            continue
        want = c.launches if (tiled[name] if isinstance(tiled, dict)
                              else tiled) else 0
        print(f"{name} over the {path} path: {c.tiled_launches} of "
              f"{c.launches} wrapper launches to the tiled kernel (want "
              f"{want})")
        if c.tiled_launches != want:
            raise AssertionError(f"{name}: {c.tiled_launches} of "
                                 f"{c.launches} launches on the {path} path "
                                 f"to the tiled kernel, want {want}")


def pool_reserved(torch, before=None):
    """The card's reserved memory after emptying PyTorch's cache, in MiB,
    or its growth since ``before``: what the graphs' private pools hold.
    Graphs of models no longer referenced are collected first."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mib = torch.cuda.memory_reserved() / 2 ** 20
    return mib if before is None else round(mib - before, 1)


def tiled_want(counter, n, tiled=True):
    """``(launches, tiled launches)`` wanted of a kernel launched ``n``
    times: every launch tiled where the kernel has a tiled variant (its
    wrapper counts ``tiled_launches``) and the path's lattice a tile
    (``tiled``), none otherwise."""
    return n, n if tiled and hasattr(counter, "tiled_launches") else 0


def gate_path(counters, kernels, path, per_unit, n_units, device,
              tiled=True, nd=False):
    """The main path's run on ``path``: ``n_units`` batches or steps, the
    first of which captures the graph.  ``device`` holds the run's
    launches by profiler name, ``(launches, tiled)`` per kernel: the
    ``WARMUP`` eager bodies before the capture and the ``n_units`` replays
    launch ``per_unit`` each, every one to the tiled kernel where there is
    one (:func:`tiled_want`; the capture itself launches nothing); these
    are the record's
    ``launches_by_path``.  Each wrapper must have run ``per_unit`` times
    for each warm-up body and for the capture, every launch tiled (none
    with ``tiled=False``; ``tiled`` may also map each kernel to its
    flag).  ``nd``: a 3-D or 4-D lattice's run, whose phi4 launches are the
    tiled nd kernels' too (:func:`record_nd`)."""
    from normflow__tpu_torch.utils.graphs import WARMUP

    want = {k: tiled_want(counters[k], v * (WARMUP + n_units), tiled[k]
                          if isinstance(tiled, dict) else tiled)
            for k, v in per_unit.items()}
    print(f"launches over the {path} path's run by profiler name "
          f"(launches, tiled): {device}, want {want}")
    if device != want:
        raise AssertionError(f"{path}: launches on the card {device}, want "
                             f"{want}")
    wrapper = {k: c.launches for k, c in counters.items()}
    want = {k: v * (WARMUP + 1) for k, v in per_unit.items()}
    print(f"  by the wrappers: {wrapper} (warm-up and capture; want "
          f"{want})")
    if wrapper != want:
        raise AssertionError(f"{path}: wrapper launch counts {wrapper}, "
                             f"want {want}")
    check_tiled(counters, path, tiled)
    for k, (n, tiled) in device.items():
        kernels[k].setdefault("launches_by_path", {})[path] = n
        kernels[k].setdefault("tiled_launches_by_path", {})[path] = tiled
    if nd:
        record_nd(kernels, path, device)


def gate_replays(counters, kernels, path, per_unit, n_units, fn,
                 tiled=True, nd=False):
    """``fn()`` replays ``n_units`` batches, steps or rounds: the
    profiler's launches by kernel name must be exactly ``per_unit`` per
    unit, every one tiled where there is a tiled kernel (none with
    ``tiled=False``; ``tiled`` may also map each kernel to its flag), and
    no wrapper may run; ``nd`` as for :func:`gate_path`."""
    from normflow__tpu_torch.tools.kernel_times import device_launches

    want = {k: tiled_want(counters[k], v * n_units, tiled[k] if isinstance(
        tiled, dict) else tiled) for k, v in per_unit.items()}
    before = {k: c.launches for k, c in counters.items()}
    device = device_launches(fn)[0]
    print(f"launches of {n_units} replays on the {path} path by profiler "
          f"name (launches, tiled): {device}, want {want}")
    if device != want or before != {k: c.launches
                                    for k, c in counters.items()}:
        raise AssertionError(f"{path}: replayed launches {device}, want "
                             f"{want}, all tiled, and no wrapper call")
    for k, v in per_unit.items():
        kernels[k].setdefault("replay_launches_per_unit", {})[path] = v
    if nd:
        record_nd(kernels, path, per_unit, "replay_launches_per_unit")


def check_train_grads(torch, model, rng, packed=True, backend="xla",
                      floor=False, lat=LAT, batch=TRAIN_BATCH):
    """The full-width path-gradient loss and its gradients on one numpy
    draw at batch ``batch`` (512) on the lattice ``lat``: the card
    (float32, TF32 off) against a float64 CPU copy, with a float32 CPU
    copy beside them to show the float32 floor, which sets the per-leaf
    bars (``FLOOR_FACTOR``) of the unpacked flagship and, with ``floor``,
    of a packed one on a fresh draw, where a planted wrong step (every
    leaf's gradient times 1.05) must exceed every leaf's bar; the copies'
    couplings on ``model``'s route ``backend``."""
    from normflow__tpu_torch.zoo import build_phi4_model

    x = rng.standard_normal((batch, *lat))
    res = {}
    for key, dtype in (("gpu", torch.float32), ("cpu", torch.float32),
                       ("cpu64", torch.float64)):
        m = model
        if key != "gpu":
            m = build_phi4_model(lat, seed=0, device="cpu", dtype=dtype,
                                 packed=packed, coupling_backend=backend)
            m.net_.load_state_dict({k: v.to(dtype) for k, v in
                                    model.net_.state_dict().items()})
        m.fit.grad_estimator = "path"
        xd = torch.tensor(x, dtype=dtype, device=m.device)
        loss, _, _ = m.fit.loss_of(xd, m.prior.log_prob(xd))
        grads = torch.autograd.grad(loss, list(m.net_.parameters()))
        res[key] = (float(loss.detach()),
                    [g.detach().cpu().double() for g in grads])

    def rel(a, b):
        loss = abs(res[a][0] - res[b][0]) / max(1.0, abs(res[b][0]))
        return loss, [float((p - q).norm()) / max(float(q.norm()), 1e-30)
                      for p, q in zip(res[a][1], res[b][1])]

    what = ("packed" if packed else "unpacked") + (
        "" if backend == "xla" else f" {backend}")
    for a, b in (("gpu", "cpu"), ("gpu", "cpu64"), ("cpu", "cpu64")):
        loss, leaves = rel(a, b)
        print(f"{what} path-gradient step, batch {batch}, {a} vs {b}: "
              f"loss rel {loss:.3e}; |dg|/|g| per leaf max {max(leaves):.3e},"
              f" median {statistics.median(leaves):.3e}")
    loss, leaves = rel("gpu", "cpu64")
    bars = [TRAIN_GRAD_TOL] * len(leaves)
    floored = floor or not packed
    if floored:
        bars = [max(TRAIN_GRAD_TOL, FLOOR_FACTOR * f)
                for f in rel("cpu", "cpu64")[1]]
    print(f"  loss " + ", ".join(f"{k} {v[0]:.6f}" for k, v in res.items())
          + "; gpu vs cpu64 per leaf: " + " ".join(f"{r:.1e}" for r in leaves)
          + ("; bars " + " ".join(f"{b:.1e}" for b in bars) if floored
             else ""))
    if not (loss <= TRAIN_LOSS_TOL
            and all(r <= b for r, b in zip(leaves, bars))):
        raise AssertionError(f"GPU and CPU training steps disagree (tol "
                             f"{TRAIN_LOSS_TOL} / per-leaf bars above)")
    if floor:
        planted = [float((1.05 * p - q).norm()) / max(float(q.norm()), 1e-30)
                   for p, q in zip(res["gpu"][1], res["cpu64"][1])]
        print(f"  a planted wrong step (every gradient x 1.05) vs cpu64 per "
              f"leaf: min excess over its bar "
              f"{min(r / b for r, b in zip(planted, bars)):.3e} (must exceed "
              f"1)")
        if not all(r > b for r, b in zip(planted, bars)):
            raise AssertionError("the per-leaf bars let a planted wrong "
                                 "step pass")


def fit_protocol(model, n_epochs, lr=3e-3, decay_steps=N_STEPS,
                 batch=TRAIN_BATCH):
    """``model.fit`` for ``n_epochs`` steps with the bench protocol's
    settings (``bench.py:278-286``), the cosine decay over ``decay_steps``
    (``N_STEPS``), at the learning rate ``lr`` (the protocol's 3e-3; the
    4-D flagship's ``LAT4_LR``) and the global batch ``batch`` (the
    protocol's 512); returns the fit's history."""
    from normflow__tpu_torch import cosine_decay_schedule

    return model.fit(n_epochs=n_epochs, batch_size=batch,
                     hyperparam=dict(lr=lr, weight_decay=1e-4),
                     scheduler=cosine_decay_schedule(
                         1.0, decay_steps=decay_steps, alpha=0.05),
                     grad_estimator="path", clip_grad_norm=25.0,
                     steps_per_call=8, checkpoint_dict=dict(print_stride=None))


def run_training_path(torch, kernels, card):
    """``model.fit`` on a fresh seeded full-width flagship with the bench
    protocol's settings, profiled: its launches counted by the profiler
    and by the wrappers."""
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.zoo import build_phi4_model

    model = build_phi4_model(LAT, seed=0)
    counters = _counters()
    n_layers = len(model.net_[2].nets)
    per_step = {"rqs_coupling": 2 * n_layers, "rqs_coupling_bwd": 2 * n_layers,
                "phi4_action": 1, "phi4_action_grad": 1}
    reserved = pool_reserved(torch)
    reset_counts(counters)
    t0 = time.perf_counter()
    device, hist = device_launches(lambda: fit_protocol(model, N_STEPS))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "train", per_step, N_STEPS, device)
    print(f"the training step's graph holds "
          f"{pool_reserved(torch, reserved)} MiB of device memory (batch "
          f"{TRAIN_BATCH}) on {card}")

    loss = np.asarray(hist["loss"])
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    print(f"model.fit: {N_STEPS} steps in {seconds:.2f} s (capture "
          f"included, profiled); loss {loss[0]:.3f} -> {loss[-1]:.3f}, mean "
          f"of the first 10 {first:.3f}, of the last 10 {last:.3f}")
    if loss.shape != (N_STEPS,) or not np.isfinite(loss).all() \
            or not last < first:
        raise AssertionError("training loss not finite or not falling")
    return model


def run_zerodim(torch):
    """The zero-dim fit (examples/scalar_zerodim.py) on the card, from the
    port's modules: its action is one site with w0 = 0."""
    from normflow__tpu_torch import Model
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.models.elementwise import DistConvertor
    from normflow__tpu_torch.models.priors import NormalPrior

    model = Model(net_=DistConvertor(10, device="cuda"),
                  prior=NormalPrior(shape=(1,), device="cuda"),
                  action=ScalarPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5),
                  seed=5)
    from normflow__tpu_torch.utils.graphs import WARMUP

    grad = _counters()["phi4_action_grad"]
    reset_counts({"phi4_action_grad": grad})
    t0 = time.perf_counter()
    hist = model.fit(n_epochs=500, batch_size=128,
                     hyperparam=dict(lr=0.01, weight_decay=0.0),
                     checkpoint_dict=dict(print_stride=250))
    seconds = time.perf_counter() - t0
    acc, ess = hist["accept_rate"][-1][0], hist["ess"][-1]
    print(f"zero-dim fit, 500 epochs in {seconds:.2f} s: loss "
          f"{hist['loss'][-1]:.4f} (<= -1.0), accept {acc:.4f} (>= 0.9), ESS "
          f"{ess:.4f} (>= 0.95); phi4_action_grad wrapper launches "
          f"{grad.launches} (warm-up and capture), {grad.tiled_launches} of "
          "them tiled (the one-site lattice takes the general kernel)")
    if not (hist["loss"][-1] <= -1.0 and acc >= 0.9 and ess >= 0.95
            and grad.launches == WARMUP + 1 and grad.tiled_launches == 0):
        raise AssertionError("the zero-dim fit missed its targets or its "
                             "launch counts")
    return model


def replay_vs_eager(torch, model, trained):
    """The graphs against their eager bodies at full width: three replayed
    sampled batches against three eager bodies from the same generator
    state (bit for bit), and 10 replayed training steps against 10 eager
    bodies from the same parameters, optimizer state and generator state
    (losses and parameters; bit for bit where cuDNN's default algorithms
    sum alike, else within the stated tolerance)."""
    post, gen = model.posterior, model.generator
    model.seed(21)
    got = post.logqp_stream(3, BATCH)
    model.seed(21)
    want = torch.cat([post.logqp_batch(BATCH, gen) for _ in range(3)])
    same = same_bits(torch, (got,), (want,))
    print(f"replayed vs eager batch, 3 x {BATCH}: "
          f"{'bit for bit' if same else 'NOT bit-identical'}, max |d| "
          f"{float((got - want).abs().max()):.3e}")
    if not same:
        raise AssertionError("a replayed batch differs from its eager body")
    replayed_vs_eager_steps(torch, trained)


def replayed_vs_eager_steps(torch, trained, what="", deterministic=False,
                            n=10, captured=False):
    """``n`` (10) replayed training steps against ``n`` eager bodies from
    the same parameters, optimizer state and generator state, and ``n``
    eager bodies against ``n`` more: losses and parameters within the
    stated tolerances.  With ``deterministic``, cuDNN's deterministic
    algorithms for a new capture and its eager bodies, and the steps must
    agree bit for bit.  With ``captured``, the step was captured under
    those algorithms, which the caller keeps set: no new capture and no
    second eager run, and the bits must agree."""
    from normflow__tpu_torch.training import optim

    fit = trained.fit
    live = fit.params + optim.state_leaves(fit.opt_state)
    start = ([t.detach().clone() for t in live],
             trained.generator.get_state())
    flag = torch.backends.cudnn.deterministic

    def run(step):
        with torch.no_grad():
            for t, v in zip(live, start[0]):
                t.copy_(v)
        trained.generator.set_state(start[1])
        losses = torch.stack([step()[0] for _ in range(n)])
        return losses, [p.detach().clone() for p in fit.params]

    recapture = deterministic and not captured
    if recapture:
        torch.backends.cudnn.deterministic = True
        fit._graphs.clear()  # the next step captures with these algorithms
    try:
        runs = {"replayed": run(fit.step), "eager": run(fit.train_body)}
        if not captured:
            runs["eager again"] = run(fit.train_body)
    finally:
        if recapture:
            torch.backends.cudnn.deterministic = flag
            fit._graphs.clear()
    torch.cuda.synchronize()
    deterministic = deterministic or captured
    for a, b in (("replayed", "eager"), ("eager again", "eager"))[
            :len(runs) - 1]:
        (la, pa), (lb, pb) = runs[a], runs[b]
        same = same_bits(torch, (la, *pa), (lb, *pb))
        dloss = float(((la - lb).abs() / lb.abs().clamp(min=1.0)).max())
        dpar = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        print(f"{what}{n} {a} vs {n} eager training steps at batch "
              f"{fit.train_batch_size}{', cuDNN deterministic' if deterministic else ''}"
              f": {'bit for bit' if same else 'NOT bit-identical'}; losses "
              f"max rel {dloss:.3e} (tol {REPLAY_LOSS_TOL}), parameters max "
              f"|d| {dpar:.3e} (tol {REPLAY_PARAM_TOL})")
        if not (dloss <= REPLAY_LOSS_TOL and dpar <= REPLAY_PARAM_TOL
                and (same or not deterministic)):
            raise AssertionError(f"{what}{a} training steps differ from "
                                 "the eager bodies")


def run_resume(torch, card):
    """The protocol resumed on the card: ``tools/protocol_run`` trains
    ``RESUME_STEPS`` steps of the full-width flagship with the bench's
    settings (the cosine over ``2 x RESUME_STEPS``) in one fresh ``Model``
    and the next ``RESUME_STEPS`` in another from the snapshot the first
    left, against ``2 x RESUME_STEPS`` unbroken steps of the bench's
    training half; under cuDNN's deterministic algorithms, with the
    wrapper counts set to 0 just before and read just after (each of the
    three fits captures its step, each piece its ESS batch).  The losses,
    parameters and optimizer state within phase 7's tolerances (bits
    reported), the generator state equal."""
    import tempfile

    from normflow__tpu_torch import bench
    from normflow__tpu_torch.tools import protocol_run
    from normflow__tpu_torch.training import optim
    from normflow__tpu_torch.utils.graphs import WARMUP

    total = 2 * RESUME_STEPS
    args = bench.parse_args(["--train_epochs", str(total),
                             "--steps_per_call", "8"])
    counters = _counters()
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_counts(counters)
        t0 = time.perf_counter()
        unbroken, _ = bench.train(args)
        with tempfile.TemporaryDirectory() as d:
            pieces = [protocol_run.train(d, args, total=total,
                                         max_steps=RESUME_STEPS,
                                         save_every=RESUME_STEPS)
                      for _ in range(2)]
            traj = protocol_run.read_trajectory(d)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = flag
    model = pieces[1][0]
    n_layers = len(model.net_[2].nets)
    per_step = {"rqs_coupling": 2 * n_layers,
                "rqs_coupling_bwd": 2 * n_layers, "phi4_action": 1,
                "phi4_action_grad": 1}
    per_batch = {"rqs_coupling": n_layers, "phi4_action": 1}
    want = {k: (WARMUP + 1) * (3 * v + 2 * per_batch.get(k, 0))
            for k, v in per_step.items()}
    wrapper = {k: c.launches for k, c in counters.items()}
    got = torch.tensor(sum((m.fit.train_history["loss"] for m, _ in pieces),
                           []), dtype=torch.float64)
    ref = torch.tensor(unbroken.fit.train_history["loss"],
                       dtype=torch.float64)
    live = [(a.detach(), b.detach()) for a, b in zip(
        model.fit.params + optim.state_leaves(model.fit.opt_state),
        unbroken.fit.params + optim.state_leaves(unbroken.fit.opt_state))]
    same = all(torch.equal(a, b) for a, b in live) and torch.equal(got, ref)
    dloss = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    dpar = max(float((a - b).abs().max()) for a, b in live)
    gen_same = torch.equal(model.generator.get_state(),
                           unbroken.generator.get_state())
    print(f"protocol resumed, {RESUME_STEPS} + {RESUME_STEPS} steps in two "
          f"fresh Models vs {total} unbroken, batch {TRAIN_BATCH}, cuDNN "
          f"deterministic: {'bit for bit' if same else 'NOT bit-identical'};"
          f" losses max rel {dloss:.3e} (tol {REPLAY_LOSS_TOL}), parameters "
          f"and optimizer state max |d| {dpar:.3e} (tol {REPLAY_PARAM_TOL}),"
          f" generator state {'equal' if gen_same else 'DIFFERS'}; wrapper "
          f"launches {wrapper}, want {want}; trajectory "
          f"{[(r['step'], round(r['ess'], 5), r['steps_per_s']) for r in traj]}"
          f" (step, ESS, steps/s); {seconds:.1f} s on {card}")
    if not (len(got) == total and dloss <= REPLAY_LOSS_TOL
            and dpar <= REPLAY_PARAM_TOL and gen_same and wrapper == want
            and [r["step"] for r in traj] == [RESUME_STEPS, total]):
        raise AssertionError("the resumed protocol differs from the "
                             "unbroken run")


def record_variant(name, what, t, shape, peaks, kernels):
    """Keep the times ``t`` of kernel ``name`` at another path's ``shape``
    under ``variants[what]``, with that shape's bound."""
    from normflow__tpu_torch.tools.kernel_times import bound_ms, work

    nbytes, nops = work(name, shape)
    bms, by = bound_ms(nbytes, nops, peaks)
    kernels[name].setdefault("variants", {})[what] = dict(
        t, shape=list(shape), bound_ms=bms, bound_by=by)
    print(f"{name} {what} at {shape}: warm {t['ms']:.5f} ms "
          f"({bms / t['ms']:.3f} of bound), cold {t['ms_cold']:.5f} ms "
          f"({bms / t['ms_cold']:.3f}); plain {t['plain_ms']:.5f} ms; bound "
          f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB)")


COUPLING_AT_SEED = 20261018  # check_coupling_at's numpy stream at S = 1024


def check_coupling_at(torch, kernels, peaks, lat, seed):
    """rqs_coupling at ``lat`` sites per sample (forward and inverse, at
    the sampling batch 1024 and the training batch 512) and
    rqs_coupling_bwd (B = 512, forward and inverse) against their plain
    versions, with linear tails and the packed shapes' tolerances, every
    launch on the tiled kernel; a planted wrong adjoint must fail.  Its
    inputs come from a numpy generator of its own (``seed``), which leaves
    the other phases' draws as they were.  Returns the function that times
    them, under ``variants`` named by ``S=<sites>``."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc

    rng = np.random.default_rng(seed)
    tag = f"S={math.prod(lat)}"
    kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
              right="linear")

    def f32(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    x, out = f32((BATCH, *lat)), f32((BATCH, 22, *lat))
    counters = {k: c for k, c in _counters().items()
                if k in ("rqs_coupling", "rqs_coupling_bwd")}
    reset_counts(counters)
    worst = 0.0
    for b in (BATCH, TRAIN_BATCH):
        for inverse in (False, True):
            y, g = sc.rqs_coupling(x[:b], out[:b], inverse=inverse, **kw)
            yp, gp = sc.rqs_coupling_plain(x[:b], out[:b], inverse=inverse,
                                           **kw)
            dy = float((y - yp).abs().max())
            dg = float((g - gp).abs().max())
            print(f"rqs_coupling {tag}, B = {b}, inverse={inverse}: "
                  f"max|dy| {dy:.3e}  max|dlogg| {dg:.3e}  (tol {RQS_TOL})")
            if not (dy <= RQS_TOL and dg <= RQS_TOL):
                raise AssertionError("rqs_coupling disagrees with its plain "
                                     f"version at {tag}")
            worst = max(worst, dy, dg)
    kernels["rqs_coupling"]["max_abs_err"] = max(
        kernels["rqs_coupling"]["max_abs_err"], worst)

    xb, ob = x[:TRAIN_BATCH], out[:TRAIN_BATCH]
    ybar, loggbar = f32((TRAIN_BATCH, *lat)), f32((TRAIN_BATCH, *lat))
    worst = 0.0
    for inverse in (False, True):
        got = sc.rqs_coupling_bwd(xb, ob, ybar, loggbar, inverse=inverse,
                                  **kw)
        vjp = sc.rqs_coupling_vjp_plain(xb, ob, ybar, loggbar,
                                        inverse=inverse, **kw)
        medians = [float(w.abs().median()) for w in vjp]
        plant = tuple(g + 0.01 * med for g, med in zip(got, medians))
        e = vjp_excess(got, vjp, VJP_RTOL)
        planted = vjp_excess(plant, vjp, VJP_RTOL)[0]
        print(f"rqs_coupling_bwd {tag}, B = {TRAIN_BATCH}, inverse="
              f"{inverse}: worst |d|/(atol+{VJP_RTOL:g}|plain|) {e[0]:.3e} "
              f"(|d| {e[1]:.3e} where |plain| {e[2]:.4g}); a planted wrong "
              f"adjoint {planted:.3e} (must exceed 1)")
        if not (e[0] <= 1.0 and all(bool(torch.isfinite(g).all())
                                    for g in got)):
            raise AssertionError("rqs_coupling_bwd disagrees with its plain "
                                 f"version at {tag}")
        if not planted > 1.0:
            raise AssertionError(f"the {tag} check of rqs_coupling_bwd let "
                                 "a planted wrong adjoint pass")
        worst = max(worst, max(float((g - w).abs().max())
                               for g, w in zip(got, vjp)))
    kernels["rqs_coupling_bwd"]["max_abs_err"] = max(
        kernels["rqs_coupling_bwd"]["max_abs_err"], worst)
    check_tiled(counters, f"{tag} checks")

    def time_it():
        """Both kernels at ``lat``: the coupling forward and inverse at
        B = 1024 and 512, the VJP forward and inverse at B = 512."""
        for what, b, inverse in ((f"forward {tag}", BATCH, False),
                                 (f"inverse {tag}", BATCH, True),
                                 (f"forward {tag} B=512", TRAIN_BATCH, False),
                                 (f"inverse {tag} B=512", TRAIN_BATCH, True)):
            xs, os_ = x[:b], out[:b]
            t = kernel_times(
                "rqs_coupling",
                lambda: sc.rqs_coupling(xs, os_, inverse=inverse, **kw),
                lambda: sc.rqs_coupling_plain(xs, os_, inverse=inverse,
                                              **kw), plain_reps=5)
            record_variant("rqs_coupling", what, t, tuple(os_.shape), peaks,
                           kernels)
        for what, inverse in ((f"forward {tag}", False),
                              (f"inverse {tag}", True)):
            t = kernel_times(
                "rqs_coupling_bwd",
                lambda: sc.rqs_coupling_bwd(xb, ob, ybar, loggbar,
                                            inverse=inverse, **kw),
                lambda: sc.rqs_coupling_vjp_plain(xb, ob, ybar, loggbar,
                                                  inverse=inverse, **kw),
                plain_reps=5)
            record_variant("rqs_coupling_bwd", what, t, tuple(ob.shape),
                           peaks, kernels)

    return time_it


def run_unpacked_sampling(torch, kernels, rng, card):
    """The unpacked 32x32 flagship (``build_phi4_model(packed=False)``,
    ``EvenOddMask``: ConvNet 1->24->24->22 on all 1024 sites) with seeded
    perturbed weights: logq on the card against a float64 CPU copy, then
    ``logqp_stream(32, 1024)`` profiled, the counters set to 0 just before;
    one replayed batch against its eager body, bit for bit; one replayed
    batch's launches by profiler name; where a replayed batch's device
    time goes."""
    from normflow__tpu_torch import calc_ess
    from normflow__tpu_torch.tools.kernel_times import (device_launches,
                                                         perturb_)
    from normflow__tpu_torch.zoo import build_phi4_model

    model = build_phi4_model(LAT, packed=False, seed=0)
    perturb_(model.net_, rng)
    n_par = sum(p.numel() for p in model.net_.parameters())
    print(f"unpacked flagship {LAT}: {n_par} parameters on {model.device}")
    cpu = build_phi4_model(LAT, packed=False, seed=0, device="cpu",
                           dtype=torch.float64)
    cpu.net_.load_state_dict({k: v.double().cpu() for k, v in
                              model.net_.state_dict().items()})
    x = rng.standard_normal((256, *LAT))
    with torch.no_grad():
        logq = []
        for m, dtype in ((model, torch.float32), (cpu, torch.float64)):
            xd = torch.tensor(x, dtype=dtype, device=m.device)
            logq.append((m.prior.log_prob(xd) - m.net_.forward(xd)[1])
                        .double().cpu())
    rel = float(((logq[0] - logq[1]).abs()
                 / logq[1].abs().clamp(min=1.0)).max())
    print(f"unpacked GPU vs float64 CPU forward, 256 draws: max rel logq "
          f"{rel:.3e} (tol {LOGQ_REL_TOL})")
    if not rel <= LOGQ_REL_TOL:
        raise AssertionError("GPU and CPU unpacked flagship disagree")

    counters = {k: c for k, c in _counters().items()
                if k in ("rqs_coupling", "phi4_action")}
    per_batch = {"rqs_coupling": len(model.net_[2].nets), "phi4_action": 1}
    reset_counts(counters)
    t0 = time.perf_counter()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(N_BATCHES, BATCH))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "unpacked sample", per_batch, N_BATCHES,
              device)
    if logqp.shape != (N_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("the unpacked logqp stream is not finite or has "
                             "the wrong shape")
    print(f"unpacked logqp_stream({N_BATCHES}, {BATCH}): ESS "
          f"{float(calc_ess(logqp)):.5f} (random perturbed weights); the "
          f"first call, capture included, profiled, {seconds:.2f} s on "
          f"{card}")

    post, gen = model.posterior, model.generator
    model.seed(21)
    got = post.logqp_stream(1, BATCH)
    model.seed(21)
    want = post.logqp_batch(BATCH, gen)
    same = same_bits(torch, (got,), (want,))
    print(f"unpacked replayed vs eager batch of {BATCH}: "
          f"{'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("an unpacked replayed batch differs from its "
                             "eager body")
    gate_replays(counters, kernels, "unpacked sample", per_batch, 1,
                 lambda: post.logqp_stream(1, BATCH))
    profile_step(lambda: post.logqp_stream(1, BATCH),
                 f"one replayed unpacked sampled batch of {BATCH}")
    return model


def run_unpacked_training(torch, kernels, model, rng, card):
    """One full-width unpacked path-gradient step against a float64 CPU
    copy; ``model.fit`` with the bench protocol's settings for
    ``UNPACKED_STEPS`` steps on a fresh seeded unpacked flagship,
    profiled, the counters set to 0 just before; two replayed steps'
    launches by profiler name; where a replayed step's device time goes;
    10 replayed steps against 10 eager bodies, bit for bit, with cuDNN's
    deterministic algorithms."""
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.zoo import build_phi4_model

    check_train_grads(torch, model, rng, packed=False)
    trained = build_phi4_model(LAT, packed=False, seed=0)
    counters = _counters()
    n_layers = len(trained.net_[2].nets)
    per_step = {"rqs_coupling": 2 * n_layers, "rqs_coupling_bwd": 2 * n_layers,
                "phi4_action": 1, "phi4_action_grad": 1}
    reset_counts(counters)
    t0 = time.perf_counter()
    device, hist = device_launches(lambda: fit_protocol(trained,
                                                        UNPACKED_STEPS))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "unpacked train", per_step, UNPACKED_STEPS,
              device)
    loss = np.asarray(hist["loss"])
    print(f"unpacked model.fit: {UNPACKED_STEPS} steps in {seconds:.2f} s "
          f"(capture included, profiled) on {card}; loss {loss[0]:.3f} -> "
          f"{loss[-1]:.3f}")
    if loss.shape != (UNPACKED_STEPS,) or not np.isfinite(loss).all():
        raise AssertionError("the unpacked training loss is not finite")
    gate_replays(counters, kernels, "unpacked train", per_step, 2,
                 lambda: [trained.fit.step() for _ in range(2)])
    profile_step(trained.fit.step, f"one replayed unpacked training step at "
                 f"batch {TRAIN_BATCH}")
    # cuDNN's default weight-gradient algorithms sum in another order on
    # every run, which at twice the packed sites reaches the parameter
    # tolerance after 10 steps (1.05e-5 in one run on an H100 80GB HBM3):
    # this comparison takes cuDNN's deterministic algorithms and asks for
    # the bits
    replayed_vs_eager_steps(torch, trained, "unpacked: ", deterministic=True)


def check_phi4_general(torch, kernels, peaks):
    """phi4_action and phi4_action_grad at the affine example's shape
    (128, 8, 8), which has no tile (16 float4 groups are not a whole
    warp): the general kernels against their plain versions with the
    flagship's tolerances, on a numpy generator of its own.  Returns the
    function that times them."""
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.ops.kernels import phi4

    rng = np.random.default_rng(20261019)
    lat = (8, 8)
    if phi4.action_plan(lat) is not None:
        raise AssertionError("8x8 was expected to have no tile")
    cfgs = torch.tensor(rng.standard_normal((AFFINE_BATCH, *lat)),
                        dtype=torch.float32, device="cuda")
    g = torch.tensor(rng.standard_normal(AFFINE_BATCH), dtype=torch.float32,
                     device="cuda")
    w = ScalarPhi4Action(**AFFINE_ACTION).get_coef(2)
    counters = {k: c for k, c in _counters().items()
                if k in ("phi4_action", "phi4_action_grad")}
    reset_counts(counters)
    got, want = phi4.phi4_action(cfgs, *w), phi4.phi4_action_plain(cfgs, *w)
    fgot = phi4.phi4_action_grad(cfgs, g, *w)
    fwant = phi4.phi4_action_grad_plain(cfgs, g, *w)
    d, fd = (got - want).abs(), (fgot - fwant).abs()
    rel = float((d / want.abs().clamp(min=1.0)).max())
    ok = bool((fd <= FORCE_ATOL + FORCE_RTOL * fwant.abs()).all())
    print(f"phi4_action (128, 8, 8), general kernel: max rel {rel:.3e} (tol "
          f"{PHI4_REL_TOL}); phi4_action_grad: max abs {float(fd.max()):.3e}"
          f" (rtol {FORCE_RTOL}, atol {FORCE_ATOL}) {'ok' if ok else 'FAILED'}")
    if not (rel <= PHI4_REL_TOL and ok):
        raise AssertionError("a phi4 kernel disagrees with its plain version "
                             "at (128, 8, 8)")
    check_tiled(counters, "8x8 checks", tiled=False)
    for name, err in (("phi4_action", float(d.max())),
                      ("phi4_action_grad", float(fd.max()))):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)

    def time_it():
        """Both kernels at (128, 8, 8), general; read warm."""
        for name, fn, plain in (
                ("phi4_action", lambda: phi4.phi4_action(cfgs, *w),
                 lambda: phi4.phi4_action_plain(cfgs, *w)),
                ("phi4_action_grad",
                 lambda: phi4.phi4_action_grad(cfgs, g, *w),
                 lambda: phi4.phi4_action_grad_plain(cfgs, g, *w))):
            record_variant(name, "(128, 8, 8) general",
                           kernel_times(name, fn, plain),
                           tuple(cfgs.shape), peaks, kernels)

    return time_it


def run_affine(torch, kernels, card):
    """The reference's 8x8 affine example (BASELINE config 2) at its
    defaults through ``normflow__tpu_torch.examples.scalar_affine.main``,
    trained as ``scripts/parity_observables.py:run_ours`` does (1000
    epochs at batch 128, lr 1e-3, the two ``param_groups``,
    ``steps_per_call=200``, graphed): ``main`` runs the first
    ``AFFINE_PROFILED`` epochs profiled, the counters set to 0 just before,
    and ``model.fit.train`` the rest on the same optimizer state and
    captured step, which no wrapper may see again; then
    ``sample_chain(150, 128, collect_samples=True)``, profiled, the
    counters set to 0 just before; <phi^2> and chi by the ported
    jackknife, each within 3 combined sigma of the JAX package's record;
    the round trip."""
    from normflow__tpu_torch import backward_sanitychecker
    from normflow__tpu_torch.examples import scalar_affine as affine
    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan
    from normflow__tpu_torch.tools.kernel_times import device_launches

    counters = {**_counters(), "accept_scan": accept_scan}
    train = {k: counters[k] for k in ("phi4_action", "phi4_action_grad")}
    reset_counts(counters)
    t0 = time.perf_counter()
    device, model = device_launches(lambda: affine.main(
        n_epochs=AFFINE_PROFILED, batch_size=AFFINE_BATCH, lr=1e-3,
        steps_per_call=200, print_stride=None, **AFFINE_ACTION))
    gate_path(train, kernels, "affine train", {k: 1 for k in train},
              AFFINE_PROFILED, device, tiled=False)
    captured = {k: c.launches for k, c in train.items()}
    model.fit.train(AFFINE_EPOCHS - AFFINE_PROFILED, batch_size=AFFINE_BATCH,
                    steps_per_call=200)
    seconds = time.perf_counter() - t0
    if {k: c.launches for k, c in train.items()} != captured:
        raise AssertionError("the affine fit's continuation ran a wrapper: "
                             "its step was not replayed")
    loss = np.asarray(model.fit.train_history["loss"])
    first, last = float(loss[:100].mean()), float(loss[-100:].mean())
    print(f"affine example: {model.net_.npar} parameters, "
          f"{AFFINE_EPOCHS} epochs at batch {AFFINE_BATCH} in {seconds:.2f} "
          f"s (capture included, the first {AFFINE_PROFILED} profiled) on "
          f"{card}; loss mean of the "
          f"first 100 {first:.4f}, of the last 100 {last:.4f}")
    if loss.shape != (AFFINE_EPOCHS,) or not np.isfinite(loss).all() \
            or not last < first:
        raise AssertionError("the affine example's loss is not finite or "
                             "not falling")

    chain = {k: counters[k] for k in ("phi4_action", "accept_scan")}
    reset_counts(chain)
    t0 = time.perf_counter()
    device, out = device_launches(lambda: model.mcmc.sample_chain(
        AFFINE_ROUNDS, AFFINE_BATCH, collect_samples=True))
    seconds = time.perf_counter() - t0
    gate_path(chain, kernels, "affine chain", {k: 1 for k in chain},
              AFFINE_ROUNDS, device, tiled=False)
    samples = out["samples"].reshape(-1, 8, 8).double().cpu().numpy()
    accept = float(out["accept_rate"].mean())
    if samples.shape[0] != AFFINE_ROUNDS * AFFINE_BATCH or not np.isfinite(
            samples).all():
        raise AssertionError("the affine chain's samples are not finite or "
                             "have the wrong shape")
    obs = affine.observables(samples)
    held = True
    for k, (want, want_err) in JAX_RECORD.items():
        got, err = obs[k]
        sigma = abs(got - want) / math.hypot(err, want_err)
        held &= sigma <= OBS_SIGMAS
        print(f"affine example {k}: {got:.5f} +- {err:.5f} (binned "
              f"jackknife, {samples.shape[0]} configurations) vs the JAX "
              f"package's {want} +- {want_err}: {sigma:.2f} combined sigma "
              f"(bar {OBS_SIGMAS}) on {card}")
    print(f"affine example accept rate {accept:.4f} (JAX package's record "
          f"{JAX_ACCEPT}; not gated: the random streams differ); "
          f"sample_chain({AFFINE_ROUNDS}, {AFFINE_BATCH}) in {seconds:.2f} s"
          " (capture included, profiled)")
    if not held:
        raise AssertionError("the affine example's observables miss the JAX "
                             "package's record")
    n = 64
    x_err, logj_err = backward_sanitychecker(model, n_samples=n,
                                             verbose=False)
    per_site = x_err / (n * 64)
    print(f"affine backward_sanitychecker: mean per-site |dx| "
          f"{per_site:.3e} (tol {SANITY_TOL}), mean |log0| "
          f"{logj_err / n:.3e}")
    if not per_site <= SANITY_TOL or not math.isfinite(logj_err):
        raise AssertionError("round trip through the affine flow failed")


def rates_in_turns(torch, card):
    """Eager bodies in a Python loop against the graphed entry points, in
    turns (eager, graphed, ..., graphed, eager): raw samples/s of 32
    batches of 1024 and training steps/s of segments of 10 steps, on two
    flagships of their own (seeded perturbed weights for sampling; for
    training, ``N_STEPS`` steps of the protocol's fit first, as the
    training path takes), each run once untimed first; then proposals/s
    of ``logqp_stream``, ``sample_chain`` and ``sample_parallel_chains``
    (32 rounds of 1024 each, graphed) in turns on the sampling flagship;
    then the packed against the unpacked flagship (``packed=False``, seeded
    perturbed weights; trained 8 steps first), raw samples/s and training
    steps/s of the graphed entry points in turns.  It runs before any
    profiler has in this process: after one, every launch from the host
    costs more."""
    from normflow__tpu_torch.tools.kernel_times import perturb_
    from normflow__tpu_torch.zoo import build_phi4_model

    model = build_phi4_model(LAT, seed=0)
    perturb_(model.net_, np.random.default_rng(1))
    trained = build_phi4_model(LAT, seed=0)
    fit_protocol(trained, N_STEPS)
    post, gen, fit = model.posterior, model.generator, trained.fit
    unpacked = build_phi4_model(LAT, packed=False, seed=0)
    perturb_(unpacked.net_, np.random.default_rng(1))
    unpacked_trained = build_phi4_model(LAT, packed=False, seed=0)
    fit_protocol(unpacked_trained, 8)
    upost, ufit = unpacked.posterior, unpacked_trained.fit
    arm = bf16_arm(torch, model)
    cntr = controlled(torch, build_phi4_model(LAT, seed=0))
    fit_protocol(cntr, 8)

    def eager_stream():
        for _ in range(N_BATCHES):
            post.logqp_batch(BATCH, gen)

    def eager_steps():
        for _ in range(10):
            fit.train_body()

    def graphed_steps():
        for _ in range(10):
            fit.step()

    mcmc = model.mcmc
    for what, unit, n, fns in (
            ("sampling", "raw samples/s", N_BATCHES * BATCH,
             {"eager": eager_stream,
              "graphed": lambda: post.logqp_stream(N_BATCHES, BATCH)}),
            (f"training at batch {TRAIN_BATCH}", "steps/s", 10,
             {"eager": eager_steps, "graphed": graphed_steps}),
            (f"samplers, {N_BATCHES} rounds of {BATCH}", "proposals/s",
             N_BATCHES * BATCH,
             {"logqp_stream": lambda: post.logqp_stream(N_BATCHES, BATCH),
              "sample_chain": lambda: mcmc.sample_chain(N_BATCHES, BATCH),
              "sample_parallel_chains": lambda: mcmc.sample_parallel_chains(
                  N_BATCHES, BATCH)}),
            ("packed vs unpacked flagship sampling, graphed", "raw samples/s",
             N_BATCHES * BATCH,
             {"packed": lambda: post.logqp_stream(N_BATCHES, BATCH),
              "unpacked": lambda: upost.logqp_stream(N_BATCHES, BATCH)}),
            (f"packed vs unpacked flagship training at batch {TRAIN_BATCH}, "
             "graphed", "steps/s", 10,
             {"packed": graphed_steps,
              "unpacked": lambda: [ufit.step() for _ in range(10)]}),
            ("float32 vs bf16 conditioners, sampling, graphed",
             "raw samples/s", N_BATCHES * BATCH,
             {"float32": lambda: post.logqp_stream(N_BATCHES, BATCH),
              "bf16": lambda: arm.posterior.logqp_stream(N_BATCHES,
                                                         BATCH)}),
            (f"plain vs controlled couplings, training at batch "
             f"{TRAIN_BATCH}, graphed", "steps/s", 10,
             {"plain": graphed_steps,
              "controlled": lambda: [cntr.fit.step() for _ in range(10)]})):
        in_turns(torch, card, what, unit, n, fns)
    bm = model.blocked_mcmc
    for n_blocks in (4, 16):
        sweeps = BLOCKED_PROPOSALS // n_blocks
        model.seed(40 + n_blocks)
        draws = blocked_draws(model, sweeps, n_blocks)
        in_turns(torch, card, f"blocked sampler, {sweeps} sweeps of "
                 f"{n_blocks} blocks from one latent state",
                 "block proposals/s", BLOCKED_PROPOSALS,
                 {"eager": lambda: bm.sweep(draws[0], 0.0, False,
                                            *draws[1:]),
                  "graphed": lambda: bm.sweep(draws[0], 0.0, False,
                                              *draws[1:], graphed=True)})


def replay_launches(torch, kernels, model, trained, zerodim):
    """Replays alone, profiled: each path's launches by kernel name per
    batch, step or round (every one tiled on the flagship where the kernel
    has a tiled variant, general on the zero-dim model's one site), and
    the device idle share of one eager and one replayed batch and step and
    of one replayed round of each sampler."""
    from normflow__tpu_torch.tools.kernel_times import device_launches

    counters = _counters()
    n_layers = len(model.net_[2].nets)
    gate_replays(counters, kernels, "sample",
                 {"rqs_coupling": n_layers, "phi4_action": 1}, N_BATCHES,
                 lambda: model.posterior.logqp_stream(N_BATCHES, BATCH))
    gate_replays(counters, kernels, "train",
                 {"rqs_coupling": 2 * n_layers,
                  "rqs_coupling_bwd": 2 * n_layers, "phi4_action": 1,
                  "phi4_action_grad": 1}, 4,
                 lambda: [trained.fit.step() for _ in range(4)])
    chain = {"rqs_coupling": n_layers, "phi4_action": 1, "accept_scan": 1}
    gate_replays(path_counters(chain), kernels, "chain", chain, 4,
                 lambda: model.mcmc.sample_chain(4, BATCH))
    gate_replays(counters, kernels, "parallel",
                 {"rqs_coupling": n_layers, "phi4_action": 1}, 4,
                 lambda: model.mcmc.sample_parallel_chains(4, BATCH))
    want = {"phi4_action": (1, 0), "phi4_action_grad": (1, 0)}
    got = device_launches(zerodim.fit.step)[0]
    print(f"zero-dim fit, one replayed step's launches by profiler name "
          f"(launches, tiled): {got}, want {want}")
    if got != want:
        raise AssertionError("the zero-dim step's replay missed the general "
                             "kernels")
    post, gen, fit = model.posterior, model.generator, trained.fit
    profile_step(lambda: post.logqp_batch(BATCH, gen),
                 f"one eager sampled batch of {BATCH}")
    profile_step(lambda: post.logqp_stream(1, BATCH),
                 f"one replayed sampled batch of {BATCH}")
    profile_step(model.mcmc.chain_graph(BATCH).graph.replay,
                 f"one replayed sample_chain round of {BATCH}")
    profile_step(model.mcmc.parallel_graph(BATCH).graph.replay,
                 f"one replayed sample_parallel_chains round of {BATCH}")
    profile_step(fit.train_body, f"one eager training step at batch "
                 f"{TRAIN_BATCH}")
    profile_step(fit.step, f"one replayed training step at batch "
                 f"{TRAIN_BATCH}")
    blocked = model.blocked_mcmc.block_graphs(model.prior.nvar // 4)
    profile_step(lambda: model.blocked_mcmc.block_step(blocked.state,
                                                       *blocked.inputs),
                 "one eager block step (one flow forward at B = 1)")
    profile_step(blocked.step.replay, "one replayed block step (one flow "
                 "forward at B = 1)")


# --------------------------------------------------------------------- #
# bf16 conditioners and controlled couplings at the flagship's widths
# --------------------------------------------------------------------- #
# the conv kernels of a profile, by name: cuDNN's and CUTLASS's conv
# kernels (fprop, dgrad, wgrad, implicit GEMMs)
CONV_RE = re.compile(r"conv|fprop|dgrad|wgrad|xmma|implicit_gemm|cudnn",
                     re.IGNORECASE)


def bf16_arm(torch, model):
    """A ``Model`` of its own on ``model``'s weights (shared) with bf16
    conditioners (``zoo.with_conv_compute_dtype``), the bench's
    ``cuda_bf16`` arm."""
    from normflow__tpu_torch import Model
    from normflow__tpu_torch.zoo import with_conv_compute_dtype

    return Model(net_=with_conv_compute_dtype(model.net_, torch.bfloat16),
                 prior=model.prior, action=model.action, seed=0)


def controlled(torch, model):
    """``model`` (a packed flagship) with its coupling stack rebuilt as one
    ``CntrRQSplineCoupling`` on the same nets and mask: each conditioner
    stack's first layer reads a standard normal control field of the
    frozen partition's shape, drawn from the model's generator."""
    from normflow__tpu_torch.models.couplings import CntrRQSplineCoupling

    cpl = model.net_[2]
    shape = (model.prior.shape[0], model.prior.shape[1] // 2)

    def draw(generator, batch_size):
        return torch.randn((batch_size, *shape), generator=generator,
                           device=generator.device)

    model.net_.flows[2] = CntrRQSplineCoupling(
        list(cpl.nets), mask=cpl.mask, xlim=cpl.xlim, ylim=cpl.ylim,
        extrap=cpl.extrap, control_generator=draw)
    return model


def conv_share(fn, what, reps=4):
    """The conv kernels' share of ``fn``'s device time (:data:`CONV_RE`),
    printed; ``fn`` run ``reps`` times in a profiled window."""
    dev = device_profile(fn, reps)[1]
    busy = sum(us for _, us in dev)
    conv = sum(us for n, us in dev if CONV_RE.search(n))
    print(f"{what}: conv kernels {conv / reps / 1e3:.4f} ms of "
          f"{busy / reps / 1e3:.4f} ms device time, share {conv / busy:.4f}")
    return conv / busy


def hold_on_path(torch, kernels, arm, x):
    """Kernels 1 and 3 at the inputs the bf16 path gives them: the first
    coupling's active partition and its bf16 conditioner's output (cast
    back to float32), and the flow's output, from the draws ``x``; each
    against its plain version (``RQS_TOL``, ``PHI4_REL_TOL``)."""
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc

    net = arm.net_
    cpl = net[2]
    with torch.no_grad():
        h = net[1].forward(*net[0].forward(x))[0]
        x_act, x_frz = cpl.mask.split(h)[:2]
        out = cpl.nets[0](cpl.preprocess_fz(x_frz)).contiguous()
        y = net.forward(x)[0]
    if out.dtype != torch.float32:
        raise AssertionError(f"the bf16 conditioner returned {out.dtype}")
    kw = dict(xlim=cpl.xlim, ylim=cpl.ylim, left="linear", right="linear")
    got = sc.rqs_coupling(x_act.contiguous(), out, **kw)
    want = sc.rqs_coupling_plain(x_act.contiguous(), out, **kw)
    w = arm.action.get_coef(2)
    s_got, s_want = phi4.phi4_action(y, *w), phi4.phi4_action_plain(y, *w)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    diff = (s_got - s_want).abs()
    rel = float((diff / s_want.abs().clamp(min=1.0)).max())
    print(f"bf16 path's inputs: rqs_coupling {tuple(out.shape)} vs plain "
          f"max |d| {err:.3e} (tol {RQS_TOL}); phi4_action "
          f"{tuple(y.shape)} vs plain max rel {rel:.3e} (tol "
          f"{PHI4_REL_TOL})")
    if not (err <= RQS_TOL and rel <= PHI4_REL_TOL):
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the bf16 path's inputs")
    for k, e in (("rqs_coupling", err), ("phi4_action",
                                         float(diff.max()))):
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], e)


def run_bf16_sampling(torch, kernels, model, card):
    """The sampling flagship (seeded perturbed weights) through
    ``with_conv_compute_dtype(net_, torch.bfloat16)`` on a ``Model`` of its
    own: kernels 1 and 3 at this path's inputs; logq against the float32
    flow on the same draws, on the card and on the CPU; ``logqp_stream(32,
    1024)`` profiled, the counters set to 0 just before; three replayed
    batches against their eager bodies, bit for bit, under
    ``cudnn.deterministic``; where a replayed batch's time goes, against
    the float32 batch's."""
    from normflow__tpu_torch import calc_ess
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.zoo import build_phi4_model

    rng = np.random.default_rng(20261019)
    arm = bf16_arm(torch, model)
    x = torch.tensor(rng.standard_normal((BATCH, *LAT)), dtype=torch.float32,
                     device="cuda")
    hold_on_path(torch, kernels, arm, x)

    cpu = build_phi4_model(LAT, seed=0, device="cpu")
    cpu.net_.load_state_dict({k: v.cpu() for k, v in
                              model.net_.state_dict().items()})
    cpu_arm = bf16_arm(torch, cpu)
    gaps = {}
    for where, m32, m16, xd in (("card", model, arm, x),
                                ("CPU", cpu, cpu_arm, x[:64].cpu())):
        with torch.no_grad():
            lq = [m.prior.log_prob(xd) - m.net_.forward(xd)[1]
                  for m in (m32, m16)]
        gap = (lq[1] - lq[0]).abs()
        gaps[where] = float(gap[:64].max())
        print(f"bf16 vs float32 conditioners on the {where}, "
              f"{xd.shape[0]} draws: logq gap per sample max "
              f"{float(gap.max()):.5f}, mean {float(gap.mean()):.5f} "
              f"(float32 logq spread {float(lq[0].std()):.3f})")
        if not bool(torch.isfinite(lq[1]).all()):
            raise AssertionError("the bf16 flow's logq is not finite")
    print(f"first 64 draws: card gap {gaps['card']:.5f}, CPU gap "
          f"{gaps['CPU']:.5f} (want 0 < card <= 2 CPU)")
    if not 0 < gaps["card"] <= 2 * gaps["CPU"]:
        raise AssertionError("the bf16 conditioners on the card are not "
                             "within twice the CPU's gap")

    counters = {k: c for k, c in _counters().items()
                if k in ("rqs_coupling", "phi4_action")}
    per_batch = {"rqs_coupling": len(arm.net_[2].nets), "phi4_action": 1}
    reset_counts(counters)
    t0 = time.perf_counter()
    device, logqp = device_launches(
        lambda: arm.posterior.logqp_stream(N_BATCHES, BATCH))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "bf16 sample", per_batch, N_BATCHES,
              device)
    if logqp.shape != (N_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("the bf16 logqp stream is not finite or has "
                             "the wrong shape")
    print(f"bf16 logqp_stream({N_BATCHES}, {BATCH}): ESS "
          f"{float(calc_ess(logqp)):.5f} (perturbed weights); the first "
          f"call, capture included, profiled, {seconds:.2f} s on {card}")

    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    arm.posterior._graphs.clear()  # captured anew with these algorithms
    try:
        arm.seed(21)
        got = arm.posterior.logqp_stream(3, BATCH)
        arm.seed(21)
        want = torch.cat([arm.posterior.logqp_batch(BATCH, arm.generator)
                          for _ in range(3)])
    finally:
        torch.backends.cudnn.deterministic = flag
        arm.posterior._graphs.clear()
    same = same_bits(torch, (got,), (want,))
    print(f"bf16 replayed vs eager batch, 3 x {BATCH}, cuDNN "
          f"deterministic: {'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("a bf16 replayed batch differs from its eager "
                             "body")
    for m, what in ((model, "float32"), (arm, "bf16")):
        fn = lambda m=m: m.posterior.logqp_stream(1, BATCH)  # noqa: E731
        fn()  # captured outside the profiled windows
        profile_step(fn, f"one replayed {what} sampled batch of {BATCH}")
        conv_share(fn, f"one replayed {what} sampled batch")


def run_cntr_training(torch, kernels, card):
    """The flagship's widths and the bench protocol with its couplings as
    one ``CntrRQSplineCoupling`` (``controlled``): ``model.fit`` for
    ``N_STEPS`` steps profiled, the counters set to 0 just before; two
    replays drawing different controls into one buffer; 10 replayed steps
    against 10 eager bodies from one state, bit for bit, under
    ``cudnn.deterministic``; where a replayed step's time goes."""
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.zoo import build_phi4_model

    model = controlled(torch, build_phi4_model(LAT, seed=0))
    counters = _counters()
    n_layers = len(model.net_[2].coupling.nets)
    per_step = {"rqs_coupling": 2 * n_layers, "rqs_coupling_bwd": 2 * n_layers,
                "phi4_action": 1, "phi4_action_grad": 1}
    reset_counts(counters)
    t0 = time.perf_counter()
    device, hist = device_launches(lambda: fit_protocol(model, N_STEPS))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "cntr train", per_step, N_STEPS, device)
    loss = np.asarray(hist["loss"])
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    print(f"controlled model.fit: {N_STEPS} steps in {seconds:.2f} s "
          f"(capture included, profiled); loss {loss[0]:.3f} -> "
          f"{loss[-1]:.3f}, mean of the first 10 {first:.3f}, of the last "
          f"10 {last:.3f}")
    if loss.shape != (N_STEPS,) or not np.isfinite(loss).all() \
            or not last < first:
        raise AssertionError("the controlled training loss is not finite "
                             "or not falling")

    cpl = model.net_[2]
    ptr, controls = cpl.control.data_ptr(), []
    for _ in range(2):
        model.fit.step()
        controls.append(cpl.control.clone())
    torch.cuda.synchronize()
    fresh = not torch.equal(*controls)
    print(f"two replays' controls {tuple(cpl.control.shape)}: "
          f"{'different' if fresh else 'THE SAME'}, one buffer "
          f"{cpl.control.data_ptr() == ptr}; mean |d| "
          f"{float((controls[0] - controls[1]).abs().mean()):.4f}")
    if not fresh or cpl.control.data_ptr() != ptr:
        raise AssertionError("successive replays did not draw new controls "
                             "into the control's buffer")
    replayed_vs_eager_steps(torch, model, "controlled: ", deterministic=True)
    model.fit.step()  # captured anew outside the profiled window
    profile_step(model.fit.step, f"one replayed controlled training step at "
                 f"batch {TRAIN_BATCH}")


def run_bench(torch):
    """The port's bench, in process, with a short training and timed
    streams of 100 batches (the bench's default 400 would outlast the
    smoke's time limit on a slow host)."""
    from normflow__tpu_torch import bench

    out = bench.main(["--train_epochs", "200", "--reps", "2",
                      "--sample_iters", "100"])
    if not (out["platform"] == "cuda" and 0.0 < out["ess"] <= 1.0
            and out["value"] > 0 and math.isfinite(out["value_err"])
            and 0.0 <= out["accept_rate"] <= 1.0):
        raise AssertionError(f"the bench's record is out of range: {out}")


# --------------------------------------------------------------------- #
# BASELINE config 4: the 64x64 flagship, data parallel, coarse-to-fine
# --------------------------------------------------------------------- #
C4_LAT, C4_HIDDEN = (64, 64), (16, 16)
# the example's epochs (normflow__tpu_torch/examples/
# scalar_64x64_distributed.py: 0 coarse, 4000 at lr 3e-3) cut for time:
# main() fits C4_COARSE steps at 32x32 with its own settings and samples
# the zero-shot transfer (n_epochs 0); then model.fit fine-tunes C4_FINE
# steps at lr C4_FINE_LR (docs/TRAINING.md:150-159's fine-tune rate)
C4_COARSE, C4_FINE, C4_FINE_LR = 2000, 200, 1e-4
C4_CHAINS, C4_ROUNDS, C4_BURN = 1024, 16, 4  # the example's chains
C4_CHAIN_ROUNDS = 8  # sample_chain rounds of C4_CHAINS proposals
# launches per training step and per round: the example trains with the
# fitter's default reparametrization estimator, as the JAX example does
# (4 coupling forwards and their 4 VJPs a step; the bench's path gradient
# adds the 4 inverses)
C4_STEP = {"rqs_coupling": 4, "rqs_coupling_bwd": 4, "phi4_action": 1,
           "phi4_action_grad": 1}
C4_ROUND = {"rqs_coupling": 4, "phi4_action": 1}
# Quality bar: per-site quality is what transfers (the volume law of
# docs/TRAINING.md:139-146 assumes it), so the zero-shot 64x64 flow's
# reverse-KL loss per site must keep at least C4_KEEP of the gain per site
# that the coarse fit made over an untrained 64x64 flow of the same seed:
# (loss_untrained - loss_64) / (loss_untrained - loss_32) >= C4_KEEP, each
# loss the mean of logq - logp over 8 x 1024 draws divided by the sites.
# The two lattices' free energies per site differ by finite-size terms far
# below that gain, so a transfer that kept the per-site quality passes
# and one that lost a tenth of it fails.
C4_KEEP = 0.9


def check_phi4_tiles(torch, kernels, peaks, lat, seed):
    """phi4_action at (1024, *lat) and phi4_action_grad at (512, *lat)
    on the tiled kernels against their plain versions with the flagship's
    tolerances, the force also bit for bit against its general kernel; at
    64x64 a tile is 1024 threads holding one sample.  Inputs from a numpy
    generator of its own (``seed``).  Returns the function that times
    them."""
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.ops.kernels import phi4

    rng = np.random.default_rng(seed)
    groups, samples = phi4.action_plan(lat)
    cfgs = torch.tensor(rng.standard_normal((BATCH, *lat)),
                        dtype=torch.float32, device="cuda")
    fc = cfgs[:TRAIN_BATCH]
    g = torch.tensor(rng.standard_normal(TRAIN_BATCH), dtype=torch.float32,
                     device="cuda")
    w = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(2)
    if phi4.action_variant(lat, cfgs.data_ptr()) != "tiled":
        raise AssertionError(f"{lat} does not take the tiled phi4 kernels")
    counters = {k: c for k, c in _counters().items()
                if k in ("phi4_action", "phi4_action_grad")}
    reset_counts(counters)
    got, want = phi4.phi4_action(cfgs, *w), phi4.phi4_action_plain(cfgs, *w)
    fgot = phi4.phi4_action_grad(fc, g, *w)
    fwant = phi4.phi4_action_grad_plain(fc, g, *w)
    fgen = phi4.phi4_action_grad(offset_copy(torch, fc), g, *w)
    torch.cuda.synchronize()
    d, fd = (got - want).abs(), (fgot - fwant).abs()
    rel = float((d / want.abs().clamp(min=1.0)).max())
    ok = bool((fd <= FORCE_ATOL + FORCE_RTOL * fwant.abs()).all())
    same = same_bits(torch, (fgot,), (fgen,))
    tiled = {k: c.tiled_launches for k, c in counters.items()}
    print(f"phi4 kernels at {lat}: tiles of {groups} threads x {samples} "
          f"sample(s); phi4_action (1024, {lat[0]}, {lat[1]}) max rel "
          f"{rel:.3e} (tol {PHI4_REL_TOL}); phi4_action_grad (512, "
          f"{lat[0]}, {lat[1]}) max abs {float(fd.max()):.3e} (rtol "
          f"{FORCE_RTOL}, atol {FORCE_ATOL}) {'ok' if ok else 'FAILED'}, vs "
          f"the general kernel {'bit for bit' if same else 'NOT bit-identical'}"
          f"; tiled launches {tiled}")
    if not (rel <= PHI4_REL_TOL and ok and same
            and tiled == {"phi4_action": 1, "phi4_action_grad": 1}):
        raise AssertionError(f"a phi4 kernel disagrees with its plain "
                             f"version or missed its tile at {lat}")
    for name, err in (("phi4_action", float(d.max())),
                      ("phi4_action_grad", float(fd.max()))):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)

    def time_it():
        """Both kernels at ``lat``, tiled: the action at B = 1024, the
        force at 512."""
        for name, fn, plain, shape in (
                ("phi4_action", lambda: phi4.phi4_action(cfgs, *w),
                 lambda: phi4.phi4_action_plain(cfgs, *w), cfgs.shape),
                ("phi4_action_grad",
                 lambda: phi4.phi4_action_grad(fc, g, *w),
                 lambda: phi4.phi4_action_grad_plain(fc, g, *w), fc.shape)):
            record_variant(name, f"{tuple(shape)} tiled",
                           kernel_times(name, fn, plain, plain_reps=5),
                           tuple(shape), peaks, kernels)

    return time_it


def split_slabs(torch, cfgs, n=2):
    """``n`` slabs of ``cfgs`` ``(B, L0, *rest)``, its rows split as
    ``parallel/space.slab_of`` (XLA) splits them, ``ceil(L0 / n)`` a rank,
    and their halos ``(B, 2, *rest)`` cut by hand: the row before each
    slab and the row after it, periodic over the lattice, as
    ``parallel/space.edge_rows`` exchanges them."""
    from normflow__tpu_torch.parallel.space import slab_of

    l0, out = cfgs.shape[1], []
    for r in range(n):
        s = slab_of(None, r, n, l0)
        out.append((cfgs[:, s.row0:s.row0 + s.rows].contiguous(),
                    torch.stack([cfgs[:, (s.row0 - 1) % l0],
                                 cfgs[:, (s.row0 + s.rows) % l0]],
                                1).contiguous()))
    return out


def slab_counters():
    from normflow__tpu_torch.ops.kernels import phi4

    return {"phi4_action_slab": phi4.phi4_action_slab,
            "phi4_action_slab_grad": phi4.phi4_action_slab_grad}


def hold_slabs(torch, cfgs, g, w, n=2):
    """The slab action and force of ``n`` slabs of ``cfgs``: the summed
    actions against the whole-lattice kernel and the slab plain versions
    (max |dS| / max(1, |S|)), the stacked forces against both (``FORCE_*``
    element by element).  Returns ``(rel, max |dforce|, ok)``."""
    from normflow__tpu_torch.ops.kernels import phi4

    act, plain_act, force, plain_force = 0, 0, [], []
    for slab, halo in split_slabs(torch, cfgs, n):
        act = act + phi4.phi4_action_slab(slab, halo, *w)
        plain_act = plain_act + phi4.phi4_action_slab_plain(slab, halo, *w)
        force.append(phi4.phi4_action_slab_grad(slab, halo, g, *w))
        plain_force.append(phi4.phi4_action_slab_grad_plain(slab, halo, g,
                                                            *w))
    force, plain_force = torch.cat(force, 1), torch.cat(plain_force, 1)
    whole = phi4.phi4_action(cfgs, *w)
    whole_force = phi4.phi4_action_grad(cfgs, g, *w)
    torch.cuda.synchronize()
    rel = max(float(((act - want).abs() / want.abs().clamp(min=1.0)).max())
              for want in (whole, plain_act))
    dforce = max(float((force - want).abs().max())
                 for want in (whole_force, plain_force))
    ok = all(bool(((force - want).abs()
                   <= FORCE_ATOL + FORCE_RTOL * want.abs()).all())
             for want in (whole_force, plain_force))
    return rel, dforce, ok and rel <= PHI4_REL_TOL


# the tiled nd slab kernels' records by wrapper: on a slab of a 3-D or 4-D
# lattice every tiled launch of a slab wrapper is theirs
SLAB_ND_RECORDS = {"phi4_action_slab": "phi4_action_slab_tiled_nd",
                   "phi4_action_slab_grad": "phi4_action_slab_grad_tiled_nd"}
# the slabs at which phase 21 times them in turns with the general entries:
# half the 8^4 flagship at B = 1024 (the record's), at phase 26's batch,
# the three rows of 8 over three ranks, and half of 8^3
SLAB_ND_TIMES = ((BATCH, 4, 8, 8, 8), (128, 4, 8, 8, 8), (BATCH, 3, 8, 8, 8),
                 (BATCH, 4, 8, 8))


def check_slab_kernels(torch, kernels, peaks, rng, action):
    """Phase 21, step 1: the slab variants of the action and its force
    (``phi4_action_slab``, ``phi4_action_slab_grad``) on the slabs of a
    field with hand-built halos, held against the whole-lattice kernels and
    their plain slab versions: (1024, 32, 32) as two (1024, 16, 32) slabs
    and config 4's (1024, 64, 64) as two of 32 rows, on the tiled kernels;
    (1024, 8, 8, 8, 8) as two slabs of 4 rows and as 3 / 3 / 2 (XLA's
    split over three ranks), and (64, 8, 8, 8) as two, on the tiled nd
    kernels, each slab's force bit for bit against the general slab
    entry and its action within ``PHI4_REL_TOL`` of it; the general
    kernels at 1-D, (128, 8, 8), an odd (64, 3, 5, 4, 6) and on (1024, 32,
    32) over three ranks, XLA's split, slabs of (1024, 11, 32) and (1024,
    10, 32) (their float4 groups are no whole warps: ``phi4.action_plan``);
    the tiled and tiled nd forces bit for bit against the general one on
    an offset copy (which the wrappers send to the general kernel); a slab
    of no rows returns zero and an empty force with no launch.  Returns the
    function that times them at the flagship's slab and the ragged ones,
    and the tiled nd slab kernels (:func:`time_slab_nd`)."""
    from normflow__tpu_torch.ops.kernels import phi4

    counters = slab_counters()
    worst = {k: 0.0 for k in counters}
    for k, nd in SLAB_ND_RECORDS.items():
        kernels[nd] = dict(
            name=nd, route="cuda",
            source="normflow__tpu_torch/csrc/phi4_action.cu",
            replaces=f"normflow__tpu/ops/kernels/phi4.py:"
                     f"{30 if k == 'phi4_action_slab' else 49}",
            max_abs_err=0.0, library_ms=None, launches_by_path={},
            replay_launches_per_unit={})
    for shape, variant, n in (((BATCH, *LAT), "tiled", 2),
                              ((BATCH, 64, 64), "tiled", 2),
                              ((BATCH, 64), "general", 2),
                              ((128, 8, 8), "general", 2),
                              ((64, 8, 8, 8), "tiled_nd", 2),
                              ((BATCH, 8, 8, 8, 8), "tiled_nd", 2),
                              ((BATCH, 8, 8, 8, 8), "tiled_nd", 3),
                              ((64, 3, 5, 4, 6), "general", 2),
                              ((BATCH, *LAT), "general", 3)):
        cfgs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")
        g = torch.tensor(rng.standard_normal(shape[0]), dtype=torch.float32,
                         device="cuda")
        w = action.get_coef(len(shape) - 1)
        reset_counts(counters)
        rel, dforce, ok = hold_slabs(torch, cfgs, g, w, n)
        tiled = {k: (c.launches, c.tiled_launches)
                 for k, c in counters.items()}
        want = 0 if variant == "general" else n
        slabs = split_slabs(torch, cfgs, n)
        heights = [tuple(s.shape[1:2]) for s, _ in slabs]
        print(f"slab kernels on {n} slabs of {shape} (rows {heights}, "
              f"{variant}): summed action max rel {rel:.3e} (tol "
              f"{PHI4_REL_TOL}), stacked force max abs {dforce:.3e} (rtol "
              f"{FORCE_RTOL}, atol {FORCE_ATOL}) against the whole-lattice "
              f"kernels and the plain slab versions: "
              f"{'ok' if ok else 'FAILED'}; (launches, tiled) {tiled}")
        if not ok or any(t != (n, want) for t in tiled.values()):
            raise AssertionError(f"a slab kernel disagrees or missed its "
                                 f"variant at {shape} over {n} slabs")
        if variant == "tiled_nd":
            # each slab against the general slab entries on the same slab
            for slab, halo in slabs:
                got = phi4.phi4_action_slab(slab, halo, *w)
                force = phi4.phi4_action_slab_grad(slab, halo, g, *w)
                gen = general_phi4(torch, slab, w, halo=halo)
                gen_force = general_phi4(torch, slab, w, g, halo)
                plain = phi4.phi4_action_slab_plain(slab, halo, *w)
                torch.cuda.synchronize()
                grel = float(((got - gen).abs()
                              / gen.abs().clamp(min=1.0)).max())
                same = same_bits(torch, (force,), (gen_force,))
                print(f"  tiled nd slab {tuple(slab.shape)} vs the general "
                      f"slab entries: action max rel {grel:.3e} (tol "
                      f"{PHI4_REL_TOL}), force "
                      f"{'bit for bit' if same else 'NOT bit-identical'}")
                if not (same and grel <= PHI4_REL_TOL):
                    raise AssertionError("a tiled nd slab kernel departs "
                                         "from the general slab kernel at "
                                         f"{tuple(slab.shape)}")
                for k, err in (("phi4_action_slab",
                                float((got - plain).abs().max())),
                               ("phi4_action_slab_grad", dforce)):
                    nd = kernels[SLAB_ND_RECORDS[k]]
                    nd["max_abs_err"] = max(nd["max_abs_err"], err)
            continue
        worst["phi4_action_slab"] = max(worst["phi4_action_slab"], rel)
        worst["phi4_action_slab_grad"] = max(worst["phi4_action_slab_grad"],
                                             dforce)
    # the tiled and tiled nd forces against the general kernel on an offset
    # copy, which the wrappers send to it
    for lat in ((8, 8, 8, 8), LAT):  # the 2-D field last: time_it's
        cfgs = torch.tensor(rng.standard_normal((BATCH, *lat)),
                            dtype=torch.float32, device="cuda")
        g = torch.tensor(rng.standard_normal(BATCH), dtype=torch.float32,
                         device="cuda")
        w = action.get_coef(len(lat))
        slab, halo = split_slabs(torch, cfgs)[0]
        reset_counts(counters)
        tiled = phi4.phi4_action_slab_grad(slab, halo, g, *w)
        general = phi4.phi4_action_slab_grad(offset_copy(torch, slab), halo,
                                             g, *w)
        torch.cuda.synchronize()
        same = same_bits(torch, (tiled,), (general,))
        c = counters["phi4_action_slab_grad"]
        bits = "bit for bit" if same else "NOT bit-identical"
        print(f"slab force at {tuple(slab.shape)}: "
              f"{phi4.slab_variant(slab.shape[1:], 0)} vs the general kernel "
              f"on an offset copy {bits}; (launches, tiled) "
              f"{(c.launches, c.tiled_launches)}")
        if not same or (c.launches, c.tiled_launches) != (2, 1):
            raise AssertionError("a tiled slab force departs from the "
                                 "general one, or the offset copy took a "
                                 "tile")
    # a slab of no rows (4 rows over three ranks): decided by shape, no launch
    empty = torch.zeros((BATCH, 0, LAT[1]), device="cuda")
    halo = torch.tensor(rng.standard_normal((BATCH, 2, LAT[1])),
                        dtype=torch.float32, device="cuda")
    reset_counts(counters)
    act = phi4.phi4_action_slab(empty, halo, *w)
    force = phi4.phi4_action_slab_grad(empty, halo, g, *w)
    torch.cuda.synchronize()
    launched = {k: c.launches for k, c in counters.items()}
    print(f"a slab of no rows {tuple(empty.shape)}: action "
          f"{'zero' if not bool(act.any()) else 'NOT zero'} "
          f"{tuple(act.shape)}, force {tuple(force.shape)}; wrapper launches "
          f"{launched} (want none)")
    if bool(act.any()) or act.shape != (BATCH,) \
            or force.shape != empty.shape or any(launched.values()):
        raise AssertionError("a slab of no rows launched a kernel or gave "
                             "a wrong result")
    for name, line in (("phi4_action_slab", 30), ("phi4_action_slab_grad",
                                                  49)):
        kernels[name] = dict(
            name=name, route="cuda",
            source="normflow__tpu_torch/csrc/phi4_action.cu",
            replaces=f"normflow__tpu/ops/kernels/phi4.py:{line}",
            max_abs_err=worst[name], library_ms=None,
            launches_by_path={}, replay_launches_per_unit={})

    time_nd = time_slab_nd(torch, kernels, peaks, rng, action)

    def time_it():
        """Both slab kernels at the flagship's slab (1024, 16, 32), read
        warm, as the whole-lattice ones; config 4's and the flagship's
        over three ranks, (1024, 11, 32) and (1024, 10, 32), under
        ``variants``; then the tiled nd slab kernels (:func:`time_slab_nd`).
        """
        big = torch.tensor(rng.standard_normal((BATCH, 64, 64)),
                           dtype=torch.float32, device="cuda")
        three = split_slabs(torch, cfgs, 3)
        for (s, h), what in ((split_slabs(torch, cfgs)[0], None),
                             (split_slabs(torch, big)[0],
                              "(1024, 32, 64) tiled"),
                             (three[0], "(1024, 11, 32) general"),
                             (three[2], "(1024, 10, 32) general")):
            for name, fn, plain in (
                    ("phi4_action_slab",
                     lambda: phi4.phi4_action_slab(s, h, *w),
                     lambda: phi4.phi4_action_slab_plain(s, h, *w)),
                    ("phi4_action_slab_grad",
                     lambda: phi4.phi4_action_slab_grad(s, h, g, *w),
                     lambda: phi4.phi4_action_slab_grad_plain(s, h, g,
                                                              *w))):
                t = kernel_times(name, fn, plain, plain_reps=5)
                if what is None:
                    report(name, t, tuple(s.shape), peaks, kernels, "warm")
                else:
                    record_variant(name, what, t, tuple(s.shape), peaks,
                                   kernels)
        time_nd()

    return time_it


def time_slab_nd(torch, kernels, peaks, rng, action):
    """The function that names the tiled nd slab kernels' launches by
    profiler and times them: one launch each of the slab action and force
    at (1024, 4, 8, 8, 8) in a profiled window, which must name
    ``phi4_action_slab_tiled_nd_kernel`` and
    ``phi4_action_grad_slab_tiled_nd_kernel``; then at ``SLAB_ND_TIMES``'
    slabs (each the first slab of a field split as ``split_slabs`` splits
    it), warm and cold, in turns with the general slab entries on the same
    tensors (general, tiled nd, tiled nd, general): the records' times,
    read warm, at (1024, 4, 8, 8, 8), the rest under ``variants``, the
    general entries' beside them (``general_in_turns``)."""
    from normflow__tpu_torch.ops.kernels import phi4

    cases = []
    for shape in SLAB_ND_TIMES:  # 4 rows: half of 8; 3: a third, XLA's
        field = torch.tensor(rng.standard_normal((shape[0], 8, *shape[2:])),
                             dtype=torch.float32, device="cuda")
        slab, halo = split_slabs(torch, field, 2 if shape[1] == 4 else 3)[0]
        g = torch.tensor(rng.standard_normal(shape[0]), dtype=torch.float32,
                         device="cuda")
        w = action.get_coef(len(shape) - 1)
        if tuple(slab.shape) != shape or phi4.slab_variant(
                shape[1:], slab.data_ptr(), halo.data_ptr()) != "tiled_nd":
            raise AssertionError(f"{shape} is not a tiled nd slab")
        cases.append((shape, slab, halo, g, w))

    def time_it():
        from normflow__tpu_torch.tools.kernel_times import cold_ms, warm_ms

        _, slab, halo, g, w = cases[0]
        dev = device_profile(lambda: (
            phi4.phi4_action_slab(slab, halo, *w),
            phi4.phi4_action_slab_grad(slab, halo, g, *w)), 1)[1]
        names = [n for n, _ in dev if "phi4_action" in n]
        print(f"the tiled nd slab kernels at {tuple(slab.shape)}, by "
              f"profiler name: {names}")
        if len(names) != 2 or not re.search(
                r"\bphi4_action_slab_tiled_nd_kernel\b", names[0]) or not \
                re.search(r"\bphi4_action_grad_slab_tiled_nd_kernel\b",
                          names[1]):
            raise AssertionError("the slabs of 8^4 did not launch the tiled "
                                 "nd slab kernels")
        for shape, slab, halo, g, w in cases:
            for name, fn, plain, general in (
                    ("phi4_action_slab",
                     lambda: phi4.phi4_action_slab(slab, halo, *w),
                     lambda: phi4.phi4_action_slab_plain(slab, halo, *w),
                     lambda: general_phi4(torch, slab, w, halo=halo)),
                    ("phi4_action_slab_grad",
                     lambda: phi4.phi4_action_slab_grad(slab, halo, g, *w),
                     lambda: phi4.phi4_action_slab_grad_plain(slab, halo, g,
                                                              *w),
                     lambda: general_phi4(torch, slab, w, g, halo))):
                nd = SLAB_ND_RECORDS[name]
                gen = [dict(ms=warm_ms(general), ms_cold=cold_ms(general))]
                t = kernel_times(nd, fn, plain, plain_reps=5)
                again = dict(ms=warm_ms(fn), ms_cold=cold_ms(fn))
                gen.append(dict(ms=warm_ms(general),
                                ms_cold=cold_ms(general)))
                print(f"{nd} at {shape} in turns with the general slab "
                      f"kernel: general {gen[0]['ms']:.5f} / "
                      f"{gen[0]['ms_cold']:.5f}, tiled nd {t['ms']:.5f} / "
                      f"{t['ms_cold']:.5f}, {again['ms']:.5f} / "
                      f"{again['ms_cold']:.5f}, general {gen[1]['ms']:.5f} / "
                      f"{gen[1]['ms_cold']:.5f} ms (warm / cold)")
                kernels[nd].setdefault("general_in_turns", {})[
                    str(shape)] = gen
                if shape == SLAB_ND_TIMES[0]:
                    report(nd, t, shape, peaks, kernels, "warm")
                else:
                    record_variant(nd, f"{shape} tiled nd", t, shape, peaks,
                                   kernels)

    return time_it


def mean_loss_per_site(torch, model, n_batches=8):
    """``(mean of logq - logp per site, ESS)`` over ``n_batches`` x
    ``C4_CHAINS`` fresh draws."""
    from normflow__tpu_torch import calc_ess

    logqp = model.posterior.logqp_stream(n_batches, C4_CHAINS)
    return (float(logqp.mean()) / math.prod(model.prior.shape),
            float(calc_ess(logqp)))


def run_config4(torch, kernels, peaks, card):
    """BASELINE config 4 at full width: the four kernels at its shapes;
    a world-size-1 NCCL group on a free localhost port; the example's
    ``main()`` (coarse 32x32 fit, transfer, zero-shot 1024 chains) with the
    counters set to 0 just before; the transferred flow against a float64
    CPU copy and the quality bar; a profiled fine-tune with the all-reduce
    in every replayed step, profiled parallel chains and ``sample_chain``;
    10 replayed steps against 10 eager bodies bit for bit; rates, idle
    shares and the bucket's time; the kernels' times at its shapes.  The
    group has one rank, so its all-reduce calls launch no NCCL kernel."""
    import torch.distributed as dist

    from normflow__tpu_torch.examples import scalar_64x64_distributed as ex
    from normflow__tpu_torch.models.masks import PackedEvenOddMask
    from normflow__tpu_torch.ops import observables
    from normflow__tpu_torch.parallel import free_port, init_distributed
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.utils.graphs import WARMUP
    from normflow__tpu_torch.zoo import build_phi4_model

    t_phase = time.perf_counter()
    timers = [check_coupling_at(torch, kernels, peaks,
                                (C4_LAT[0], C4_LAT[1] // 2), 20261020),
              check_phi4_tiles(torch, kernels, peaks, C4_LAT, 20261021)]
    init_distributed(rank=0, world_size=1,
                     init_method=f"tcp://localhost:{free_port()}")
    try:
        print(f"config 4: NCCL group of {dist.get_world_size()} on "
              f"{card}; cuts: coarse fit {C4_COARSE} steps at 32x32 (the "
              f"example's default: off), main(n_epochs=0) (default 4000), "
              f"then {C4_FINE} fine-tune steps at lr {C4_FINE_LR}")
        counters = path_counters(("rqs_coupling", "rqs_coupling_bwd",
                                  "phi4_action", "phi4_action_grad",
                                  "accept_scan"))
        reset_counts(counters)
        t0 = time.perf_counter()
        model = ex.main(coarse_epochs=C4_COARSE, n_epochs=0,
                        chains=C4_CHAINS, chain_rounds=C4_ROUNDS,
                        device="cuda")
        seconds = time.perf_counter() - t0
        # the coarse step's capture and the 64x64 parallel round's, each
        # WARMUP bodies and the capture itself
        want = {k: (WARMUP + 1) * (C4_STEP.get(k, 0) + C4_ROUND.get(k, 0))
                for k in counters}
        got = {k: c.launches for k, c in counters.items()}
        print(f"config 4 main(): {seconds:.2f} s; wrapper launches {got} "
              f"(want {want})")
        dh = model.device_handler
        if got != want or dh.group is None:
            raise AssertionError("config 4's main() missed a kernel or "
                                 "the process group")
        check_tiled(counters, "config 4 main()")
        n_par = model.net_.npar
        print(f"config 4 flow: {n_par} parameters, {C4_LAT}, hidden "
              f"{C4_HIDDEN}, 4 couplings, 8 knots")

        x = np.random.default_rng(20261022).standard_normal((64, *C4_LAT))
        cpu64 = build_phi4_model(C4_LAT, hidden=C4_HIDDEN, device="cpu",
                                 dtype=torch.float64)
        cpu64.net_.load_state_dict({k: v.double() for k, v in
                                    model.net_.state_dict().items()})
        with torch.no_grad():
            xg = torch.tensor(x, dtype=torch.float32, device="cuda")
            logq = (model.prior.log_prob(xg) - model.net_(xg)[1]).cpu()
            x64 = torch.tensor(x)
            want64 = cpu64.prior.log_prob(x64) - cpu64.net_(x64)[1]
        rel = float(((logq.double() - want64).abs()
                     / want64.abs().clamp(min=1.0)).max())
        print(f"config 4 transferred flow on the card vs float64 CPU: max "
              f"rel logq {rel:.3e} (tol {LOGQ_REL_TOL})")
        if not rel <= LOGQ_REL_TOL:
            raise AssertionError("the transferred 64x64 flow disagrees with "
                                 "its float64 CPU copy")

        coarse = build_phi4_model((32, 32), hidden=C4_HIDDEN)
        coarse.net_ = model.net_.transfer(
            shape=(32, 32), mask=PackedEvenOddMask(shape=(32, 32)))
        loss32, ess32 = mean_loss_per_site(torch, coarse)
        loss64, ess64 = mean_loss_per_site(torch, model)
        fresh = build_phi4_model(C4_LAT, hidden=C4_HIDDEN)
        loss_u = mean_loss_per_site(torch, fresh, 2)[0]
        del coarse, fresh
        keep = (loss_u - loss64) / (loss_u - loss32)
        print(f"config 4 quality: loss per site 32x32 {loss32:.6f}, "
              f"zero-shot 64x64 {loss64:.6f}, untrained 64x64 {loss_u:.6f}:"
              f" the transfer keeps {keep:.4f} of the per-site gain (bar "
              f"{C4_KEEP}); ESS 32x32 {ess32:.5f}, zero-shot 64x64 "
              f"{ess64:.6f}, the volume law's ESS32^4 {ess32 ** 4:.6f}")
        if not keep >= C4_KEEP:
            raise AssertionError("the zero-shot 64x64 flow lost its per-site "
                                 "quality")

        train = {k: counters[k] for k in C4_STEP}
        reset_counts(train)
        t0 = time.perf_counter()
        device, hist = device_launches(lambda: ex.fit(
            model, C4_FINE, TRAIN_BATCH, C4_FINE_LR, 50, None))
        seconds = time.perf_counter() - t0
        gate_path(train, kernels, "config 4 train", C4_STEP, C4_FINE,
                  device)
        loss = np.asarray(hist["loss"][-C4_FINE:])
        if loss.shape != (C4_FINE,) or not np.isfinite(loss).all():
            raise AssertionError("config 4's fine-tune loss is not finite")
        print(f"config 4 fine-tune: {C4_FINE} steps in {seconds:.2f} s "
              f"(capture included, profiled), the all-reduce in each; loss "
              f"per site {loss[0] / 4096:.6f} -> {loss[-1] / 4096:.6f}")
        loss_ft, ess_ft = mean_loss_per_site(torch, model)
        print(f"config 4 after the fine-tune: loss per site {loss_ft:.6f}, "
              f"ESS {ess_ft:.6f}")

        replayed_vs_eager_steps(torch, model, "config 4, the all-reduce "
                                "in each step: ", deterministic=True)
        c4_rates(torch, model, card)

        mcmc = model.mcmc
        par = {k: counters[k] for k in C4_ROUND}
        mcmc._graphs.clear()  # the profiled call captures anew
        reset_counts(par)
        device, out = device_launches(lambda: mcmc.sample_parallel_chains(
            C4_ROUNDS + C4_BURN, C4_CHAINS, collect_samples=True))
        gate_path(par, kernels, "config 4 parallel", C4_ROUND,
                  C4_ROUNDS + C4_BURN, device)
        if out["samples"].shape != (C4_ROUNDS + C4_BURN, C4_CHAINS,
                                    *C4_LAT) \
                or not bool(torch.isfinite(out["logq"]).all()):
            raise AssertionError("config 4's parallel chains are not finite "
                                 "or have the wrong shape")
        o = ex.chain_observables(out, C4_BURN)
        del out
        y, logq, logp = zip(*(model.posterior.sample__(C4_CHAINS)
                              for _ in range(16)))
        p2 = observables.phi2(torch.cat(y)).double()
        logw = (torch.cat(logp) - torch.cat(logq)).double()
        wgt = torch.softmax(logw, 0)
        print(f"config 4 after the fine-tune: chains <phi^2> "
              f"{o['phi2']:.5f} +- {o['phi2_err']:.5f}, chi {o['chi']:.3f}, "
              f"tau_int {o['tau']:.2f}, accept {o['accept']:.4f}; "
              f"reweighted raw samples <phi^2> {float((wgt * p2).sum()):.5f}"
              f" (weights' ESS {float(1 / (wgt ** 2).sum()) / len(wgt):.5f}"
              f" of {len(wgt)})")

        per_round = {**C4_ROUND, "accept_scan": 1}
        chain = {k: counters[k] for k in per_round}
        mcmc._graphs.clear()
        mcmc.reset()
        reset_counts(chain)
        device, out = device_launches(lambda: mcmc.sample_chain(
            C4_CHAIN_ROUNDS, C4_CHAINS))
        gate_path(chain, kernels, "config 4 chain", per_round,
                  C4_CHAIN_ROUNDS, device)
        rates = out["accept_rate"]
        if not bool(torch.isfinite(out["logq"]).all()):
            raise AssertionError("config 4's sample_chain is not finite")
        print(f"config 4 sample_chain({C4_CHAIN_ROUNDS}, {C4_CHAINS}), the "
              f"gather in each round: accept {float(rates.mean()):.4f}")
    finally:
        dist.destroy_process_group()
    for time_it in timers:
        time_it()
    print(f"config 4 phase: {time.perf_counter() - t_phase:.1f} s of added "
          f"wall on {card}")


def c4_rates(torch, model, card):
    """Config 4's graphed rates and where a replay's time goes: raw
    samples/s of ``logqp_stream(16, 1024)`` and steps/s of 20 replayed
    steps, each the median of 3 timings; the idle share and top kernels
    of a replayed step, batch and parallel round; the device time per
    step of the data-parallel bucket, as a replayed step's time less that
    of the same model with no group, in turns: at world size 1 the flat
    copy and the division, since a one-rank NCCL all-reduce launches no
    kernel."""
    from normflow__tpu_torch.examples import scalar_64x64_distributed as ex
    from normflow__tpu_torch.zoo import build_phi4_model

    post, fit = model.posterior, model.fit
    post.logqp_stream(1, C4_CHAINS)  # captured

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    batch = statistics.median(
        wall(lambda: post.logqp_stream(16, C4_CHAINS)) for _ in range(3))
    step = statistics.median(
        wall(lambda: [fit.step() for _ in range(20)]) for _ in range(3))
    print(f"config 4 graphed: {16 * C4_CHAINS / batch:.1f} raw samples/s, "
          f"{20 / step:.2f} steps/s (batch {TRAIN_BATCH}) on {card}")
    profile_step(fit.step, f"one replayed config 4 step at {TRAIN_BATCH}, "
                 "the all-reduce in it")
    plain = build_phi4_model(C4_LAT, hidden=C4_HIDDEN)
    plain.net_.load_state_dict(model.net_.state_dict())
    ex.fit(plain, 1, TRAIN_BATCH, C4_FINE_LR, None, None)  # captured
    turns = {"group": [], "none": []}
    for _ in range(3):
        for key, m in (("group", model), ("none", plain), ("group", model)):
            turns[key].append(time_ms(m.fit.step, reps=20, warmup=1))
    with_group, without = (statistics.median(turns[k])
                           for k in ("group", "none"))
    print(f"  a replayed step, median of 20 CUDA-event timings, in turns: "
          f"{with_group:.5f}"
          f" ms with the group, {without:.5f} ms without; the data-parallel "
          f"bucket at world size 1 (flat copy and division; no NCCL kernel) "
          f"{with_group - without:.5f} ms per step")
    del plain
    profile_step(lambda: post.logqp_stream(1, C4_CHAINS),
                 f"one replayed config 4 batch of {C4_CHAINS}")
    model.mcmc.sample_parallel_chains(1, C4_CHAINS)
    profile_step(model.mcmc.parallel_graph(C4_CHAINS).graph.replay,
                 f"one replayed config 4 parallel round of {C4_CHAINS}")


# --------------------------------------------------------------------- #
# Phase 21: lattice (space) sharding, two processes on the one card
# --------------------------------------------------------------------- #
SPACE_AXES = {"data": 1, "space": 2}
SPACE_SEED = 20261021
SPACE_ROUNDS = 4  # sample_chain(SPACE_ROUNDS, BATCH) on the sharded model
SPACE_STEPS = 12  # eager steps of the two-rank fit (24 until phase 26 came)
SPACE_BLOCKED = 2  # blocked_mcmc.sample__(SPACE_BLOCKED, n_blocks=K) there
# The sharded fit's loss against the unsharded eager fit on the same draws,
# max |dl| / max(1, |l|) over the SPACE_STEPS steps.  Both run in float32
# and the sharded one sums in another order (the totals over two slabs, the
# gradients over two ranks, the volume mean), and that many Adam steps carry
# such differences far: on the CPU, the unsharded fit of the 16x16 flagship
# (batch 64, the bench protocol) moved by up to 2e-3 between 1 and 8
# threads.  So the bar is the larger of SPACE_LOSS_TOL and SPACE_FLOOR
# times the unsharded fit's own spread on the card, its loss against a
# second unsharded fit whose draws are nudged by one float32 ulp; the first
# step, before any update, must agree to LOGQ_REL_TOL.
SPACE_LOSS_TOL, SPACE_FLOOR = 1e-4, 10.0
SPACE_TIMEOUT = 600.0  # seconds the parent waits for the two ranks


def space_draw(seed, k, shape):
    """Draw ``k`` of phase 21: the same numpy normals in every process."""
    return np.random.default_rng([seed, k + 1]).standard_normal(
        shape).astype(np.float32)


def space_rank(rank, n, init_method, run, args, queue):
    """One of the ``n`` processes of phases 21 and 25: joins a gloo group
    of ``n`` on the one card (NCCL refuses two ranks on one device; gloo
    stages CUDA tensors through the host), runs ``run(torch, *args)`` and
    puts ``(rank, (failed, result or traceback))`` on ``queue``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=n)
        try:
            queue.put((rank, (False, run(torch, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, (True, traceback.format_exc())))
        raise


def space_run(torch, states, seed):
    """The full-width flagship on ``SPACE_AXES``: this rank's slab of the
    fed batch through ``posterior.sample__`` with the perturbed weights
    ``states[0]``, then ``SPACE_STEPS`` eager steps of the bench protocol on
    fed draws from the fresh weights ``states[1]``, with every launch
    counter set to 0 just before and read just after, and
    ``sample_chain(SPACE_ROUNDS, BATCH)`` likewise."""
    import torch.distributed as dist

    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan
    from normflow__tpu_torch.zoo import build_phi4_model

    torch.set_num_threads(1)  # two processes share the host's cores
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_phi4_model(LAT, seed=0)
    model.net_.load_state_dict({k: torch.from_numpy(v)
                                for k, v in states[0].items()})
    dh = model.device_handler
    dh.use_mesh(axes=SPACE_AXES)
    dh.replicate_params()
    slab = dh.slab
    if dist.get_backend(dh.group) != "gloo" or dh.captures():
        raise AssertionError("the two-process phase must run eagerly over "
                             "gloo")

    def cut(a):
        rows = a[:, slab.row0:slab.row0 + slab.rows]
        return torch.from_numpy(np.ascontiguousarray(rows)).cuda()

    xs = cut(space_draw(seed, -1, (BATCH, *LAT)))
    y, logq, logp = model.posterior.sample__(
        BATCH, preprocess_func=lambda x, logr: (xs, model.prior.log_prob(xs)))
    blocked = space_blocked(torch, model, seed)
    with torch.no_grad():
        for p, v in zip(model.net_.state_dict().values(), states[1].values()):
            p.copy_(torch.from_numpy(v))

    steps = iter(range(SPACE_STEPS))

    def _draw(batch_size, generator):
        x = cut(space_draw(seed, next(steps), (batch_size, *LAT)))
        return x, model.prior.log_prob(x)

    model.fit._draw = _draw
    counters = {**_counters(), **slab_counters(), "accept_scan": accept_scan}
    runs = {}
    for path, fn in (("space fit", lambda: fit_protocol(model, SPACE_STEPS)),
                     ("space chain", lambda: model.mcmc.sample_chain(
                         SPACE_ROUNDS, BATCH))):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[path] = (out, time.perf_counter() - t0, {
            k: (c.launches, getattr(c, "tiled_launches", 0))
            for k, c in counters.items()})
    hist, chain = runs["space fit"][0], runs["space chain"][0]
    return dict(
        rank=dist.get_rank(), slab=(slab.rank, slab.row0, slab.rows),
        y_shape=tuple(y.shape), logq=logq.cpu().numpy(),
        logp=logp.cpu().numpy(), loss=list(hist["loss"]),
        chain_shape=tuple(chain["logq"].shape),
        chain_finite=bool(torch.isfinite(chain["logq"] - chain["logp"])
                          .all()),
        accept=chain["accept_rate"].cpu().numpy().tolist(),
        seconds={k: v[1] for k, v in runs.items()},
        counts={k: v[2] for k, v in runs.items()}, blocked=blocked)


def space_blocked(torch, model, seed):
    """The blocked sampler of a model under a space axis, whatever its
    process group (gloo here): for K = 4 and 16 blocks,
    ``sample__(SPACE_BLOCKED, n_blocks=K)`` from a seeded generator (its
    first call captures the start and the block step), the eager sweep on
    the same draws, and a warm call after ``reset()`` with the wrappers'
    counts set to 0 just before and read just after (a replay runs no
    wrapper).  Returns, for each K, the replayed and the eager samples,
    logq, logp and accepts (host numpy) and the warm call's wrapper
    counts."""
    bm = model.blocked_mcmc
    gen = torch.Generator(device="cuda")
    counters = _counters()
    out = {}
    for n_blocks in (4, 16):
        bm.reset()
        gen.manual_seed(seed + n_blocks)
        got = bm.sample__(SPACE_BLOCKED, n_blocks=n_blocks, generator=gen,
                          bookkeeping=True)
        accept = bm.history.accept_seq[-1]
        gen.manual_seed(seed + n_blocks)
        x, props, lrand = blocked_draws(model, SPACE_BLOCKED, n_blocks, gen)
        eager = bm.sweep(x, 0.0, False, props, lrand)
        bm.reset()
        reset_counts(counters)
        bm.sample__(SPACE_BLOCKED, n_blocks=n_blocks, generator=gen)
        torch.cuda.synchronize()
        out[n_blocks] = dict(
            graphed=[t.cpu().numpy() for t in got] + [accept],
            eager=[t.cpu().numpy().reshape(-1) if i == 3 else
                   t.cpu().numpy() for i, t in enumerate(eager)],
            warm_wrapper={k: c.launches for k, c in counters.items()})
    bm.reset()
    return out


def run_ranks(target, n, args, timeout):
    """``target(rank, *args, queue)`` in ``n`` spawned processes; their
    results in rank order.  Raises with a rank's traceback if one failed,
    and stops every process it started."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results, deadline = {}, time.perf_counter() + timeout
    try:
        while len(results) < n and time.perf_counter() < deadline:
            try:
                r, out = queue.get(timeout=1.0)
                results[r] = out
            except queue_mod.Empty:
                if any(p.exitcode for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == n else 1)
            if p.is_alive():
                p.kill()
                p.join()
    failed = {r: out[1] for r, out in results.items() if out[0]}
    failed.update({r: "no result" for r in range(n) if r not in results})
    if failed:
        raise AssertionError("the spawned ranks failed:" + "".join(
            f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
    return [results[r][1] for r in range(n)]


def run_space(torch, kernels, card):
    """Phase 21, step 2: the full-width flagship (``zoo.build_phi4_model()``,
    packed, its PSD block, seeded perturbed weights) over a 2-rank space
    group on the one card (:func:`space_rank`), held against the
    unsharded flagship on the card on the same fed draws: logq and logp of
    one batch of ``BATCH`` (``LOGQ_REL_TOL``, phase 4's bar against the
    CPU), and the loss of ``SPACE_STEPS`` eager steps of the bench protocol
    from the fresh seeded weights, as phase 5 trains (the perturbed ones
    make a float32 trajectory chaotic; ``SPACE_LOSS_TOL``, ``SPACE_FLOOR``);
    8 / 8 / 1 / 1 launches per step of
    ``rqs_coupling`` / ``rqs_coupling_bwd`` / ``phi4_action_slab`` /
    ``phi4_action_slab_grad`` on each rank, all tiled, and none of the
    whole-lattice action; ``sample_chain(SPACE_ROUNDS, BATCH)`` at 4 / 1 /
    1 per round; ``blocked_mcmc.sample__`` captured on each rank
    (:func:`space_blocked`) against its eager sweep, bit for bit, and the
    unsharded flagship's replays.  Rates are gloo-bound (every halo,
    gather and sum goes through the host), not a speed claim."""
    from normflow__tpu_torch.parallel import free_port
    from normflow__tpu_torch.tools.kernel_times import perturb_
    from normflow__tpu_torch.zoo import build_phi4_model

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SPACE_SEED)
    ref = build_phi4_model(LAT, seed=0)
    states = [{k: v.detach().cpu().numpy().copy()
               for k, v in ref.net_.state_dict().items()}]
    perturb_(ref.net_, rng)
    states.insert(0, {k: v.detach().cpu().numpy()
                      for k, v in ref.net_.state_dict().items()})
    t0 = time.perf_counter()
    ranks = run_ranks(space_rank, 2, (2, f"tcp://localhost:{free_port()}",
                                      space_run, (states, SPACE_SEED)),
                      SPACE_TIMEOUT)
    wall = time.perf_counter() - t0

    # the unsharded flagship on the card, on the same draws, eagerly
    x = torch.from_numpy(space_draw(SPACE_SEED, -1, (BATCH, *LAT))).cuda()
    y, logq, logp = ref.posterior.sample__(
        BATCH, preprocess_func=lambda _x, _l: (x, ref.prior.log_prob(x)))
    fits = {}
    for nudge in (1.0, 1.0 + 2.0 ** -23):  # the draws, then nudged by an ulp
        model = build_phi4_model(LAT, seed=0)  # the fresh weights
        steps = iter(range(SPACE_STEPS))

        def _draw(batch_size, generator, model=model, steps=steps,
                  nudge=nudge):
            xk = torch.from_numpy(space_draw(SPACE_SEED, next(steps),
                                             (batch_size, *LAT))).cuda()
            xk = xk * nudge
            return xk, model.prior.log_prob(xk)

        model.fit._draw = _draw
        model.fit.step_graph = lambda: None  # the eager body, as over gloo
        t0 = time.perf_counter()
        fits[nudge] = np.asarray(fit_protocol(model, SPACE_STEPS)["loss"])
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    want, nudged = fits.values()

    def rel(a, b):
        return np.abs(a - b) / np.maximum(1.0, np.abs(b))

    floor = float(rel(nudged, want).max())
    bar = max(SPACE_LOSS_TOL, SPACE_FLOOR * floor)
    print(f"unsharded eager fits on the card: the draws nudged by one "
          f"float32 ulp move the loss by up to {floor:.3e} relative over "
          f"{SPACE_STEPS} steps; the sharded fit's bar {bar:.3e}")

    n_layers = len(ref.net_[2].nets)
    per_unit = {
        "space fit": {"rqs_coupling": 2 * n_layers,
                      "rqs_coupling_bwd": 2 * n_layers,
                      "phi4_action_slab": 1, "phi4_action_slab_grad": 1},
        "space chain": {"rqs_coupling": n_layers, "phi4_action_slab": 1,
                        "accept_scan": 1}}
    units = {"space fit": SPACE_STEPS, "space chain": SPACE_ROUNDS}
    lq, lp = logq.cpu().numpy(), logp.cpu().numpy()
    for r in ranks:
        rel_q = float(np.max(np.abs(r["logq"] - lq)
                             / np.maximum(1.0, np.abs(lq))))
        rel_p = float(np.max(np.abs(r["logp"] - lp)
                             / np.maximum(1.0, np.abs(lp))))
        loss = np.asarray(r["loss"]) if r["rank"] == 0 else want
        dloss, dfirst = float(rel(loss, want).max()), float(rel(loss, want)[0])
        print(f"space rank {r['rank']} (slab rank, first row, rows "
              f"{r['slab']}): sample__ {r['y_shape']}; logq max rel "
              f"{rel_q:.3e}, logp max rel {rel_p:.3e} against the unsharded "
              f"flagship on the card (tol {LOGQ_REL_TOL}); loss of step 1 "
              f"rel {dfirst:.3e} (tol {LOGQ_REL_TOL}), over {SPACE_STEPS} "
              f"steps max rel {dloss:.3e} (tol {bar:.3e}); chain "
              f"{r['chain_shape']} accept {r['accept']}")
        if not (rel_q <= LOGQ_REL_TOL and rel_p <= LOGQ_REL_TOL
                and dfirst <= LOGQ_REL_TOL and dloss <= bar
                and r["y_shape"] == (BATCH, *LAT)
                and r["chain_shape"] == (SPACE_ROUNDS, BATCH)
                and r["chain_finite"]):
            raise AssertionError("the space-sharded flagship departs from "
                                 "the unsharded one")
        for path, want_per in per_unit.items():
            got = {k: v for k, v in r["counts"][path].items() if v[0]}
            wanted = {k: (v * units[path],
                          v * units[path] if k != "accept_scan" else 0)
                      for k, v in want_per.items()}
            print(f"  {path}: launches by wrapper (launches, tiled) {got}, "
                  f"want {wanted}")
            if got != wanted:
                raise AssertionError(f"{path}: wrapper launches {got}, want "
                                     f"{wanted}")
    half = SPACE_STEPS // 2
    first, last = float(want[:half].mean()), float(want[-half:].mean())
    if not np.isfinite(want).all() or not last < first:
        raise AssertionError("the reference fit's loss is not falling")
    for path, want_per in per_unit.items():
        for k in want_per:
            kernels[k].setdefault("launches_by_path", {})[path] = sum(
                r["counts"][path][k][0] for r in ranks)
    for r in ranks:
        s = r["seconds"]
        print(f"space rank {r['rank']}: {SPACE_STEPS / s['space fit']:.2f} "
              f"eager steps/s at batch {TRAIN_BATCH}, "
              f"{SPACE_ROUNDS * BATCH / s['space chain']:.1f} chain "
              f"proposals/s (gloo through the host: not a speed claim) on "
              f"{card}")
    # the blocked sampler: replayed against eager on each rank, and
    # against the unsharded flagship's replays on the same draws
    gen = torch.Generator(device="cuda")
    for n_blocks in (4, 16):
        ref.blocked_mcmc.reset()
        gen.manual_seed(SPACE_SEED + n_blocks)
        want_b = [t.cpu().numpy() for t in ref.blocked_mcmc.sample__(
            SPACE_BLOCKED, n_blocks=n_blocks, generator=gen,
            bookkeeping=True)] + [ref.blocked_mcmc.history.accept_seq[-1]]
        for r in ranks:
            got_b = r["blocked"][n_blocks]
            same_eager = all(np.array_equal(a, b) for a, b in
                             zip(got_b["graphed"], got_b["eager"]))
            same_ref = all(np.array_equal(a, b) for a, b in
                           zip(got_b["graphed"], want_b))
            dq = max(float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
                     for a, b in zip(got_b["graphed"][1:3], want_b[1:3]))
            warm = got_b["warm_wrapper"]
            print(f"space rank {r['rank']}: blocked_mcmc.sample__("
                  f"{SPACE_BLOCKED}, n_blocks={n_blocks}) captured over gloo,"
                  f" replayed vs the eager sweep on the same draws "
                  f"{'bit for bit' if same_eager else 'NOT bit-identical'};"
                  f" vs the unsharded flagship's replays "
                  f"{'bit for bit' if same_ref else 'NOT bit-identical'} "
                  f"(logq, logp max rel {dq:.3e}, tol {LOGQ_REL_TOL}; "
                  f"accepts {'equal' if np.array_equal(got_b['graphed'][3], want_b[3]) else 'DIFFER'}); "
                  f"a warm call's wrapper launches {warm} (want none)")
            if not (same_eager and dq <= LOGQ_REL_TOL
                    and np.array_equal(got_b["graphed"][3], want_b[3])
                    and not any(warm.values())):
                raise AssertionError("the blocked sampler under a space axis "
                                     "departs from its eager sweep or from "
                                     "the unsharded flagship, or does not "
                                     "replay")
    ref.blocked_mcmc.reset()
    print(f"unsharded eager reference: {SPACE_STEPS / ref_s:.2f} steps/s; the "
          f"two ranks' processes {wall:.1f} s wall, start-up included")
    run_space3(torch, kernels, card, ref, states, want, nudged)
    print(f"phase 21 {time.perf_counter() - t_phase:.1f} s on {card}")


SPACE3_AXES = {"data": 1, "space": 3}  # 32 rows: slabs of 11, 11 and 10
SPACE3_ROWS = [(0, 11), (11, 11), (22, 10)]
SPACE3_STEPS = 8  # eager steps of the bench protocol on the 3-rank mesh
SPACE3_ROUNDS = 3  # sample_chain(SPACE3_ROUNDS, BATCH) on fed rounds


def space3_round(seed, k):
    """Chain round ``k`` of phase 21's 3-rank step: the prior's draw and
    the log uniforms, the same numpy numbers in every process."""
    rng = np.random.default_rng([seed, 1000 + k])
    return (rng.standard_normal((BATCH, *LAT)).astype(np.float32),
            np.log(rng.random(BATCH)).astype(np.float32))


def space3_run(torch, states, seed):
    """The full-width flagship on ``SPACE3_AXES`` (one of three ranks):
    this rank's slab of the fed batch through ``posterior.sample__`` and
    ``sample_chain(SPACE3_ROUNDS, BATCH, bookkeeping=True)`` on fed rounds
    with the perturbed weights ``states[0]``, then ``SPACE3_STEPS`` eager
    steps of the bench protocol on fed draws from the fresh weights
    ``states[1]``, each with every launch counter set to 0 just before and
    read just after."""
    import torch.distributed as dist

    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan
    from normflow__tpu_torch.zoo import build_phi4_model

    torch.set_num_threads(1)  # three processes share the host's cores
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_phi4_model(LAT, seed=0)
    model.net_.load_state_dict({k: torch.from_numpy(v)
                                for k, v in states[0].items()})
    dh = model.device_handler
    dh.use_mesh(axes=SPACE3_AXES)
    dh.replicate_params()
    slab = dh.slab
    if dh.captures():
        raise AssertionError("the three-process step must run eagerly")

    def cut(a):
        rows = a[:, slab.row0:slab.row0 + slab.rows]
        return torch.from_numpy(np.ascontiguousarray(rows)).cuda()

    rounds = iter(range(SPACE3_ROUNDS))

    def _draws(batch_size, generator):
        x, lrand = space3_round(seed, next(rounds))
        x = cut(x)
        return x, model.prior.log_prob(x), torch.from_numpy(lrand).cuda()

    model.mcmc._draws = _draws
    steps = iter(range(SPACE3_STEPS))

    def _draw(batch_size, generator):
        x = cut(space_draw(seed, next(steps), (batch_size, *LAT)))
        return x, model.prior.log_prob(x)

    model.fit._draw = _draw
    xs = cut(space_draw(seed, -1, (BATCH, *LAT)))

    def fit():
        with torch.no_grad():
            for p, v in zip(model.net_.state_dict().values(),
                            states[1].values()):
                p.copy_(torch.from_numpy(v))
        return fit_protocol(model, SPACE3_STEPS)

    counters = {**_counters(), **slab_counters(), "accept_scan": accept_scan}
    runs = {}
    for path, fn in (
            ("space3 sample", lambda: model.posterior.sample__(
                BATCH, preprocess_func=lambda x, logr: (
                    xs, model.prior.log_prob(xs)))),
            ("space3 chain", lambda: model.mcmc.sample_chain(
                SPACE3_ROUNDS, BATCH, bookkeeping=True)),
            ("space3 fit", fit)):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[path] = (out, time.perf_counter() - t0, {
            k: (c.launches, getattr(c, "tiled_launches", 0))
            for k, c in counters.items()})
    y, logq, logp = runs["space3 sample"][0]
    chain, h = runs["space3 chain"][0], model.mcmc.history
    return dict(
        rank=dist.get_rank(), slab=(slab.row0, slab.rows),
        y_shape=tuple(y.shape), logq=logq.cpu().numpy(),
        logp=logp.cpu().numpy(), loss=list(runs["space3 fit"][0]["loss"]),
        chain={k: chain[k].cpu().numpy() for k in ("logq", "logp")},
        raw=[np.asarray(a) for a in (h.raw_logq, h.raw_logp, h.accept_seq)],
        seconds={k: v[1] for k, v in runs.items()},
        counts={k: v[2] for k, v in runs.items()})


def plain_chain(torch, raw_logq, raw_logp, lrand):
    """The accept decisions of a fresh chain through the rounds' proposals
    (``raw_logq``, ``raw_logp``, ``lrand``, each ``(rounds, B)`` float32),
    by the plain recurrence on the CPU
    (``mcmc.metropolis.accept_reject``): ``(accept sequences, corrected
    logq, corrected logp)``."""
    from normflow__tpu_torch.mcmc.metropolis import accept_reject

    ref = (torch.zeros(1), torch.tensor(math.inf), torch.tensor(0.0))
    seqs, lqs, lps = [], [], []
    for lq, lp, lr in zip(raw_logq, raw_logp, lrand):
        lq, lp, lr = (torch.from_numpy(np.asarray(a)) for a in (lq, lp, lr))
        y = torch.zeros(len(lq), 1)
        y, lqn, lpn, accept = accept_reject(y, lq, lp, lr, ref)
        ref = (y[-1], lqn[-1], lpn[-1])
        seqs.append(accept.numpy())
        lqs.append(lqn.numpy())
        lps.append(lpn.numpy())
    return np.stack(seqs), np.stack(lqs), np.stack(lps)


def run_space3(torch, kernels, card, ref, states, want, nudged):
    """Phase 21, step 3: the full-width packed flagship with its PSD block
    over three gloo processes on the one card, ``SPACE3_AXES``: the 32 rows
    split as XLA splits them, 11 / 11 / 10 (odd heights; the second slab
    starts at an odd row), held against the unsharded flagship ``ref`` on
    the card (the perturbed weights ``states[0]``): logq and logp of the
    fed batch of ``BATCH`` (``LOGQ_REL_TOL``); the chain's proposals
    (``sample_chain``'s raw streams on fed rounds) against ``ref``'s eager
    rounds on the same draws (``LOGQ_REL_TOL``), and its accept decisions
    and corrected streams bit for bit against the plain recurrence on its
    own proposals (two float32 sums of the same proposal in another order
    may fall on either side of a uniform, so the unsharded chain's decisions
    are printed, not held); ``SPACE3_STEPS`` eager steps of the bench
    protocol from the fresh weights ``states[1]`` against the first steps
    of the unsharded eager fit ``want`` (its bar from the ulp-nudged fit
    ``nudged`` over those steps, as in step 2).  Each wrapper's launches
    per batch, round and step, with the variant each took: the couplings
    tiled (176 and 160 sites a sample), the slab kernels general."""
    from normflow__tpu_torch.parallel import free_port

    t0 = time.perf_counter()
    n = SPACE3_AXES["space"]
    ranks = run_ranks(space_rank, n, (n, f"tcp://localhost:{free_port()}",
                                      space3_run, (states, SPACE_SEED)),
                      SPACE_TIMEOUT)
    wall = time.perf_counter() - t0

    # the unsharded flagship's eager rounds on the same draws
    draws = [space3_round(SPACE_SEED, k) for k in range(SPACE3_ROUNDS)]
    it = iter(draws)

    def _draws(batch_size, generator):
        x, lrand = (torch.from_numpy(a).cuda() for a in next(it))
        return x, ref.prior.log_prob(x), lrand

    mcmc, dh = ref.mcmc, ref.device_handler
    mcmc._ref, mcmc._draws, dh.captures = None, _draws, lambda: False
    try:
        mcmc.history.reset_history()
        want_chain = mcmc.sample_chain(SPACE3_ROUNDS, BATCH, bookkeeping=True)
        want_raw = [np.asarray(a) for a in (mcmc.history.raw_logq,
                                            mcmc.history.raw_logp,
                                            mcmc.history.accept_seq)]
    finally:
        del mcmc._draws, dh.captures
        mcmc._ref = None
    x = torch.from_numpy(space_draw(SPACE_SEED, -1, (BATCH, *LAT))).cuda()
    _, logq, logp = ref.posterior.sample__(
        BATCH, preprocess_func=lambda _x, _l: (x, ref.prior.log_prob(x)))
    lq, lp = logq.cpu().numpy(), logp.cpu().numpy()

    def rel(a, b):
        return np.abs(a - b) / np.maximum(1.0, np.abs(b))

    floor = float(rel(nudged[:SPACE3_STEPS], want[:SPACE3_STEPS]).max())
    bar = max(SPACE_LOSS_TOL, SPACE_FLOOR * floor)
    lrand = np.stack([d[1] for d in draws])
    n_layers = len(ref.net_[2].nets)
    per_unit = {
        "space3 sample": {"rqs_coupling": n_layers, "phi4_action_slab": 1},
        "space3 chain": {"rqs_coupling": n_layers, "phi4_action_slab": 1,
                         "accept_scan": 1},
        "space3 fit": {"rqs_coupling": 2 * n_layers,
                       "rqs_coupling_bwd": 2 * n_layers,
                       "phi4_action_slab": 1, "phi4_action_slab_grad": 1}}
    units = {"space3 sample": 1, "space3 chain": SPACE3_ROUNDS,
             "space3 fit": SPACE3_STEPS}
    # the couplings tiled, the slab kernels general (no tile at 11 or 10
    # rows), accept_scan has one variant
    tiled = ("rqs_coupling", "rqs_coupling_bwd")
    for r in ranks:
        raw_q, raw_p, seq = r["raw"]
        rel_q, rel_p = (float(rel(a, b).max()) for a, b in
                        ((r["logq"], lq), (r["logp"], lp)))
        raw_rel = max(float(rel(a, b).max()) for a, b in
                      ((raw_q, want_raw[0]), (raw_p, want_raw[1])))
        p_seq, p_lq, p_lp = plain_chain(torch, raw_q, raw_p, lrand)
        plain_same = (np.array_equal(seq, p_seq)
                      and np.array_equal(r["chain"]["logq"], p_lq)
                      and np.array_equal(r["chain"]["logp"], p_lp))
        flips = int((seq != want_raw[2]).sum())
        loss = np.asarray(r["loss"]) if r["rank"] == 0 \
            else want[:SPACE3_STEPS]
        dloss = rel(loss, want[:SPACE3_STEPS])
        print(f"3 space ranks, rank {r['rank']} (first row, rows "
              f"{r['slab']}): sample__ {r['y_shape']}; logq max rel "
              f"{rel_q:.3e}, logp max rel {rel_p:.3e} against the unsharded "
              f"flagship on the card (tol {LOGQ_REL_TOL}); chain proposals "
              f"max rel {raw_rel:.3e} against the unsharded rounds (tol "
              f"{LOGQ_REL_TOL}); accept decisions and corrected streams vs "
              f"the plain recurrence on its proposals "
              f"{'bit for bit' if plain_same else 'DIFFER'}; decisions unlike "
              f"the unsharded chain's: {flips} of {seq.size} (accept "
              f"{[round(float(a), 5) for a in seq.mean(1)]}, unsharded "
              f"{[round(float(a), 5) for a in want_raw[2].mean(1)]}); loss of "
              f"step 1 rel {float(dloss[0]):.3e} (tol {LOGQ_REL_TOL}), over "
              f"{SPACE3_STEPS} steps max rel {float(dloss.max()):.3e} (tol "
              f"{bar:.3e})")
        if not (r["slab"] == SPACE3_ROWS[r["rank"]]
                and r["y_shape"] == (BATCH, *LAT) and rel_q <= LOGQ_REL_TOL
                and rel_p <= LOGQ_REL_TOL and raw_rel <= LOGQ_REL_TOL
                and plain_same and dloss[0] <= LOGQ_REL_TOL
                and dloss.max() <= bar):
            raise AssertionError("the flagship over three space ranks "
                                 "departs from the unsharded one")
        for path, want_per in per_unit.items():
            got = {k: v for k, v in r["counts"][path].items() if v[0]}
            wanted = {k: (v * units[path],
                          v * units[path] if k in tiled else 0)
                      for k, v in want_per.items()}
            print(f"  {path}: launches by wrapper (launches, tiled) {got}, "
                  f"want {wanted}")
            if got != wanted:
                raise AssertionError(f"{path}: wrapper launches {got}, want "
                                     f"{wanted}")
    for path, want_per in per_unit.items():
        for k in want_per:
            kernels[k].setdefault("launches_by_path", {})[path] = sum(
                r["counts"][path][k][0] for r in ranks)
    s = ranks[0]["seconds"]
    rate = SPACE3_ROUNDS * BATCH / s["space3 chain"]
    print(f"3 space ranks: {SPACE3_STEPS / s['space3 fit']:.2f} eager steps/s "
          f"at batch {TRAIN_BATCH}, {rate:.1f} chain proposals/s (gloo "
          f"through the host: not a speed claim); the processes {wall:.1f} s "
          f"wall, start-up included, on {card}")
    del want_chain


# --------------------------------------------------------------------- #
# Phase 25: every training loss over two data ranks on the one card
# --------------------------------------------------------------------- #
LOSS_NAMES = ("calc_kl_mean", "calc_kl_var", "calc_corrcoef",
              "calc_direct_kl_mean", "calc_kl_mean_includelogz",
              "calc_least_squares", "calc_minus_logz", "calc_minus_ess")
LOSSES_SEED = 20261025
# calc_kl_mean's step by the gather route against the route the port took
# until now (each rank's mean, the loss and gradients averaged over the
# ranks), in one process under cuDNN's deterministic algorithms: the
# per-sample cotangents differ by a factor of 2 (exact), so the gradients
# agree bit for bit; the loss is a float32 mean of 512 values in another
# order, a few ulps apart.  The bar for both, relative (|dg| / |g| per
# leaf): FLAT_ROUTE_TOL.
FLAT_ROUTE_TOL = 1e-6
# each loss's sharded step against the unsharded float32 step on the card,
# the loss and each gradient leaf, relative: SHARDED_STEP_TOL.  The two
# steps take the same global batch through the same kernels, and differ
# only where the flow's reductions run at batch 256 in place of 512: loss
# rel 0 and leaves <= 2.036e-05 over the eight losses on an H100 80GB HBM3
# at 700 W.  The local route of calc_minus_ess (each rank's -ESS of its own
# samples, averaged) must exceed it
SHARDED_STEP_TOL = 1e-4
LOCAL_ROUTES = ("calc_kl_mean", "calc_minus_ess")


def losses_run(torch, seed):
    """One of phase 25's two processes under ``{"data": 2}``: the fresh
    seeded flagship, this rank's half of the fed global batch of
    ``TRAIN_BATCH``, one step's loss and gradients for each loss of
    ``LOSS_NAMES`` as the training step takes them (``Fitter.loss_of``,
    which gathers logq and logp over the data ranks, ``torch.autograd.
    grad``, ``ModelDeviceHandler.reduce_step``), then ``calc_kl_mean`` by
    the flat-mean route, with the launch counters set to 0 before the
    steps and read after them."""
    import torch.distributed as dist

    from normflow__tpu_torch.training import losses
    from normflow__tpu_torch.zoo import build_phi4_model

    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = build_phi4_model(LAT, seed=0)
    dh = model.device_handler
    dh.use_mesh(axes={"data": 2})
    dh.replicate_params()
    half = TRAIN_BATCH // 2
    x = space_draw(seed, 0, (TRAIN_BATCH, *LAT))
    x = torch.from_numpy(x[dh.data_rank * half:(dh.data_rank + 1) * half])
    x = x.cuda()
    params = list(model.net_.parameters())
    fit = model.fit
    fit.grad_estimator = "rep"
    counters = _counters()
    reset_counts(counters)
    out = {}
    for name in LOSS_NAMES:
        fit.loss_fn = getattr(losses, name)
        loss, _, _ = fit.loss_of(x, model.prior.log_prob(x))
        grads = dh.reduce_step(torch.autograd.grad(loss, params))
        out[name] = (float(loss.detach()),
                     [g.double().cpu().numpy() for g in grads])
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.tiled_launches) for k, c in counters.items()}
    # the local route, the port's route until now: each rank's loss of its
    # own samples, the loss and gradients averaged over the ranks.  It is
    # calc_kl_mean's flat-mean route, and for calc_minus_ess the control
    # that the gate on the unsharded step must refuse
    for name in LOCAL_ROUTES:
        with dh.sharded():
            y, logj = model.net_.forward(x)
            local = getattr(losses, name)(model.prior.log_prob(x) - logj,
                                          -model.action(y))
        grads = torch.autograd.grad(local, params)
        flat = torch.cat([local.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat = (flat / 2).double().cpu()
        sizes = [1] + [p.numel() for p in params]
        out[f"{name} local"] = (float(flat[0]), [
            g.reshape(p.shape).numpy()
            for g, p in zip(flat.split(sizes)[1:], params)])
    return dict(rank=dist.get_rank(), steps=out, counts=counts)


def loss_steps(torch, dtype, device):
    """Each loss of ``LOSS_NAMES``: one step of the fresh seeded flagship
    on phase 25's whole global batch, unsharded, in ``dtype`` on
    ``device``: ``{name: (loss, gradients as float64 CPU tensors)}``."""
    from normflow__tpu_torch.training import losses
    from normflow__tpu_torch.zoo import build_phi4_model

    x = space_draw(LOSSES_SEED, 0, (TRAIN_BATCH, *LAT))
    m = build_phi4_model(LAT, seed=0, dtype=dtype, device=device)
    m.fit.grad_estimator = "rep"
    params = list(m.net_.parameters())
    xd = torch.tensor(x, dtype=dtype, device=m.device)
    _, logq, logp = m.fit.loss_of(xd, m.prior.log_prob(xd))
    out = {}
    for name in LOSS_NAMES:
        loss = getattr(losses, name)(logq, logp)
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        out[name] = (float(loss.detach()), [g.double().cpu() for g in grads])
    return out


def run_losses(torch, kernels, card):
    """Phase 25: every loss of ``training/losses.py`` (``LOSS_NAMES``;
    ``calc_ess`` is a metric) over two data ranks, two gloo processes on
    the one card (:func:`losses_run`), one eager step of the full-width
    flagship at the global batch ``TRAIN_BATCH`` on fed draws each, held
    against the unsharded eager step on the card on the same global batch
    with phase 5's float64-anchored bars: the loss within the larger of
    ``TRAIN_LOSS_TOL`` and ``FLOOR_FACTOR`` times the unsharded step's own
    distance from a float64 CPU copy, each gradient leaf's ``|dg| / |g|``
    from float64 within the larger of ``TRAIN_GRAD_TOL`` and
    ``FLOOR_FACTOR`` times the unsharded step's; both ranks' steps bit for
    bit alike; ``calc_kl_mean`` within ``FLAT_ROUTE_TOL`` of the flat-mean
    route; 4 / 4 / 1 / 1 wrapper launches a step of ``rqs_coupling`` /
    ``rqs_coupling_bwd`` / ``phi4_action`` / ``phi4_action_grad``.
    Each sharded step is also held against the unsharded step on the card
    within ``SHARDED_STEP_TOL``, which ``calc_minus_ess``'s local route
    must exceed.  The float64 CPU copy's :func:`loss_steps` runs in a
    thread beside the two ranks' processes, which time nothing, and is
    joined before the phase ends, so it shares the host with no timed
    window."""
    from normflow__tpu_torch.parallel import free_port

    t_phase = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu64 = pool.submit(lambda: (loss_steps(torch, torch.float64, "cpu"),
                                     time.perf_counter() - t_phase))
        ranks = run_ranks(space_rank, 2,
                          (2, f"tcp://localhost:{free_port()}", losses_run,
                           (LOSSES_SEED,)), SPACE_TIMEOUT)
        wall = time.perf_counter() - t_phase
        gpu = loss_steps(torch, torch.float32, "cuda")
        ref, t_copy = cpu64.result()
    ref = {"cpu64": ref, "gpu": gpu}
    print(f"phase 25: the ranks' processes ended at {wall:.1f} s, the "
          f"float64 CPU copy at {t_copy:.1f} s of the phase")

    def rel(step, want):
        loss = abs(step[0] - want[0]) / max(1.0, abs(want[0]))
        pairs = [(torch.as_tensor(p), torch.as_tensor(q))
                 for p, q in zip(step[1], want[1])]
        return loss, [float((p - q).norm()) / max(float(q.norm()), 1e-30)
                      for p, q in pairs]

    r0, r1 = (r["steps"] for r in ranks)
    for name in LOSS_NAMES:
        u_loss, u_leaves = rel(ref["gpu"][name], ref["cpu64"][name])
        s_loss, s_leaves = rel(r0[name], ref["cpu64"][name])
        su_loss, su_leaves = rel(r0[name], ref["gpu"][name])
        loss_bar = max(TRAIN_LOSS_TOL, FLOOR_FACTOR * u_loss)
        bars = [max(TRAIN_GRAD_TOL, FLOOR_FACTOR * u) for u in u_leaves]
        alike = r0[name][0] == r1[name][0] and all(
            np.array_equal(a, b) for a, b in zip(r0[name][1], r1[name][1]))
        ok = (s_loss <= loss_bar and alike
              and all(s <= b for s, b in zip(s_leaves, bars))
              and max(su_loss, *su_leaves) <= SHARDED_STEP_TOL)
        print(f"{name} over 2 data ranks: loss {r0[name][0]:.6f} (unsharded "
              f"{ref['gpu'][name][0]:.6f}, float64 "
              f"{ref['cpu64'][name][0]:.6f}); vs float64 loss rel "
              f"{s_loss:.3e} (bar {loss_bar:.3e}), |dg|/|g| per leaf max "
              f"{max(s_leaves):.3e} (unsharded {max(u_leaves):.3e}, bars "
              f"{min(bars):.1e}-{max(bars):.1e}); vs the unsharded step loss "
              f"rel {su_loss:.3e}, leaves max {max(su_leaves):.3e} (tol "
              f"{SHARDED_STEP_TOL:g}); ranks "
              f"{'alike bit for bit' if alike else 'DIFFER'}: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{name} over two data ranks departs from "
                                 "the unsharded step")
    c_loss, c_leaves = rel(r0["calc_minus_ess local"],
                           ref["gpu"]["calc_minus_ess"])
    print(f"control: calc_minus_ess by the local route (each rank's -ESS of "
          f"its own samples, averaged) vs the unsharded step: loss rel "
          f"{c_loss:.3e}, leaves max {max(c_leaves):.3e} (must exceed "
          f"{SHARDED_STEP_TOL:g})")
    if max(c_loss, *c_leaves) <= SHARDED_STEP_TOL:
        raise AssertionError("the gate on the unsharded step passes "
                             "calc_minus_ess's local route")
    flat_loss, flat_leaves = rel(r0["calc_kl_mean local"],
                                 r0["calc_kl_mean"])
    same = all(np.array_equal(a, b) for a, b in
               zip(r0["calc_kl_mean local"][1], r0["calc_kl_mean"][1]))
    print(f"calc_kl_mean by the gather route vs the flat-mean route: loss "
          f"rel {flat_loss:.3e}, |dg|/|g| per leaf max {max(flat_leaves):.3e}"
          f" (tol {FLAT_ROUTE_TOL}); gradients "
          f"{'bit for bit' if same else 'not bit-identical'}")
    if not (flat_loss <= FLAT_ROUTE_TOL
            and max(flat_leaves) <= FLAT_ROUTE_TOL):
        raise AssertionError("calc_kl_mean's gather route departs from its "
                             "flat-mean route")
    n_steps, n_layers = len(LOSS_NAMES), 4
    want = {"rqs_coupling": (n_layers * n_steps,) * 2,
            "rqs_coupling_bwd": (n_layers * n_steps,) * 2,
            "phi4_action": (n_steps, n_steps),
            "phi4_action_grad": (n_steps, n_steps)}
    for r in ranks:
        print(f"  data rank {r['rank']}: {n_steps} steps' wrapper launches "
              f"(launches, tiled) {r['counts']}, want {want}")
        if r["counts"] != want:
            raise AssertionError(f"phase 25's wrapper launches {r['counts']}"
                                 f", want {want}")
    for k, v in want.items():
        kernels[k].setdefault("launches_by_path", {})["losses"] = 2 * v[0]
    print(f"phase 25: the two ranks' processes {wall:.1f} s wall, start-up "
          f"included; {time.perf_counter() - t_phase:.1f} s on {card}")


# --------------------------------------------------------------------- #
# Phase 26: the 8^4 flagship over two space ranks on the one card
# --------------------------------------------------------------------- #
SPACE4_SEED = 20261026
SPACE4_BATCH = 128  # the global batch of the batch, the round and the steps
SPACE4_STEPS = 2    # eager steps of the bench protocol at LAT4_LR
SPACE4_TIMEOUT = 300.0  # seconds the parent waits for the two ranks


def space4_round(seed):
    """Phase 26's chain round: the prior's draw and the log uniforms, the
    same numpy numbers in every process."""
    rng = np.random.default_rng([seed, 2000])
    return (rng.standard_normal((SPACE4_BATCH, *LAT4)).astype(np.float32),
            np.log(rng.random(SPACE4_BATCH)).astype(np.float32))


def space4_feed(torch, model, seed, cut):
    """Feed ``model`` phase 26's numpy draws, each through ``cut`` (a
    rank's slab, or the whole lattice): its sampler the round of
    :func:`space4_round`, its fitter draw ``k`` of :func:`space_draw` at
    step ``k``.  Returns the batch's draw and the first step's."""
    x_round, lrand = space4_round(seed)

    def _draws(batch_size, generator):
        x = cut(x_round)
        return x, model.prior.log_prob(x), torch.from_numpy(lrand).cuda()

    steps = iter(range(SPACE4_STEPS))

    def _draw(batch_size, generator):
        x = cut(space_draw(seed, next(steps), (batch_size, *LAT4)))
        return x, model.prior.log_prob(x)

    model.mcmc._draws, model.fit._draw = _draws, _draw
    return (cut(space_draw(seed, -1, (SPACE4_BATCH, *LAT4))),
            cut(space_draw(seed, 0, (SPACE4_BATCH, *LAT4))))


def space4_grads(torch, model, x0):
    """The path-gradient loss and gradients of ``model`` at the draw
    ``x0`` as the training step takes them (``Fitter.loss_of``,
    ``torch.autograd.grad``, and over a group
    ``ModelDeviceHandler.reduce_step``): ``(loss, [float64 numpy
    leaves])``."""
    dh = model.device_handler
    fit = model.fit
    fit.grad_estimator = "path"
    with dh.sharded():
        loss, _, _ = fit.loss_of(x0, model.prior.log_prob(x0))
    g = torch.autograd.grad(loss, list(model.net_.parameters()))
    if dh.group is not None:
        g = dh.reduce_step(g)
    return float(loss.detach()), [t.double().cpu().numpy() for t in g]


def space4_paths(torch, model, seed, cut):
    """Phase 26's runs of ``model`` (sharded or not) on its fed draws
    (:func:`space4_feed`), in order: ``posterior.sample__(SPACE4_BATCH)``;
    ``sample_chain(1, SPACE4_BATCH, bookkeeping=True)``; the path-gradient
    loss and gradients of the first step's draw as the training step takes
    them (``Fitter.loss_of``, ``torch.autograd.grad``, and over the group
    ``ModelDeviceHandler.reduce_step``); ``SPACE4_STEPS`` eager steps of
    the bench protocol at ``LAT4_LR``.  Each with every launch counter set
    to 0 just before and read just after: ``{path: (output, seconds,
    {wrapper: (launches, tiled)})}``."""
    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan

    xs, x0 = space4_feed(torch, model, seed, cut)
    counters = {**_counters(), **slab_counters(), "accept_scan": accept_scan}
    runs = {}
    for path, fn in (
            ("space4 sample", lambda: model.posterior.sample__(
                SPACE4_BATCH, preprocess_func=lambda x, logr: (
                    xs, model.prior.log_prob(xs)))),
            ("space4 chain", lambda: model.mcmc.sample_chain(
                1, SPACE4_BATCH, bookkeeping=True)),
            ("space4 grads", lambda: space4_grads(torch, model, x0)),
            ("space4 fit", lambda: fit_protocol(
                model, SPACE4_STEPS, lr=LAT4_LR, decay_steps=SPACE4_STEPS,
                batch=SPACE4_BATCH))):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[path] = (out, time.perf_counter() - t0, {
            k: (c.launches, getattr(c, "tiled_launches", 0))
            for k, c in counters.items()})
    return runs


def space4_result(runs, history):
    """What the parent holds of :func:`space4_paths`' runs, as numpy."""
    _, logq, logp = runs["space4 sample"][0]
    chain = runs["space4 chain"][0]
    return dict(
        y_shape=tuple(runs["space4 sample"][0][0].shape),
        logq=logq.cpu().numpy(), logp=logp.cpu().numpy(),
        raw=[np.asarray(a) for a in (history.raw_logq, history.raw_logp,
                                     history.accept_seq)],
        chain={k: chain[k].cpu().numpy() for k in ("logq", "logp")},
        grads=runs["space4 grads"][0],
        loss=list(runs["space4 fit"][0]["loss"]),
        seconds={k: v[1] for k, v in runs.items()},
        counts={k: v[2] for k, v in runs.items()})


def space4_run(torch, state, seed):
    """One of phase 26's two processes under ``SPACE_AXES``: the 8^4
    flagship (``build_phi4_model(LAT4, packed=False)``) with phase 23's
    perturbed weights ``state``, this rank's slab of the fed draws through
    :func:`space4_paths`."""
    import torch.distributed as dist

    from normflow__tpu_torch.zoo import build_phi4_model

    torch.set_num_threads(1)  # two processes share the host's cores
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_phi4_model(LAT4, packed=False, seed=0)
    model.net_.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()})
    dh = model.device_handler
    dh.use_mesh(axes=SPACE_AXES)
    dh.replicate_params()
    slab = dh.slab
    if dist.get_backend(dh.group) != "gloo" or dh.captures():
        raise AssertionError("the two-process phase must run eagerly over "
                             "gloo")

    def cut(a):
        rows = a[:, slab.row0:slab.row0 + slab.rows]
        return torch.from_numpy(np.ascontiguousarray(rows)).cuda()

    runs = space4_paths(torch, model, seed, cut)
    return dict(space4_result(runs, model.mcmc.history),
                rank=dist.get_rank(), slab=(slab.row0, slab.rows))


def run_space4(torch, kernels, card, state):
    """Phase 26: the 8^4 flagship over two space ranks, two gloo processes
    on the one card (phase 21's :func:`space_rank`), ``{"data": 1,
    "space": 2}``, each rank a slab of (4, 8, 8, 8) rows, eager, with phase
    23's perturbed weights ``state``: :func:`space4_paths` at the global
    batch ``SPACE4_BATCH`` on fed numpy draws, held against the unsharded
    8^4 flagship on the card on the same draws, eager too, with phase 21's
    bars: logq and logp of the batch and the chain's proposals
    (``LOGQ_REL_TOL``); the chain's accept decisions equal to the
    unsharded chain's, and with its corrected streams bit for bit those of
    the plain recurrence on its own proposals; the first step's loss
    (``LOGQ_REL_TOL``) and every gradient leaf (``|dg| / |g|`` within the
    larger of ``SPACE_LOSS_TOL`` and ``SPACE_FLOOR`` times the unsharded
    gradient's own move when the draw is nudged by one float32 ulp, as
    phase 21 bars the loss: a leaf whose terms cancel carries float32's
    reordering far), alike bit for bit on both ranks; the
    ``SPACE4_STEPS`` steps' losses (step 1 ``LOGQ_REL_TOL``, then
    ``SPACE_LOSS_TOL``).  Each wrapper's launches per batch, round, step
    and gradient, every slab launch to the tiled nd slab kernels and every
    coupling to the tiled coupling kernels."""
    from normflow__tpu_torch.parallel import free_port
    from normflow__tpu_torch.zoo import build_phi4_model

    t_phase = time.perf_counter()
    ranks = run_ranks(space_rank, 2, (2, f"tcp://localhost:{free_port()}",
                                      space4_run, (state, SPACE4_SEED)),
                      SPACE4_TIMEOUT)
    wall = time.perf_counter() - t_phase

    ref = build_phi4_model(LAT4, packed=False, seed=0)
    ref.net_.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
    ref.device_handler.captures = lambda: False  # eager, as over gloo
    # the unsharded gradient's own spread: the first step's draw nudged by
    # one float32 ulp (phase 21's floor, per leaf)
    x0 = torch.from_numpy(space_draw(SPACE4_SEED, 0,
                                     (SPACE4_BATCH, *LAT4))).cuda()
    nudged = space4_grads(torch, ref, x0 * (1.0 + 2.0 ** -23))[1]
    names = [n for n, _ in ref.net_.named_parameters()]
    t0 = time.perf_counter()
    want = space4_result(space4_paths(torch, ref, SPACE4_SEED,
                                      lambda a: torch.from_numpy(a).cuda()),
                         ref.mcmc.history)
    ref_s = time.perf_counter() - t0
    n_layers = len(ref.net_[2].nets)
    del ref

    def rel(a, b):
        return np.abs(np.asarray(a) - np.asarray(b)) / np.maximum(
            1.0, np.abs(np.asarray(b)))

    def leaf_rel(a, b):
        return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                                  1e-30)

    leaf_bars = [max(SPACE_LOSS_TOL, SPACE_FLOOR * leaf_rel(a, b))
                 for a, b in zip(nudged, want["grads"][1])]
    lrand = space4_round(SPACE4_SEED)[1][None]
    per_unit = {
        "space4 sample": {"rqs_coupling": n_layers, "phi4_action_slab": 1},
        "space4 chain": {"rqs_coupling": n_layers, "phi4_action_slab": 1,
                         "accept_scan": 1},
        "space4 grads": {"rqs_coupling": 2 * n_layers,
                         "rqs_coupling_bwd": 2 * n_layers,
                         "phi4_action_slab": 1, "phi4_action_slab_grad": 1}}
    per_unit["space4 fit"] = per_unit["space4 grads"]
    units = {"space4 sample": 1, "space4 chain": 1, "space4 grads": 1,
             "space4 fit": SPACE4_STEPS}
    loss0, leaves0 = ranks[0]["grads"]
    for r in ranks:
        raw_q, raw_p, seq = r["raw"]
        rel_q, rel_p = (float(rel(a, b).max()) for a, b in
                        ((r["logq"], want["logq"]),
                         (r["logp"], want["logp"])))
        raw_rel = max(float(rel(a, b).max()) for a, b in
                      ((raw_q, want["raw"][0]), (raw_p, want["raw"][1])))
        p_seq, p_lq, p_lp = plain_chain(torch, raw_q, raw_p, lrand)
        plain_same = (np.array_equal(seq, p_seq)
                      and np.array_equal(r["chain"]["logq"], p_lq)
                      and np.array_equal(r["chain"]["logp"], p_lp))
        flips = int((seq != want["raw"][2]).sum())
        loss, leaves = r["grads"]
        dgrad = float(rel([loss], [want["grads"][0]]).max())
        dleaves = [leaf_rel(a, b) for a, b in zip(leaves, want["grads"][1])]
        worst = int(np.argmax(np.asarray(dleaves) / np.asarray(leaf_bars)))
        leaves_ok = all(d <= b for d, b in zip(dleaves, leaf_bars))
        alike = loss == loss0 and all(np.array_equal(a, b)
                                      for a, b in zip(leaves, leaves0))
        fit = r["loss"] if r["rank"] == 0 else want["loss"]
        dloss = rel(fit, want["loss"])
        print(f"8^4 over 2 space ranks, rank {r['rank']} (first row, rows "
              f"{r['slab']}): sample__ {r['y_shape']}; logq max rel "
              f"{rel_q:.3e}, logp max rel {rel_p:.3e}, chain proposals max "
              f"rel {raw_rel:.3e} against the unsharded 8^4 flagship on the "
              f"card (tol {LOGQ_REL_TOL}); accept decisions {flips} of "
              f"{seq.size} unlike the unsharded chain's (accept "
              f"{float(seq.mean()):.5f}, unsharded "
              f"{float(want['raw'][2].mean()):.5f}), vs the plain recurrence "
              f"on its proposals {'bit for bit' if plain_same else 'DIFFER'};"
              f" the first step's loss rel {dgrad:.3e} (tol {LOGQ_REL_TOL}), "
              f"|dg|/|g| per leaf max {max(dleaves):.3e}, nearest its bar "
              f"{names[worst]} {dleaves[worst]:.3e} (bar "
              f"{leaf_bars[worst]:.3e}: {SPACE_LOSS_TOL} or {SPACE_FLOOR:g} "
              f"x the unsharded "
              f"gradient's move under a one-ulp nudge of the draw; bars "
              f"{min(leaf_bars):.1e}-{max(leaf_bars):.1e}), "
              f"ranks {'alike bit for bit' if alike else 'DIFFER'}; "
              f"{SPACE4_STEPS} steps' loss rel {dloss.tolist()} (step 1 tol "
              f"{LOGQ_REL_TOL}, then {SPACE_LOSS_TOL}); loss "
              f"{np.round(np.asarray(fit), 3).tolist()}")
        if not (r["slab"] == (r["rank"] * LAT4[0] // 2, LAT4[0] // 2)
                and r["y_shape"] == (SPACE4_BATCH, *LAT4)
                and rel_q <= LOGQ_REL_TOL and rel_p <= LOGQ_REL_TOL
                and raw_rel <= LOGQ_REL_TOL and plain_same and not flips
                and dgrad <= LOGQ_REL_TOL and leaves_ok
                and alike and len(fit) == SPACE4_STEPS
                and np.isfinite(fit).all() and dloss[0] <= LOGQ_REL_TOL
                and dloss.max() <= SPACE_LOSS_TOL):
            raise AssertionError("the 8^4 flagship over two space ranks "
                                 "departs from the unsharded one")
        for path, want_per in per_unit.items():
            got = {k: v for k, v in r["counts"][path].items() if v[0]}
            wanted = {k: (v * units[path],
                          v * units[path] if k != "accept_scan" else 0)
                      for k, v in want_per.items()}
            print(f"  {path}: launches by wrapper (launches, tiled) {got}, "
                  f"want {wanted}")
            if got != wanted:
                raise AssertionError(f"{path}: wrapper launches {got}, want "
                                     f"{wanted} (every slab launch tiled nd)")
    for path, want_per in per_unit.items():
        for k in want_per:
            n = sum(r["counts"][path][k][0] for r in ranks)
            kernels[k].setdefault("launches_by_path", {})[path] = n
            if k in SLAB_ND_RECORDS:
                kernels[k].setdefault("tiled_launches_by_path", {})[path] = n
                kernels[SLAB_ND_RECORDS[k]]["launches_by_path"][path] = n
    s = ranks[0]["seconds"]
    print(f"8^4 over 2 space ranks: {SPACE4_STEPS / s['space4 fit']:.3f} "
          f"eager steps/s at batch {SPACE4_BATCH}, "
          f"{SPACE4_BATCH / s['space4 chain']:.1f} chain proposals/s (gloo "
          f"through the host: not a speed claim); the unsharded eager "
          f"reference {ref_s:.1f} s; the two ranks' processes {wall:.1f} s "
          f"wall, start-up included; phase 26 "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")


# each kernel's device functions, the path's first, as ptxas and the
# profiler name them; the flagship's template instance (m = 8, linear
# tails, as mangled: the inverse flag follows)
DEVICE_FUNCTIONS = {
    "rqs_coupling": ("rqs_coupling_tiled_kernel", "rqs_coupling_kernel"),
    "rqs_coupling_bwd": ("rqs_coupling_bwd_tiled_kernel",
                         "rqs_coupling_bwd_kernel"),
    "phi4_action": ("phi4_action_tiled_kernel", "phi4_action_kernel"),
    "phi4_action_grad": ("phi4_action_grad_tiled_kernel",
                         "phi4_action_grad_kernel"),
    "accept_scan": ("accept_scan_kernel",),
    "phi4_action_slab": ("phi4_action_slab_tiled_kernel",
                         "phi4_action_slab_kernel"),
    "phi4_action_slab_grad": ("phi4_action_grad_slab_tiled_kernel",
                              "phi4_action_grad_slab_kernel"),
    "rqs_coupling_cl": ("rqs_coupling_cl_tiled_kernel",
                        "rqs_coupling_cl_kernel"),
    "rqs_coupling_bwd_cl": ("rqs_coupling_bwd_cl_tiled_kernel",
                            "rqs_coupling_bwd_cl_kernel"),
    "phi4_action_tiled_nd": ("phi4_action_tiled_nd_kernel",),
    "phi4_action_grad_tiled_nd": ("phi4_action_grad_tiled_nd_kernel",),
    "phi4_action_slab_tiled_nd": ("phi4_action_slab_tiled_nd_kernel",),
    "phi4_action_slab_grad_tiled_nd": (
        "phi4_action_grad_slab_tiled_nd_kernel",),
}
FLAGSHIP_INSTANCE = "ILi8ELb1ELb1E"


def ptxas_by_kernel(log):
    """``{device function: [(mangled instance, registers, spill store
    bytes)]}`` from ``nvcc -Xptxas -v``'s log; prints one line per device
    function."""
    names = sorted({f for fns in DEVICE_FUNCTIONS.values() for f in fns},
                   key=len, reverse=True)
    found = {n: [] for n in names}
    inst = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and inst:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst:
            fn = next((n for n in names if f"{len(n)}{n}" in inst), None)
            if fn is not None:
                found[fn].append((inst, int(m.group(1)), spill))
            inst = None
    for fn, rows in found.items():
        if not rows:
            raise AssertionError(f"ptxas built no instance of {fn}")
        regs = [r for _, r, _ in rows]
        flag = [("inverse " if i.split(FLAGSHIP_INSTANCE)[1].startswith("Lb1")
                 else "forward ") + f"{r} ({sp} B spilled)"
                for i, r, sp in rows if FLAGSHIP_INSTANCE in i]
        print(f"ptxas {fn}: {len(rows)} instances, {min(regs)}-{max(regs)} "
              f"registers" + (f" (flagship m=8 linear: {', '.join(flag)})"
                              if flag else "")
              + f", {sum(s for _, _, s in rows)} bytes of spill stores")
    return found



# --------------------------------------------------------------------- #
# The U(1) gauge and Schwinger paths (no hand-written kernel but
# accept_scan: they are plain XLA in the JAX package too)
# --------------------------------------------------------------------- #
def gauge_counters():
    """Every launch counter: the four scalar kernels and accept_scan."""
    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan

    return {**_counters(), "accept_scan": accept_scan}


def gauge_profile(torch, fn, what, reps=4):
    """:func:`profile_step` of ``fn`` after one untimed call (a capture
    is not profiled) and ``reps`` calls timed on the host without the
    profiler, which slows the replay of a graph of thousands of short
    kernels: the idle share is 1 - busy / that wall."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    busy = profile_step(fn, what, reps)
    print(f"  {what} without the profiler: wall {wall * 1e3:.4f} ms, idle "
          f"share {1 - busy / wall:.4f}")


def gate_gauge(counters, kernels, path, device, want_scan=0,
               wrapper_scan=0):
    """A gauge path's run: the profiler saw ``want_scan`` ``accept_scan``
    launches and none of the four scalar kernels, and the wrappers ran
    ``wrapper_scan`` times (accept_scan) and 0 times (the others).  The
    counts go into the record's ``launches_by_path``."""
    want = {"accept_scan": (want_scan, 0)} if want_scan else {}
    wrapper = {k: c.launches for k, c in counters.items()}
    want_wrapper = {k: wrapper_scan if k == "accept_scan" else 0
                    for k in counters}
    print(f"launches over the {path} path by profiler name (launches, "
          f"tiled): {device}, want {want}; by the wrappers {wrapper}, want "
          f"{want_wrapper}")
    if device != want or wrapper != want_wrapper:
        raise AssertionError(f"{path}: launches {device} / wrappers "
                             f"{wrapper}, want {want} / {want_wrapper}")
    for k in counters:
        kernels[k].setdefault("launches_by_path", {})[path] = \
            device.get(k, (0, 0))[0]


def pure_gauge_cos_p(beta=2.0):
    """<cos P> of 2-D U(1) on a large torus: I1(beta) / I0(beta)."""
    from scipy.special import i0, i1

    return float(i1(beta) / i0(beta))


def u1_copy(torch, model, dtype):
    """A CPU copy of the U(1) model in ``dtype`` with ``model``'s
    weights."""
    from normflow__tpu_torch.zoo import build_u1_model

    m = build_u1_model(U1_LAT, device="cpu", dtype=dtype)
    m.net_.load_state_dict({k: v.to(dtype) for k, v in
                            model.net_.state_dict().items()})
    return m


def gauge_rates_in_turns(torch, card):
    """Eager bodies in a Python loop against the graphed entry points, in
    turns (eager, graphed, ..., graphed, eager), on models of their own,
    each run once untimed first: raw samples/s of 8 batches and training
    steps/s of segments of 3 steps of BASELINE config 5 (batch
    ``U1_BATCH``; ``U1_TRAIN_BATCH``, path gradient, clip 25), of the 8x8
    exact Schwinger model of ``examples/schwinger.py`` (batch 128, its
    reparametrization gradient) and of the 16x16 stochastic Schwinger model
    (batch ``STOCH_BATCH``).  It runs beside ``rates_in_turns``, before any
    profiler has in this process (after one, every launch from the host
    costs more)."""
    from normflow__tpu_torch.zoo import build_u1_model

    u1 = build_u1_model()
    schw = schwinger_model(torch, SCHWINGER_LAT)
    stoch = schwinger_model(torch, STOCH_LAT, stochastic=True)
    fit_u1(u1, 2)
    fit_plain(schw, 2, 128)
    fit_plain(stoch, 2, STOCH_BATCH)
    n, n_steps = 8, 3  # batches and steps per timed run
    for what, model, batch in (("U(1) config 5", u1, U1_BATCH),
                               ("Schwinger 8x8 exact", schw, 128)):
        post, gen = model.posterior, model.generator

        def eager(post=post, gen=gen, batch=batch):
            for _ in range(n):
                post.logqp_batch(batch, gen)

        in_turns(torch, card, f"{what} sampling, {n} batches of {batch}",
                 "raw samples/s", n * batch,
                 {"eager": eager, "graphed": lambda post=post, batch=batch:
                  post.logqp_stream(n, batch)})
    for what, model in (("U(1) config 5", u1), ("Schwinger 8x8 exact", schw),
                        ("Schwinger 16x16 stochastic", stoch)):
        fit = model.fit
        in_turns(torch, card, f"{what} training at batch "
                 f"{fit.train_batch_size}, segments of {n_steps}", "steps/s",
                 n_steps, {"eager": lambda fit=fit: [
                     fit.train_body() for _ in range(n_steps)],
                     "graphed": lambda fit=fit: [
                     fit.step() for _ in range(n_steps)]})


def in_turns(torch, card, what, unit, n, fns, runs=1, warm=False):
    """``n / seconds`` of each of ``fns`` in turns, ``2 * runs`` (2) runs
    each, after one untimed run of each (cuDNN's picks, the capture)
    unless ``warm`` (every one has run); prints the medians and returns
    them.  Two runs a side, not four, keep the smoke inside its time limit
    on a slow host with phases 23-25 added."""
    for fn in fns.values() if not warm else ():
        fn()
    rates = {k: [] for k in fns}
    for key in tuple(fns) * runs + tuple(reversed(fns)) * runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[key]()
        torch.cuda.synchronize()
        rates[key].append(n / (time.perf_counter() - t0))
    def fmt(rate):  # five figures at least: a step of the 8^4 flagship
        return f"{rate:.1f}" if rate >= 1e4 else f"{rate:.5g}"

    print(f"{what}, {unit} in turns, {2 * runs} runs each: " + "; ".join(
        f"{k} median {fmt(statistics.median(r))} (min {fmt(min(r))}, max "
        f"{fmt(max(r))})" for k, r in rates.items()) + f" on {card}")
    return {k: statistics.median(r) for k, r in rates.items()}


def fit_u1(model, n_epochs, steps_per_call=None):
    """``model.fit`` as the smoke trains BASELINE config 5: path gradient,
    clip 25, AdamW lr 1e-3 without decay, batch ``U1_TRAIN_BATCH``."""
    return model.fit(n_epochs=n_epochs, batch_size=U1_TRAIN_BATCH,
                     hyperparam=dict(lr=1e-3, weight_decay=0.0),
                     grad_estimator="path", clip_grad_norm=25.0,
                     steps_per_call=steps_per_call,
                     checkpoint_dict=dict(print_stride=None))


def fit_plain(model, n_epochs, batch):
    """``model.fit`` as ``examples/schwinger.py`` trains: AdamW lr 1e-3
    without decay, the reparametrization gradient."""
    return model.fit(n_epochs=n_epochs, batch_size=batch,
                     hyperparam=dict(lr=1e-3, weight_decay=0.0),
                     checkpoint_dict=dict(print_stride=None))


def schwinger_model(torch, lat, stochastic=False):
    """The Schwinger model of ``examples/schwinger.py`` (beta 2, m 0.2, 2
    cycles, hidden 16, seed 0) at ``lat``; ``stochastic`` trains with
    ``StochasticStaggeredLogDet(n_probes=2, cg_tol=1e-5)``."""
    from normflow__tpu_torch import Model
    from normflow__tpu_torch.models.fermions import (
        SchwingerAngleAction, StochasticStaggeredLogDet)
    from normflow__tpu_torch.models.gauge import build_u1_gauge_flow
    from normflow__tpu_torch.models.priors import UniformPrior

    kw = dict(dtype=torch.float32, device="cuda")
    flow = build_u1_gauge_flow(torch.Generator().manual_seed(0), lat,
                               hidden=(16,), n_cycles=2, **kw)
    prior = UniformPrior(torch.full((2, *lat), -math.pi, **kw),
                         torch.full((2, *lat), math.pi, **kw))
    ld = (StochasticStaggeredLogDet(lat_shape=lat, mass=0.2, n_probes=2,
                                    cg_tol=STOCH_CG_TOL)
          if stochastic else None)
    return Model(net_=flow, prior=prior, seed=0, action=SchwingerAngleAction(
        beta=2.0, lat_shape=lat, mass=0.2, logdet_func=ld))


def run_u1_sampling(torch, kernels, rng, card):
    """BASELINE config 5 at full width (``build_u1_model()``), seeded
    perturbed weights: logq and the flow's angles on the card against a
    float64 CPU copy (angles modulo 2 pi), beside a float32 CPU copy that
    sets the bars; ``logqp_stream(U1_STREAM, U1_BATCH)`` profiled with the
    counters set to 0 just before (no kernel of the port runs); a replayed
    batch against its eager body, bit for bit."""
    from normflow__tpu_torch.models.gauge import wrap_angle
    from normflow__tpu_torch.tools.kernel_times import (device_launches,
                                                         perturb_)
    from normflow__tpu_torch.zoo import build_u1_model

    model = build_u1_model()
    print(f"U(1) BASELINE config 5 {U1_LAT}: {len(model.net_.flows)} "
          f"couplings, {model.net_.npar} parameters on {model.device}")
    perturb_(model.net_, rng)
    x = rng.uniform(-math.pi, math.pi, (64, 2, *U1_LAT))
    res = {}
    for key, dtype in (("gpu", torch.float32), ("cpu", torch.float32),
                       ("cpu64", torch.float64)):
        m = model if key == "gpu" else u1_copy(torch, model, dtype)
        xd = torch.tensor(x, dtype=dtype, device=m.device)
        with torch.no_grad():
            y, logj = m.net_.forward(xd)
            res[key] = (y.double().cpu(),
                        (m.prior.log_prob(xd) - logj).double().cpu())

    def err(a, b):
        (ya, la), (yb, lb) = res[a], res[b]
        return (float(wrap_angle(ya - yb).abs().max()),
                float(((la - lb).abs() / lb.abs().clamp(min=1.0)).max()))

    (gy, gl), (cy, cl) = err("gpu", "cpu64"), err("cpu", "cpu64")
    bars = max(U1_ANGLE_TOL, FLOOR_FACTOR * cy), \
        max(LOGQ_REL_TOL, FLOOR_FACTOR * cl)
    print(f"U(1) forward, 64 samples, vs a float64 CPU copy: card max "
          f"|d angle| mod 2 pi {gy:.3e}, max rel logq {gl:.3e}; float32 CPU "
          f"{cy:.3e}, {cl:.3e}; bars {bars[0]:.3e}, {bars[1]:.3e}")
    if not (gy <= bars[0] and gl <= bars[1]):
        raise AssertionError("the U(1) model on the card disagrees with "
                             "float64")

    counters = gauge_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(U1_STREAM, U1_BATCH))
    seconds = time.perf_counter() - t0
    gate_gauge(counters, kernels, "u1 sample", device)
    if logqp.shape != (U1_STREAM * U1_BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("the U(1) stream is not finite or has the "
                             "wrong shape")
    print(f"U(1) logqp_stream({U1_STREAM}, {U1_BATCH}): the first call, "
          f"capture included, profiled, {seconds:.2f} s on {card}")
    post, gen = model.posterior, model.generator
    model.seed(21)
    got = post.logqp_stream(3, U1_BATCH)
    model.seed(21)
    want = torch.cat([post.logqp_batch(U1_BATCH, gen) for _ in range(3)])
    same = same_bits(torch, (got,), (want,))
    print(f"U(1) replayed vs eager batch, 3 x {U1_BATCH}: "
          f"{'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("a replayed U(1) batch differs from its eager "
                             "body")
    gauge_profile(torch, lambda: post.logqp_batch(U1_BATCH, gen),
                  f"one eager U(1) batch of {U1_BATCH}")
    gauge_profile(torch, lambda: post.logqp_stream(1, U1_BATCH),
                  f"one replayed U(1) batch of {U1_BATCH}")


def check_u1_step(torch, model, rng):
    """One path-gradient loss and its gradients of the U(1) model at its
    initial weights on one numpy draw of 32: the card against a float64
    CPU copy, beside a float32 CPU copy.  The loss is held to
    ``TRAIN_LOSS_TOL``, each leaf to the larger of ``TRAIN_GRAD_TOL`` and
    ``FLOOR_FACTOR`` times the float32 CPU copy's own error, as the
    unpacked flagship's: the path gradient through 32 inverse couplings
    loses digits in float32 on the CPU too (1.4e-2 on one leaf, the card
    alike, on an H100 80GB HBM3).  With perturbed weights the float32
    inverse is worse still (a round trip off by up to a radian on the
    CPU), so the step is taken at ``build_u1_model``'s initial weights."""
    x = rng.uniform(-math.pi, math.pi, (32, 2, *U1_LAT))
    res = {}
    for key, dtype in (("gpu", torch.float32), ("cpu", torch.float32),
                       ("cpu64", torch.float64)):
        m = model if key == "gpu" else u1_copy(torch, model, dtype)
        m.fit.grad_estimator = "path"
        xd = torch.tensor(x, dtype=dtype, device=m.device)
        loss, _, _ = m.fit.loss_of(xd, m.prior.log_prob(xd))
        grads = torch.autograd.grad(loss, list(m.net_.parameters()))
        res[key] = (float(loss.detach()),
                    [g.detach().cpu().double() for g in grads])

    def rel(a, b):
        loss = abs(res[a][0] - res[b][0]) / max(1.0, abs(res[b][0]))
        return loss, [float((p - q).norm()) / max(float(q.norm()), 1e-30)
                      for p, q in zip(res[a][1], res[b][1])]

    for a in ("gpu", "cpu"):
        loss, leaves = rel(a, "cpu64")
        print(f"U(1) path-gradient step, batch 32, {a} vs cpu64: loss rel "
              f"{loss:.3e}; |dg|/|g| per leaf max {max(leaves):.3e}, median "
              f"{statistics.median(leaves):.3e}")
    loss, leaves = rel("gpu", "cpu64")
    bars = [max(TRAIN_GRAD_TOL, FLOOR_FACTOR * f)
            for f in rel("cpu", "cpu64")[1]]
    over = max(r / b for r, b in zip(leaves, bars))
    print(f"  every leaf against the larger of {TRAIN_GRAD_TOL} and "
          f"{FLOOR_FACTOR} x the float32 CPU copy's own error: worst "
          f"{over:.3f} of its bar")
    if not (loss <= TRAIN_LOSS_TOL and over <= 1.0):
        raise AssertionError(f"the U(1) step on the card disagrees with "
                             f"float64 (tol {TRAIN_LOSS_TOL} / per-leaf "
                             "bars)")


def run_u1_training(torch, kernels, rng, card):
    """A fresh BASELINE config 5 model: one path-gradient step against
    float64; ``model.fit`` for ``U1_STEPS`` steps (``fit_u1``), the first
    ``U1_PROFILED`` profiled with the counters set to 0 just before (no
    kernel of the port runs), the rest on the same optimizer state and
    captured step; 10 replayed steps against 10 eager bodies; the idle
    share of a replayed step."""
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.zoo import build_u1_model

    model = build_u1_model()
    t0 = time.perf_counter()
    check_u1_step(torch, model, rng)
    print(f"  (the step check took {time.perf_counter() - t0:.1f} s, the "
          "CPU copies included)")
    counters = gauge_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    device, _ = device_launches(lambda: fit_u1(model, U1_PROFILED,
                                               U1_PROFILED))
    gate_gauge(counters, kernels, "u1 train", device)
    model.fit.train(U1_STEPS - U1_PROFILED, batch_size=U1_TRAIN_BATCH,
                    steps_per_call=50)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if any(c.launches for c in counters.values()):
        raise AssertionError("the U(1) fit ran a kernel wrapper")
    loss = np.asarray(model.fit.train_history["loss"])
    first, last = float(loss[:50].mean()), float(loss[-50:].mean())
    print(f"U(1) model.fit: {U1_STEPS} steps at batch {U1_TRAIN_BATCH} in "
          f"{seconds:.2f} s (capture included, the first {U1_PROFILED} "
          f"profiled) on {card}; loss mean of the first 50 {first:.3f}, of "
          f"the last 50 {last:.3f}")
    if loss.shape != (U1_STEPS,) or not np.isfinite(loss).all() \
            or not last < first:
        raise AssertionError("the U(1) loss is not finite or not falling")
    # Adam's first hundreds of steps turn a last-bit difference of cuDNN's
    # default weight-gradient order into 1e-4 of the loss within four
    # steps here (the gpu test file's first card run): the comparison
    # takes cuDNN's deterministic algorithms and asks for the bits
    t0 = time.perf_counter()
    replayed_vs_eager_steps(torch, model, "U(1) ", deterministic=True)
    print(f"  (the comparison took {time.perf_counter() - t0:.1f} s)")
    gauge_profile(torch, model.fit.step, f"one replayed U(1) training step "
                  f"at batch {U1_TRAIN_BATCH}", reps=2)
    return model


def sample_gauge(torch, kernels, model, lat, batch, path, card, first,
                 max_rounds, captured=False):
    """``mcmc.sample_chain`` in calls of ``first`` rounds of ``batch``, the
    first profiled with the counters set to 0 just before (1 accept_scan
    per round, its warm-up bodies and capture included unless
    ``captured``), until <cos P>'s binned error is at most
    ``U1_COSP_ERR`` or ``max_rounds`` rounds ran.  Returns the
    per-configuration <cos P> and charge and the per-round accept rates."""
    from normflow__tpu_torch.examples.u1_gauge import binned, plaquette_series
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.utils.graphs import WARMUP

    counters = gauge_counters()
    reset_counts(counters)
    device, out = device_launches(lambda: model.mcmc.sample_chain(
        first, batch, collect_samples=True))
    gate_gauge(counters, kernels, path, device,
               first + (0 if captured else WARMUP),
               0 if captured else WARMUP + 1)
    cos_p, q, rates, rounds = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        c, qq = plaquette_series(out["samples"].reshape(-1, 2, *lat)
                                 .double())
        c, qq = c.cpu().numpy(), qq.cpu().numpy()
        cos_p.append(c)
        q.append(qq)
        rates.append(out["accept_rate"].cpu().numpy())
        rounds += first
        if binned(np.concatenate(cos_p))[1] <= U1_COSP_ERR \
                or rounds >= max_rounds:
            break
        out = model.mcmc.sample_chain(first, batch, collect_samples=True)
    print(f"{path}: {rounds} rounds of {batch} ({rounds * batch} "
          f"configurations) in {time.perf_counter() - t0:.2f} s after the "
          f"profiled call, on {card}")
    return np.concatenate(cos_p), np.concatenate(q), np.concatenate(rates)


def run_u1_chain(torch, kernels, model, card):
    """``sample_chain`` on the trained config 5 model until <cos P>'s
    binned error is at most ``U1_COSP_ERR``; <cos P> must lie within 3
    sigma of the 2-D U(1) value I1(2) / I0(2) (on a 16x16 torus the
    topological corrections, (I1/I0)^256 ~ e^-92, vanish)."""
    from normflow__tpu_torch.examples.u1_gauge import binned

    cos_p, q, rates = sample_gauge(torch, kernels, model, U1_LAT, U1_BATCH,
                                   "u1 chain", card, U1_CHUNK, U1_MAX_ROUNDS)
    value, err = binned(cos_p)
    oracle = pure_gauge_cos_p(2.0)
    sigma = abs(value - oracle) / err
    print(f"U(1) <cos P> {value:.5f} +- {err:.5f} (binned, {len(cos_p)} "
          f"configurations) vs I1(2)/I0(2) = {oracle:.5f} (scipy): "
          f"{sigma:.2f} sigma (bar 3, error bar {U1_COSP_ERR}); sigma(Q) "
          f"{q.std():.3f}, <Q> {q.mean():+.3f}; accept rate {rates.mean():.4f}"
          f" on {card}")
    if not (err <= U1_COSP_ERR and sigma <= OBS_SIGMAS):
        raise AssertionError("U(1) <cos P> misses the exact value")
    gauge_profile(torch, model.mcmc.chain_graph(U1_BATCH).graph.replay,
                  f"one replayed U(1) sample_chain round of {U1_BATCH}")


def check_logdet(torch, card):
    """The exact Schur log-det on the card in float32 against the dense
    float64 ``slogdet`` on the CPU at 8x8 and 16x16 (random links, batch
    64, m 0.2), and its invariance under a random gauge transform on the
    card; relative to ``max(1, |log det|)``, ``LOGDET_REL_TOL``."""
    from normflow__tpu_torch.models.fermions import StaggeredFermionLogDet
    from normflow__tpu_torch.models.gauge import wrap_angle

    rng = np.random.default_rng(8)
    for lat in (SCHWINGER_LAT, STOCH_LAT):
        theta = rng.uniform(-math.pi, math.pi, (64, 2, *lat))
        ld = StaggeredFermionLogDet(lat_shape=lat, mass=0.2)
        t = torch.tensor(theta, dtype=torch.float32, device="cuda")
        got = ld(t)
        want = StaggeredFermionLogDet(lat_shape=lat, mass=0.2,
                                      method="dense")(torch.tensor(theta))
        rel = float(((got.double().cpu() - want).abs()
                     / want.abs().clamp(min=1.0)).max())
        a = torch.tensor(rng.uniform(-math.pi, math.pi, lat),
                         dtype=torch.float32, device="cuda")
        g = wrap_angle(torch.stack(
            [t[:, 0] + a - torch.roll(a, -1, 0),
             t[:, 1] + a - torch.roll(a, -1, 1)], dim=1))
        inv = float(((ld(g) - got).abs() / got.abs().clamp(min=1.0)).max())
        print(f"Schur log-det {lat}, float32 on the card vs dense float64 on "
              f"the CPU: max rel {rel:.3e}; gauge transformed vs not, on the "
              f"card: max rel {inv:.3e} (tol {LOGDET_REL_TOL}; |log det| up "
              f"to {float(want.abs().max()):.2f}) on {card}")
        if not (rel <= LOGDET_REL_TOL and inv <= LOGDET_REL_TOL):
            raise AssertionError("the Schur log-det on the card is off")


def run_schwinger(torch, kernels, card):
    """``examples/schwinger.py`` at its defaults on the card (8x8, beta 2,
    m 0.2, 1000 epochs at batch 128, 2 cycles, exact Schur log-det,
    graphed), every counter set to 0 just before and read just after
    (accept_scan's wrapper for its chain's warm-up and capture, no other);
    the training action is the exact one (``with_key`` is a no-op) and
    ``mcmc`` samples with it; 4 replayed steps (no kernel of the port) and
    ``SCHWINGER_ROUNDS`` replayed chain rounds profiled, the counters set
    to 0 just before each, then calls of as many until <cos P>'s binned
    error is ``U1_COSP_ERR`` or less (at most ``SCHWINGER_MAX_ROUNDS``);
    <cos P> must lie more than 3 binned sigma above the pure-gauge I1(2) /
    I0(2)."""
    from normflow__tpu_torch.examples import schwinger
    from normflow__tpu_torch.examples.u1_gauge import binned
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.utils.graphs import WARMUP

    check_logdet(torch, card)
    counters = gauge_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    model = schwinger.main()
    seconds = time.perf_counter() - t0
    wrapper = {k: c.launches for k, c in counters.items()}
    want = {k: WARMUP + 1 if k == "accept_scan" else 0 for k in counters}
    print(f"Schwinger example's wrapper launches {wrapper}, want {want} "
          "(accept_scan: its chain's warm-up and capture)")
    if wrapper != want:
        raise AssertionError("the Schwinger example ran a scalar kernel or "
                             "missed accept_scan")
    keyed = model.fit._training_action()
    print(f"Schwinger example at its defaults: {model.net_.npar} parameters,"
          f" 1000 epochs and sample_chain(8, 128) in {seconds:.2f} s on "
          f"{card}; training action {type(keyed).__name__} is model.action: "
          f"{keyed is model.action} (exact log-det, keyless); mcmc samples "
          "with model.action")
    if keyed is not model.action:
        raise AssertionError("the exact Schwinger action was keyed")
    counters = gauge_counters()
    reset_counts(counters)
    device = device_launches(lambda: [model.fit.step() for _ in range(4)])[0]
    gate_gauge(counters, kernels, "schwinger train", device)
    cos_p, q, rates = sample_gauge(
        torch, kernels, model, SCHWINGER_LAT, 128, "schwinger chain", card,
        SCHWINGER_ROUNDS, SCHWINGER_MAX_ROUNDS, captured=True)
    value, err = binned(cos_p)
    oracle = pure_gauge_cos_p(2.0)
    above = (value - oracle) / err
    print(f"Schwinger <cos P> {value:.5f} +- {err:.5f} (binned, "
          f"{len(cos_p)} configurations) vs pure gauge I1(2)/I0(2) = "
          f"{oracle:.5f}: {above:.2f} sigma above (bar 3); the JAX "
          f"package's records {SCHWINGER_RECORDS} (docs/EXPERIMENTS.md, not "
          f"a gate); sigma(Q) {q.std():.3f}; accept rate {rates.mean():.4f} "
          f"on {card}")
    if not above > OBS_SIGMAS:
        raise AssertionError("the Schwinger model shows no sea-quark shift "
                             "of <cos P>")
    gauge_profile(torch, lambda: model.posterior.logqp_stream(1, 128),
                  "one replayed Schwinger batch of 128")
    gauge_profile(torch, model.fit.step, "one replayed Schwinger training "
                  "step at batch 128", reps=2)
    gauge_profile(torch, model.mcmc.chain_graph(128).graph.replay,
                  "one replayed Schwinger sample_chain round of 128")


def cg_iterations(torch, links, z, mass, tol, maxiter):
    """The iterations the JAX ``while_loop`` runs on these systems (it
    stops once every residual is below ``tol |b|``), from the same masked
    body, and the worst final ``|r| / |b|``."""
    from normflow__tpu_torch.models import fermions as tf

    ops = tf._hop_operands(links, True)
    axes = tuple(range(2, z.dim()))

    def dot(a, b):
        return torch.sum(torch.conj(a) * b, dim=axes).real

    def expand(a):
        return a.reshape(a.shape + (1, 1))

    b2 = dot(z, z)
    tol2 = tol * tol * b2
    r, p, rs = z, z, b2
    it = 0
    while it < maxiter and bool((rs > tol2).any()):
        kp = tf._apply_K(ops, mass, p)
        live = rs > tol2
        alpha = torch.where(live, rs / dot(p, kp), 0.0)
        r = r - expand(alpha) * kp
        rs_new = dot(r, r)
        p = r + expand(torch.where(live, rs_new / rs, 0.0)) * p
        rs, it = rs_new, it + 1
    return it, float((rs / b2).sqrt().max())


def run_stochastic(torch, kernels, card):
    """(a) At 4x4 on the card, float64: the surrogate's gradient over 256
    probe draws (256 copies of one configuration in one batch, 4 probes
    each) against the exact log-det's gradient, within 5 standard errors
    per component, as ``tests/test_fermions.py:273``.  (b) The 16x16
    Schwinger model with ``StochasticStaggeredLogDet(n_probes=2,
    cg_tol=1e-5)``: ``STOCH_STEPS`` replayed steps (the first profiled,
    counters set to 0 just before: no kernel of the port runs), 3 replays
    against 3 eager bodies, the CG iterations the probe systems of a step
    need, and time per step.  (c) Sampling on that model with the exact,
    keyless action."""
    from normflow__tpu_torch.examples.u1_gauge import plaquette_series
    from normflow__tpu_torch.models.fermions import (
        StaggeredFermionLogDet, StochasticStaggeredLogDet)
    from normflow__tpu_torch.tools.kernel_times import device_launches

    lat, n = (4, 4), 256
    rng = np.random.default_rng(9)
    theta = torch.tensor(rng.uniform(-math.pi, math.pi, (1, 2, *lat)),
                         dtype=torch.float64, device="cuda")
    t = theta.clone().requires_grad_(True)
    (g_exact,) = torch.autograd.grad(
        StaggeredFermionLogDet(lat_shape=lat, mass=0.3)(t).sum(), t)
    est = StochasticStaggeredLogDet(lat_shape=lat, mass=0.3, n_probes=4,
                                    cg_tol=1e-10, cg_maxiter=400)
    rep = theta.expand(n, -1, -1, -1).clone().requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(100)
    (grads,) = torch.autograd.grad(est.with_key(gen)(rep).sum(), rep)
    mean, stderr = grads.mean(0), grads.std(0) / math.sqrt(n) + 1e-12
    worst = float(((mean - g_exact[0]).abs() / stderr).max())
    corr = float(np.corrcoef(mean.cpu().numpy().ravel(),
                             g_exact.cpu().numpy().ravel())[0, 1])
    print(f"stochastic log-det gradient at 4x4, float64 on the card, {n} "
          f"draws x 4 probes: worst component {worst:.2f} standard errors "
          f"from the exact gradient (bar 5), correlation {corr:.4f} (bar "
          f"0.95) on {card}")
    if not (worst < 5 and corr > 0.95):
        raise AssertionError("the stochastic log-det gradient is biased")

    model = schwinger_model(torch, STOCH_LAT, stochastic=True)
    counters = gauge_counters()
    reset_counts(counters)
    device, _ = device_launches(lambda: fit_plain(model, 1, STOCH_BATCH))
    gate_gauge(counters, kernels, "stochastic train", device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = model.fit.train(STOCH_STEPS, batch_size=STOCH_BATCH,
                           steps_per_call=STOCH_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if any(c.launches for c in counters.values()):
        raise AssertionError("the stochastic fit ran a kernel wrapper")
    loss = np.asarray(hist["loss"])
    keyed = model.fit._training_action()
    x = model.prior.sample(STOCH_BATCH, model.generator)
    with torch.no_grad():
        links = torch.exp(1j * model.net_.forward(x)[0])
    z = keyed.logdet_func._probes(links)
    iters, resid = cg_iterations(torch, links, z, 0.2, STOCH_CG_TOL,
                                 keyed.logdet_func.cg_maxiter)
    print(f"stochastic Schwinger {STOCH_LAT}, batch {STOCH_BATCH}: "
          f"{STOCH_STEPS} replayed steps in {seconds:.3f} s "
          f"({seconds / STOCH_STEPS * 1e3:.2f} ms per step, "
          f"{len(loss)} steps in all), losses finite "
          f"{bool(np.isfinite(loss).all())}; CG runs "
          f"{keyed.logdet_func.cg_maxiter} masked iterations per step, the "
          f"probe systems of a fresh draw need {iters} (worst |r|/|b| "
          f"{resid:.2e}, tol {STOCH_CG_TOL}) on {card}")
    if not (np.isfinite(loss).all() and iters < keyed.logdet_func.cg_maxiter
            and keyed is not model.action and keyed.logdet_func.key
            is model.generator):
        raise AssertionError("the stochastic fit failed, its CG did not "
                             "converge, or its probes were not keyed")
    replayed_vs_eager_steps(torch, model, "stochastic Schwinger ",
                            deterministic=True)
    gauge_profile(torch, model.fit.step, f"one replayed stochastic "
                  f"Schwinger step at batch {STOCH_BATCH}", reps=2)
    out = model.mcmc.sample_chain(4, STOCH_BATCH, collect_samples=True)
    exact = model.action.logdet_func.key is None
    c = plaquette_series(out["samples"].reshape(-1, 2, *STOCH_LAT))[0]
    c = c.double().cpu().numpy()
    print(f"stochastic Schwinger model sampled with sample_chain(4, "
          f"{STOCH_BATCH}) through model.action, whose log-det is keyless "
          f"(exact Schur): {exact}; <cos P> {c.mean():.4f}, accept rate "
          f"{float(out['accept_rate'].mean()):.4f} (after {len(loss)} steps)")
    if not (exact and np.isfinite(c).all()):
        raise AssertionError("the stochastic model's sampling is not exact")


# --------------------------------------------------------------------- #
# The channels-last route (backend="pallas_reg"): the conditioners run
# NHWC into the channels-last coupling kernels
# --------------------------------------------------------------------- #
CL_SEED = 20261022  # the phase's own numpy stream
CL_STEPS = 16  # the profiled fit's steps
# transposes between NCHW and NHWC that cuDNN wraps around a conv, by name
TRANSPOSE_RE = re.compile(r"nchwToNhwc|nhwcToNchw|transpose", re.IGNORECASE)


def cl_counters():
    """The counters of the channels-last route's kernels by record name:
    the coupling wrappers count their channels-last launches in
    ``cl_launches``."""
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc

    return {"rqs_coupling_cl": sc.rqs_coupling,
            "rqs_coupling_bwd_cl": sc.rqs_coupling_bwd,
            "phi4_action": phi4.phi4_action,
            "phi4_action_grad": phi4.phi4_action_grad}


def reset_cl_counts():
    """Every launch count of the four wrappers set to 0, the tiled and the
    channels-last shares too."""
    for c in cl_counters().values():
        c.launches = c.tiled_launches = 0
        if hasattr(c, "cl_launches"):
            c.cl_launches = 0


def gate_cl_path(kernels, path, per_unit, n_units, device, tiled=True,
                 nd=False):
    """The channels-last route's run on ``path`` (:func:`gate_path`'s
    rule): by profiler name ``per_unit`` launches per warm-up body and
    replay of each kernel, every one tiled (``tiled`` may map a kernel to
    ``False``: none tiled, as the 1-D action's), the couplings' all to
    their channels-last tiled kernels (no NCHW coupling kernel in
    ``device``); by the wrappers ``per_unit`` per warm-up body and
    capture, tiled likewise, and every coupling launch channels-last;
    ``nd`` as for :func:`gate_path`."""
    from normflow__tpu_torch.utils.graphs import WARMUP

    counters = cl_counters()
    flag = {k: tiled[k] if isinstance(tiled, dict) else tiled
            for k in per_unit}
    want = {k: (v * (WARMUP + n_units), v * (WARMUP + n_units) * flag[k])
            for k, v in per_unit.items()}
    print(f"launches over the {path} path's run by profiler name "
          f"(launches, tiled): {device}, want {want}")
    if device != want:
        raise AssertionError(f"{path}: launches on the card {device}, want "
                             f"{want}")
    got = {k: (counters[k].launches, counters[k].tiled_launches,
               getattr(counters[k], "cl_launches", 0)) for k in per_unit}
    want = {k: (v * (WARMUP + 1), v * (WARMUP + 1) * flag[k],
                v * (WARMUP + 1) if k.endswith("_cl") else 0)
            for k, v in per_unit.items()}
    print(f"  by the wrappers (launches, tiled, channels-last): {got} "
          f"(warm-up and capture; want {want})")
    if got != want:
        raise AssertionError(f"{path}: wrapper launch counts {got}, want "
                             f"{want}")
    for k, (n, n_tiled) in device.items():
        kernels[k].setdefault("launches_by_path", {})[path] = n
        kernels[k].setdefault("tiled_launches_by_path", {})[path] = n_tiled
    if nd:
        record_nd(kernels, path, device)


def hold_cl(torch, worst, x, out, cot, kw, tag, tiled=True):
    """One call of either channels-last coupling kernel on ``out``, the
    tiled kernel or (``tiled=False``) the per-site one, held as
    :func:`check_cl_kernels` says; ``worst`` keeps each kernel's largest
    distance from its plain version.  Returns the outputs and the plain
    version's."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc

    bwd = bool(cot)
    name = "rqs_coupling_bwd_cl" if bwd else "rqs_coupling_cl"
    counter = sc.rqs_coupling_bwd if bwd else sc.rqs_coupling
    fn, plain_fn = ((sc.rqs_coupling_bwd, sc.rqs_coupling_vjp_plain)
                    if bwd else (sc.rqs_coupling, sc.rqs_coupling_plain))
    before = (counter.cl_launches, counter.tiled_launches)
    got = fn(x, out, *cot, **kw)
    launched = (counter.cl_launches - before[0],
                counter.tiled_launches - before[1])
    ref = fn(x, out.contiguous(), *cot, **kw)
    plain = plain_fn(x, out, *cot, **kw)
    torch.cuda.synchronize()
    same = same_bits(torch, got, ref)
    err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
    what = "tiled" if tiled else "per-site"
    line = (f"{name} {tag} inverse={kw['inverse']}: the {what} kernel "
            f"vs the NCHW {what} kernel "
            f"{'bit for bit' if same else 'NOT bit-identical'}; max |d| "
            f"vs plain {err:.3e}")
    ok = same and launched == (1, int(tiled)) and all(
        bool(torch.isfinite(g).all()) for g in got)
    if not bwd:
        print(f"{line} (tol {RQS_TOL})")
        ok = ok and err <= RQS_TOL
    else:
        ratio, _, _, k, i = vjp_excess(got, plain, VJP_RTOL)
        whole = err / max(1.0, *(float(p.abs().max()) for p in plain))
        ref64 = sc.rqs_coupling_vjp_plain(
            *(t.double() for t in (x, out, *cot)), **kw)
        off = [abs(float(t[k].flatten()[i])
                   - float(ref64[k].flatten()[i])) for t in (got, plain)]
        floored = floored_excess(got, plain, ref64)
        planted = floored_excess(
            [g + 0.01 * float(p.abs().median())
             for g, p in zip(got, plain)], plain, ref64)
        print(f"{line}, max|d|/max(1,max|plain|) {whole:.3e} (tol "
              f"{VJP_ATOL}); outbar strides {got[1].stride()}; worst "
              f"|d|/(atol+{VJP_RTOL:g}|plain|) {ratio:.3e} "
              f"({('xbar', 'outbar')[k]}; there float64 puts the kernel "
              f"{off[0]:.3e} off, the plain version {off[1]:.3e}); "
              f"worst |d|/max(atol+{VJP_RTOL:g}|plain|, "
              f"{VJP_FLOOR_FACTOR:g}|plain-plain64|) {floored:.3e}, a "
              f"planted wrong adjoint {planted:.3e} (must exceed 1)")
        ok = (ok and whole <= VJP_ATOL and floored <= 1.0
              and planted > 1.0 and got[1].stride() == out.stride())
    if not ok:
        raise AssertionError(f"{name} disagrees with the NCHW kernel or "
                             "its plain version, or launched another "
                             "kernel")
    worst[name] = max(worst[name], err)
    return got, plain


def check_cl_kernels(torch, kernels, rng):
    """The channels-last tiled kernels at the flagship's shapes:
    ``rqs_coupling`` forward and inverse at B = 1024 and
    ``rqs_coupling_bwd`` at B = 512, on S = 32x16 and 32x32 sites, both
    tail kinds, from ``rng``: each bit for bit against the NCHW tiled
    kernels on the same values (``out.contiguous()``), the forward within
    ``RQS_TOL`` of its plain version, the VJP within ``VJP_ATOL`` of it
    over the tensor and, element by element, within the float64-anchored
    bar (:func:`floored_excess`), which a planted wrong adjoint must
    exceed, ``outbar`` in ``out``'s layout; the plain relative bar's
    reading is printed with where the float64 plain VJP puts each float32
    side.  Then the per-site channels-last kernels on one ragged shape (B S
    % 4 != 0) the same way, against the NCHW per-site kernels.  Then the
    inputs of :func:`check_coupling_at` (its seed, its draws)
    channels-last: every gate that function holds the NCHW kernels to, the
    element-by-element VJP bar with its planted wrong adjoint among them.
    An ``out`` with other strides raises.  Returns the tensors the times
    take."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc

    m = 8
    worst = {"rqs_coupling_cl": 0.0, "rqs_coupling_bwd_cl": 0.0}
    kept = {}
    hold = functools.partial(hold_cl, torch, worst)

    for lat in ((LAT[0], LAT[1] // 2), LAT):
        for b, bwd in ((BATCH, False), (TRAIN_BATCH, True)):
            out = torch.tensor(rng.standard_normal((b, *lat, 3 * m - 2)),
                               dtype=torch.float32, device="cuda")
            out = out.movedim(-1, 1)  # (B, 3m-2, *lat), channels-last
            if (sc.coupling_layout(out),
                    sc.coupling_layout(out.contiguous())) != (
                        "channels_last", "nchw"):
                raise AssertionError("coupling_layout misreads a layout")
            cot = [torch.tensor(rng.standard_normal((b, *lat)),
                                dtype=torch.float32, device="cuda")
                   for _ in range(2)] if bwd else []
            for extrap in (None, "linear"):
                x_np = (rng.uniform(-3.6, 3.6, (b, *lat)) if extrap is None
                        else rng.standard_normal((b, *lat)))
                x = torch.tensor(x_np, dtype=torch.float32, device="cuda")
                for inverse in (False, True):
                    hold(x, out, cot, dict(
                        xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left=extrap,
                        right=extrap, inverse=inverse),
                         f"S={math.prod(lat)} B={b} extrap={extrap}")
            if lat != LAT:
                kept[bwd] = (x, out, cot)

    # a ragged shape, B S % 4 != 0: the per-site channels-last kernels
    lat, b = (5, 7), 3
    out = torch.tensor(rng.standard_normal((b, *lat, 3 * m - 2)),
                       dtype=torch.float32, device="cuda").movedim(-1, 1)
    x = torch.tensor(rng.standard_normal((b, *lat)), dtype=torch.float32,
                     device="cuda")
    cot = [torch.tensor(rng.standard_normal((b, *lat)), dtype=torch.float32,
                        device="cuda") for _ in range(2)]
    for c in ([], cot):
        for inverse in (False, True):
            hold(x, out, c, dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0),
                                 left="linear", right="linear",
                                 inverse=inverse),
                 f"S={math.prod(lat)} B={b} (ragged)", tiled=False)

    # check_coupling_at's inputs and gates, channels-last
    crng = np.random.default_rng(COUPLING_AT_SEED)

    def f32(shape):
        return torch.tensor(crng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    x, out = f32((BATCH, *LAT)), f32((BATCH, 22, *LAT))
    out = out.contiguous(memory_format=torch.channels_last)
    cot = [f32((TRAIN_BATCH, *LAT)), f32((TRAIN_BATCH, *LAT))]
    kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
              right="linear")
    for b in (BATCH, TRAIN_BATCH):
        for inverse in (False, True):
            hold(x[:b], out[:b], [], dict(kw, inverse=inverse),
                 f"S={math.prod(LAT)} B={b} (check_coupling_at's inputs)")
    for inverse in (False, True):
        got, plain = hold(x[:TRAIN_BATCH], out[:TRAIN_BATCH], cot,
                          dict(kw, inverse=inverse),
                          f"S={math.prod(LAT)} B={TRAIN_BATCH} "
                          "(check_coupling_at's inputs)")
        medians = [float(w.abs().median()) for w in plain]
        plant = tuple(g + 0.01 * med for g, med in zip(got, medians))
        ratio = vjp_excess(got, plain, VJP_RTOL)[0]
        planted = vjp_excess(plant, plain, VJP_RTOL)[0]
        print(f"  there: worst |d|/(atol+{VJP_RTOL:g}|plain|) {ratio:.3e} "
              f"(gated as check_coupling_at gates the NCHW kernel); a "
              f"planted wrong adjoint {planted:.3e} (must exceed 1)")
        if not (ratio <= 1.0 and planted > 1.0):
            raise AssertionError("rqs_coupling_bwd_cl fails check_coupling_"
                                 "at's gates on its inputs")

    # other strides: a channels-last tensor with a gap between its sites
    x, out, cot = kept[True]
    wide = torch.zeros((*out.shape[:-1], 2 * out.shape[-1]),
                       device="cuda").contiguous(
                           memory_format=torch.channels_last)[..., ::2]
    for what, call in (("rqs_coupling", lambda: sc.rqs_coupling(
            x, wide, xlim=(-4.0, 4.0), ylim=(-4.0, 4.0))),
                       ("rqs_coupling_bwd", lambda: sc.rqs_coupling_bwd(
                           x, wide, *cot, xlim=(-4.0, 4.0),
                           ylim=(-4.0, 4.0)))):
        try:
            call()
        except ValueError as e:
            print(f"{what} on strides {wide.stride()}: raises ({e})")
        else:
            raise AssertionError(f"{what} took an out with strides "
                                 f"{wide.stride()}")
    for name, replaces, src in (
            ("rqs_coupling_cl", 121, "rqs_coupling.cu"),
            ("rqs_coupling_bwd_cl", 133, "rqs_coupling_bwd.cu")):
        kernels[name] = dict(
            name=name, route="cuda", source=f"normflow__tpu_torch/csrc/{src}",
            replaces=f"normflow__tpu/ops/kernels/spline_coupling.py:"
                     f"{replaces}",
            max_abs_err=worst[name], library_ms=None)
    return kept


def time_cl_kernels(torch, kernels, peaks, kept):
    """Warm and cold times of the channels-last tiled kernels at the
    flagship's shapes, with linear tails (the forward at B = 1024, read
    cold as the NCHW kernel is; the VJP at B = 512, the mean of forward and
    inverse), each followed by the NCHW tiled kernel on the same values
    (``nchw_ms``, ``nchw_ms_cold``) and the per-site channels-last kernel on
    a copy of them 4 bytes off alignment (``sites_ms``,
    ``sites_ms_cold``)."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc
    from normflow__tpu_torch.tools.kernel_times import cold_ms, warm_ms

    times = {}
    for name, bwd in (("rqs_coupling_cl", False),
                      ("rqs_coupling_bwd_cl", True)):
        x, out, cot = kept[bwd]
        nchw = out.contiguous()
        off = offset_copy(torch, out)
        if sc.coupling_layout(off) != "channels_last" or sc.coupling_variant(
                math.prod(out.shape[2:]), [off.data_ptr()], "channels_last",
                out.shape[0]) != "sites":
            raise AssertionError("the offset copy does not take the per-site "
                                 "channels-last kernel")
        fn, plain = ((sc.rqs_coupling_bwd, sc.rqs_coupling_vjp_plain) if bwd
                     else (sc.rqs_coupling, sc.rqs_coupling_plain))
        times[name] = {}
        for what, inverse in (("forward", False), ("inverse", True)):
            kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                      right="linear", inverse=inverse)
            t = times[name][what] = kernel_times(
                name, lambda: fn(x, out, *cot, **kw),
                lambda: plain(x, out, *cot, **kw))
            twin = lambda: fn(x, nchw, *cot, **kw)  # noqa: E731
            t["nchw_ms"], t["nchw_ms_cold"] = warm_ms(twin), cold_ms(twin)
            sites = lambda: fn(x, off, *cot, **kw)  # noqa: E731
            t["sites_ms"], t["sites_ms_cold"] = warm_ms(sites), cold_ms(sites)
            print(f"{name} {what} at {tuple(out.shape)}: the tiled kernel "
                  f"warm {t['ms']:.5f} ms, cold {t['ms_cold']:.5f} ms; right "
                  f"after, the NCHW tiled kernel on the same values: warm "
                  f"{t['nchw_ms']:.5f} ms, cold {t['nchw_ms_cold']:.5f} ms; "
                  f"the per-site channels-last kernel on them 4 bytes off: "
                  f"warm {t['sites_ms']:.5f} ms, cold "
                  f"{t['sites_ms_cold']:.5f} ms")
    report("rqs_coupling_cl", times["rqs_coupling_cl"]["forward"],
           tuple(kept[False][1].shape), peaks, kernels, "cold")
    bwd = times["rqs_coupling_bwd_cl"]
    report("rqs_coupling_bwd_cl",
           {k: (bwd["forward"][k] + bwd["inverse"][k]) / 2
            for k in bwd["forward"]}, tuple(kept[True][1].shape), peaks,
           kernels, "cold")
    for name, t in times.items():
        kernels[name]["variants"] = t


def hold_cl_on_path(torch, kernels, arm, x):
    """:func:`hold_on_path` on the channels-last route: the first
    coupling's active partition and its conditioner's output as the route
    hands it over (channels-last, no copy), kernels 1 and 3 against their
    plain versions (``RQS_TOL``, ``PHI4_REL_TOL``)."""
    from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc

    net = arm.net_
    cpl = net[2]
    with torch.no_grad():
        h = net[1].forward(*net[0].forward(x))[0]
        x_act, x_frz = cpl.mask.split(h)[:2]
        out = cpl.nets[0](cpl._net_input(x_frz))
        y = net.forward(x)[0]
    if out.dtype != torch.float32 or \
            sc.coupling_layout(out) != "channels_last":
        raise AssertionError(f"the conditioner returned {out.dtype}, "
                             f"strides {out.stride()}")
    kw = dict(xlim=cpl.xlim, ylim=cpl.ylim, left="linear", right="linear")
    got = sc.rqs_coupling(x_act, out, **kw)
    want = sc.rqs_coupling_plain(x_act, out, **kw)
    w = arm.action.get_coef(2)
    s_got, s_want = phi4.phi4_action(y, *w), phi4.phi4_action_plain(y, *w)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    diff = (s_got - s_want).abs()
    rel = float((diff / s_want.abs().clamp(min=1.0)).max())
    print(f"{out.dtype} path's inputs via {cpl.nets[0].net.compute_dtype} "
          f"conditioners: rqs_coupling_cl {tuple(out.shape)} strides "
          f"{out.stride()} vs plain max |d| {err:.3e} (tol {RQS_TOL}); "
          f"phi4_action vs plain max rel {rel:.3e} (tol {PHI4_REL_TOL})")
    if not (err <= RQS_TOL and rel <= PHI4_REL_TOL):
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the channels-last bf16 path's inputs")
    kernels["rqs_coupling_cl"]["max_abs_err"] = max(
        kernels["rqs_coupling_cl"]["max_abs_err"], err)


def layout_profile(fn, what, reps=4):
    """The conv kernels' share of ``fn``'s device time, the ms per call of
    the transposes between NCHW and NHWC (:data:`TRANSPOSE_RE`) and of the
    eight kernels that take the most, printed; ``fn`` run ``reps`` times in
    a profiled window."""
    dev = device_profile(fn, reps)[1]
    busy = sum(us for _, us in dev)
    conv = sum(us for n, us in dev if CONV_RE.search(n))
    tr = [(n, us) for n, us in dev if TRANSPOSE_RE.search(n)]
    print(f"{what}: device time {busy / reps / 1e3:.4f} ms, conv kernels "
          f"{conv / reps / 1e3:.4f} ms (share {conv / busy:.4f}), "
          f"{len(tr) // reps} NCHW<->NHWC transposes "
          f"{sum(us for _, us in tr) / reps / 1e3:.4f} ms per call")
    by_name: dict = {}
    for n, us in dev:
        count, total = by_name.get(n, (0, 0.0))
        by_name[n] = (count + 1, total + us)
    for n, (count, us) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / reps / 1e3:9.4f} ms {count // reps:4d}x "
              f"{n[:100]}")


def run_channels_last(torch, kernels, peaks, card, model4, step_rng):
    """The channels-last route (``coupling_backend="pallas_reg"``) at the
    flagship's widths, on a numpy stream of its own, after every other
    phase: the kernels (:func:`check_cl_kernels`); the sampling flagship
    (seeded perturbed weights) against a float64 CPU copy, its
    ``logqp_stream(32, 1024)`` profiled with the counters set to 0 just
    before (4 channels-last couplings and 1 tiled action per batch, no
    NCHW coupling), 3 replayed batches bit for bit with their eager bodies
    (cuDNN's deterministic algorithms), replays alone by name,
    ``mcmc.sample__``; one path-gradient step against a float64 CPU copy
    on the inputs of phase 5's (``model4``, phase 4's flagship, on the
    route, and the draw of ``step_rng``, the numpy stream's state before
    phase 5 took it), and one on the sampling flagship's weights and a
    fresh draw, its per-leaf bars at the float32 floor
    (``check_train_grads(floor=True)``); ``CL_STEPS`` steps of
    ``model.fit`` profiled likewise (8 / 8 / 1 / 1 per step, the couplings
    and VJPs channels-last and tiled), 10 replayed steps against 10 eager
    bodies bit for bit under cuDNN's deterministic algorithms (and within
    ``REPLAY_*``) and replays alone by name; the bf16 copy on the
    route (kernels at its inputs, replays by name); then, printed and not
    gated, raw samples/s against the NCHW route in turns, where a
    replayed batch's time goes (the conv kernels, cuDNN's layout
    transposes, the costliest kernels), for both routes in float32 and
    bf16, and replayed float32 training steps/s against the NCHW route in
    turns with where a replayed step's time goes on each; and the kernels'
    times."""
    from normflow__tpu_torch import Model, calc_ess
    from normflow__tpu_torch.tools.kernel_times import (device_launches,
                                                         perturb_)
    from normflow__tpu_torch.zoo import (build_phi4_model,
                                         with_conv_compute_dtype,
                                         with_coupling_backend)

    rng = np.random.default_rng(CL_SEED)
    kept = check_cl_kernels(torch, kernels, rng)

    model = build_phi4_model(LAT, seed=0, coupling_backend="pallas_reg")
    perturb_(model.net_, rng)
    cpu = build_phi4_model(LAT, seed=0, device="cpu", dtype=torch.float64,
                           coupling_backend="pallas_reg")
    cpu.net_.load_state_dict({k: v.double().cpu() for k, v in
                              model.net_.state_dict().items()})
    x = rng.standard_normal((BATCH, *LAT))
    with torch.no_grad():
        xg = torch.tensor(x, dtype=torch.float32, device="cuda")
        logq = (model.prior.log_prob(xg) - model.net_.forward(xg)[1]).cpu()
        x64 = torch.tensor(x, dtype=torch.float64)
        want = cpu.prior.log_prob(x64) - cpu.net_.forward(x64)[1]
    rel = float(((logq.double() - want).abs() / want.abs().clamp(min=1.0))
                .max())
    print(f"channels-last flagship, GPU vs a float64 CPU copy: max rel logq "
          f"{rel:.3e} (tol {LOGQ_REL_TOL})")
    if not rel <= LOGQ_REL_TOL:
        raise AssertionError("the channels-last flagship disagrees with its "
                             "float64 CPU copy")

    per_batch = {"rqs_coupling_cl": len(model.net_[2].nets), "phi4_action": 1}
    reset_cl_counts()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(N_BATCHES, BATCH))
    gate_cl_path(kernels, "channels-last sample", per_batch, N_BATCHES,
                 device)
    if logqp.shape != (N_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("the channels-last logqp stream is not finite "
                             "or has the wrong shape")
    print(f"channels-last logqp_stream({N_BATCHES}, {BATCH}): ESS "
          f"{float(calc_ess(logqp)):.5f} (perturbed weights)")
    post = model.posterior
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    post._graphs.clear()  # captured anew with these algorithms
    try:
        model.seed(21)
        got = post.logqp_stream(3, BATCH)
        model.seed(21)
        want = torch.cat([post.logqp_batch(BATCH, model.generator)
                          for _ in range(3)])
    finally:
        torch.backends.cudnn.deterministic = flag
        post._graphs.clear()
    same = same_bits(torch, (got,), (want,))
    print(f"channels-last replayed vs eager batch, 3 x {BATCH}, cuDNN "
          f"deterministic: {'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("a channels-last replayed batch differs from "
                             "its eager body")
    post.logqp_stream(1, BATCH)  # captured outside the profiled window
    gate_replays(cl_counters(), kernels, "channels-last sample", per_batch,
                 4, lambda: post.logqp_stream(4, BATCH))
    y, lq, lp = model.mcmc.sample__(BATCH)
    torch.cuda.synchronize()
    if y.shape != (BATCH, *LAT) or not all(
            bool(torch.isfinite(t).all()) for t in (y, lq, lp)):
        raise AssertionError("channels-last MCMC output not finite or wrong "
                             "shape")
    print(f"channels-last mcmc.sample__({BATCH}): accept rate "
          f"{model.mcmc.history.accept_rate}")

    check_train_grads(torch, Model(
        net_=with_coupling_backend(model4.net_, "pallas_reg"),
        prior=model4.prior, action=model4.action, seed=0), step_rng,
                      backend="pallas_reg")
    # and on this phase's perturbed weights and a fresh draw, per-leaf bars
    # at the float32 floor
    check_train_grads(torch, model, rng, backend="pallas_reg", floor=True)
    trained = build_phi4_model(LAT, seed=0, coupling_backend="pallas_reg")
    n = len(trained.net_[2].nets)
    per_step = {"rqs_coupling_cl": 2 * n, "rqs_coupling_bwd_cl": 2 * n,
                "phi4_action": 1, "phi4_action_grad": 1}
    reset_cl_counts()
    device, hist = device_launches(lambda: fit_protocol(trained, CL_STEPS))
    gate_cl_path(kernels, "channels-last train", per_step, CL_STEPS, device)
    loss = np.asarray(hist["loss"])
    print(f"channels-last model.fit, {CL_STEPS} steps: loss {loss[0]:.3f} "
          f"-> {loss[-1]:.3f}")
    if loss.shape != (CL_STEPS,) or not np.isfinite(loss).all():
        raise AssertionError("channels-last training loss not finite")
    # cuDNN's NHWC float32 weight gradients sum in another order from run to
    # run (losses 1.1e-05 apart over 10 steps on some cards): bits under its
    # deterministic algorithms, as phases 13-20 hold theirs
    replayed_vs_eager_steps(torch, trained, what="channels-last: ",
                            deterministic=True)
    trained.fit.step()  # captured anew outside the profiled window
    gate_replays(cl_counters(), kernels, "channels-last train", per_step, 4,
                 lambda: [trained.fit.step() for _ in range(4)])

    arms = {"float32 NCHW": Model(
                net_=with_coupling_backend(model.net_, "xla"),
                prior=model.prior, action=model.action, seed=0),
            "float32 channels-last": model}
    for what in ("NCHW", "channels-last"):
        arms[f"bf16 {what}"] = Model(
            net_=with_conv_compute_dtype(arms[f"float32 {what}"].net_,
                                         torch.bfloat16),
            prior=model.prior, action=model.action, seed=0)
    bf16 = arms["bf16 channels-last"]
    xd = torch.tensor(rng.standard_normal((BATCH, *LAT)),
                      dtype=torch.float32, device="cuda")
    hold_cl_on_path(torch, kernels, bf16, xd)
    bf16.posterior.logqp_stream(1, BATCH)
    gate_replays(cl_counters(), kernels, "channels-last bf16 sample",
                 per_batch, 4, lambda: bf16.posterior.logqp_stream(4, BATCH))
    in_turns(torch, card, "NCHW vs channels-last conditioners, sampling, "
             "graphed", "raw samples/s", N_BATCHES * BATCH,
             {k: (lambda m=m: m.posterior.logqp_stream(N_BATCHES, BATCH))
              for k, m in arms.items()})
    for what, m in arms.items():
        layout_profile(lambda m=m: m.posterior.logqp_stream(1, BATCH),
                       f"one replayed {what} sampled batch of {BATCH}")
    nchw = build_phi4_model(LAT, seed=0)
    fit_protocol(nchw, 8)
    steps = {"NCHW": nchw, "channels-last": trained}
    in_turns(torch, card, f"NCHW vs channels-last route, replayed float32 "
             f"training steps at batch {TRAIN_BATCH} (after the profiler "
             f"has run in this process)", "steps/s", 10,
             {k: (lambda m=m: [m.fit.step() for _ in range(10)])
              for k, m in steps.items()})
    for what, m in steps.items():
        layout_profile(m.fit.step, f"one replayed float32 {what} training "
                       f"step at batch {TRAIN_BATCH}")
    time_cl_kernels(torch, kernels, peaks, kept)


# --------------------------------------------------------------------- #
# Phase 23: phi^4 on 4-D lattices
# --------------------------------------------------------------------- #
# the 4-D flagship: build_phi4_model(LAT4, packed=False) at the flagship's
# widths (ConvNet 1->24->24->22 with 3^4 circular kernels by roll-and-sum,
# 8 knots, 4 couplings over EvenOddMask, the PSD block's 4-D FFT), the
# flagship's action (kappa 0.6, m^2 -2.4, lambda 0.5), on numpy streams of
# its own (LAT4_SEED)
LAT4 = (8, 8, 8, 8)
LAT4_SEED = 20261023
LAT4_BATCHES = 8      # the profiled logqp_stream(LAT4_BATCHES, BATCH)
LAT4_TURNS = 2        # batches per timed run in turns (one step a run)
LAT4_LOGQ_DRAWS = 8   # draws of the logq check against float64
# one path-gradient step against float64 at LAT4_STEP_BATCH: a float64
# CPU step at 8^4 takes about 1 s per sample (0.9 s on 8 CPU cores), so
# the check runs on fewer samples than the fit's 512
LAT4_STEP_BATCH = 4
# the profiled fit at batch TRAIN_BATCH: a step of the 8^4 flagship takes
# ~1.7 s on an H100 (48 steps: 86 s), ~3 s under cuDNN's deterministic
# algorithms, so the phase fits LAT4_STEPS
LAT4_STEPS = 2
# the bench protocol's settings but the learning rate: at 3e-3 Adam's
# first step, ~lr a weight, moves a 3^4 conv's outputs 9 times as far as a
# 3x3 conv's (fan-in 1944 against 216), and the 4-D flagship's loss goes
# to NaN within 5 steps in both packages (4^4, batch 128, CPU: JAX -46.1,
# 5954, 15627, 22726, nan; the port -46.1, 7077, nan); 3e-3 / 9 ~ 3e-4
LAT4_LR = 3e-4
# the free field at 4^4 (lambda 0): <phi^2> is exact; FREE_STEPS training
# steps at TRAIN_BATCH, then FREE_ROUNDS chain rounds of BATCH (the first
# dropped)
FREE_LAT = (4, 4, 4, 4)
FREE_ACTION = dict(kappa=1.0, m_sq=1.0, lambd=0.0)
FREE_STEPS, FREE_ROUNDS = 32, 65
# the path's variants on 4-D lattices: the coupling and its VJP tiled
# (4096 sites a sample), the action and its force on the tiled nd kernels
LAT4_TILED = {"rqs_coupling": True, "rqs_coupling_bwd": True,
              "phi4_action": True, "phi4_action_grad": True,
              "accept_scan": False}
# the tiled nd kernels' records by wrapper: on a 3-D or 4-D lattice every
# tiled launch of kernel 3 or 4 is theirs (the 2-D tile takes 2-D only)
ND_RECORDS = {"phi4_action": "phi4_action_tiled_nd",
              "phi4_action_grad": "phi4_action_grad_tiled_nd"}
# the shapes at which phase 23 holds and times them, the wrapper of each
# (the 8^4 flagship's batch and chain round, its step, and the (8, 8, 8)
# route flagship's lattice)
ND_CASES = (("phi4_action", (BATCH, *LAT4)),
            ("phi4_action_grad", (TRAIN_BATCH, *LAT4)),
            ("phi4_action", (TRAIN_BATCH, *LAT4)),
            ("phi4_action_grad", (BATCH, *LAT4)),
            ("phi4_action", (BATCH, 8, 8, 8)),
            ("phi4_action_grad", (BATCH, 8, 8, 8)))


def record_nd(kernels, path, counts, what="launches_by_path"):
    """Keep the phi4 wrappers' ``counts`` on ``path``, a run on a 3-D or
    4-D lattice whose every launch of kernels 3 and 4 the caller's gate
    held tiled, under the tiled nd kernels' records (``what``)."""
    for k, nd in ND_RECORDS.items():
        if k in counts:
            n = counts[k]
            kernels[nd][what][path] = n[0] if isinstance(n, tuple) else n


def general_phi4(torch, cfgs, w, g=None, halo=None):
    """The general kernels' action of ``cfgs`` (given ``g``, its force)
    through their C entries, ``phi4_action_f32`` and
    ``phi4_action_grad_f32``, or with ``halo`` the slab's through
    ``phi4_action_slab_f32`` and ``phi4_action_grad_slab_f32``: no wrapper
    counts it."""
    from normflow__tpu_torch.ops.kernels import _lib

    lib = _lib.library()
    lat = list(cfgs.shape[1:]) + [1] * (5 - cfgs.dim())
    stream = torch.cuda.current_stream().cuda_stream
    rows = () if halo is None else (halo.data_ptr(),)
    shape = (cfgs.shape[0], cfgs.dim() - 1, *lat, *w, stream)
    if g is None:
        out = torch.empty(cfgs.shape[0], device=cfgs.device)
        entry = lib.phi4_action_f32 if halo is None \
            else lib.phi4_action_slab_f32
        err = entry(cfgs.data_ptr(), *rows, out.data_ptr(), *shape)
    else:
        out = torch.empty_like(cfgs)
        entry = lib.phi4_action_grad_f32 if halo is None \
            else lib.phi4_action_grad_slab_f32
        err = entry(cfgs.data_ptr(), *rows, g.data_ptr(), out.data_ptr(),
                    *shape)
    _lib.check(err, "the general phi4 entry")
    return out


def check_phi4_4d(torch, kernels, peaks):
    """Phase 23, step 1 (with the kernel checks of phase 2): phi4_action
    and phi4_action_grad on the tiled nd kernels at ``ND_CASES``' shapes,
    (1024, 8, 8, 8, 8), (512, 8, 8, 8, 8) and (1024, 8, 8, 8), against
    their plain versions (``PHI4_REL_TOL``, ``FORCE_*``) and against the
    general kernels through their C entries (the action within
    ``PHI4_REL_TOL``, the force bit for bit), each launch tiled;
    at an odd (64, 3, 5, 4, 6) on the general kernels against their plain
    versions (the slab kernels at 4-D: :func:`check_slab_kernels`); a 5-D
    field refused.  Returns the function that names the
    tiled nd kernels' launches by profiler and times them, warm and cold,
    in turns with the general ones."""
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.ops.kernels import phi4

    rng = np.random.default_rng(LAT4_SEED)

    def f32(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    w = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(4)
    field, g = f32((BATCH, *LAT4)), f32(BATCH)
    odd, godd = f32((64, 3, 5, 4, 6)), f32(64)
    field3 = f32((BATCH, 8, 8, 8))
    w3 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(3)
    nd_cases = []  # (kernel, shape, wrapper call, plain call, general call)
    for name, shape in ND_CASES:
        c = (field if len(shape) == 5 else field3)[:shape[0]]
        gg, ww = g[:shape[0]], (w if len(shape) == 5 else w3)
        if name == "phi4_action":
            nd_cases.append((name, shape,
                             lambda c=c, ww=ww: phi4.phi4_action(c, *ww),
                             lambda c=c, ww=ww: phi4.phi4_action_plain(c,
                                                                       *ww),
                             lambda c=c, ww=ww: general_phi4(torch, c, ww)))
        else:
            nd_cases.append((
                name, shape,
                lambda c=c, gg=gg, ww=ww: phi4.phi4_action_grad(c, gg, *ww),
                lambda c=c, gg=gg, ww=ww: phi4.phi4_action_grad_plain(
                    c, gg, *ww),
                lambda c=c, gg=gg, ww=ww: general_phi4(torch, c, ww, gg)))
    cases = [("phi4_action", (64, 3, 5, 4, 6),
              lambda: phi4.phi4_action(odd, *w),
              lambda: phi4.phi4_action_plain(odd, *w)),
             ("phi4_action_grad", (64, 3, 5, 4, 6),
              lambda: phi4.phi4_action_grad(odd, godd, *w),
              lambda: phi4.phi4_action_grad_plain(odd, godd, *w))]
    for name, nd in ND_RECORDS.items():
        kernels[nd] = dict(
            name=nd, route="cuda",
            source="normflow__tpu_torch/csrc/phi4_action.cu",
            replaces=kernels[name]["replaces"], max_abs_err=0.0,
            library_ms=None, launches_by_path={},
            replay_launches_per_unit={})
    counters = {**{k: c for k, c in _counters().items()
                   if k in ("phi4_action", "phi4_action_grad")},
                **slab_counters()}

    def hold(name, shape, got, want, what):
        d = (got.double() - want.double()).abs()
        if name == "phi4_action":
            rel = float((d / want.double().abs().clamp(min=1.0)).max())
            ok, bar = rel <= PHI4_REL_TOL, (f"max rel {rel:.3e} (tol "
                                            f"{PHI4_REL_TOL})")
        else:
            ok = bool((d <= FORCE_ATOL + FORCE_RTOL * want.abs()).all())
            bar = (f"max abs {float(d.max()):.3e} (rtol {FORCE_RTOL}, atol "
                   f"{FORCE_ATOL})")
        print(f"{name} at {shape}, {what}: {bar} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}")
        return float(d.max())

    reset_counts(counters)
    for name, shape, fn, plain, general in nd_cases:
        if phi4.action_variant(shape[1:], 1 << 20) != "tiled_nd":
            raise AssertionError(f"{shape} does not take the tiled nd "
                                 "kernels")
        got, want, gen = fn(), plain(), general()
        torch.cuda.synchronize()
        err = hold(name, shape, got, want, "tiled nd kernel vs plain")
        nd = ND_RECORDS[name]
        kernels[nd]["max_abs_err"] = max(kernels[nd]["max_abs_err"], err)
        if name == "phi4_action":
            hold(name, shape, got, gen, "tiled nd vs general kernel")
        else:
            same = same_bits(torch, (got,), (gen,))
            print(f"{name} at {shape}: tiled nd vs general kernel "
                  f"{'bit for bit' if same else 'NOT bit-identical'}")
            if not same:
                raise AssertionError("the tiled nd force departs from the "
                                     f"general force at {shape}")
    tiled = {k: (c.launches, c.tiled_launches) for k, c in counters.items()}
    print(f"tiled nd checks: wrapper (launches, tiled) {tiled}")
    if tiled != {"phi4_action": (3, 3), "phi4_action_grad": (3, 3),
                 "phi4_action_slab": (0, 0),
                 "phi4_action_slab_grad": (0, 0)}:
        raise AssertionError("a tiled nd check missed its kernel")

    reset_counts(counters)
    for name, shape, fn, plain in cases:
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = hold(name, shape, got, want, "general kernel")
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    launches = {k: c.launches for k, c in counters.items()}
    print(f"4-D general checks: wrapper launches {launches}")
    if launches != {"phi4_action": 1, "phi4_action_grad": 1,
                    "phi4_action_slab": 0, "phi4_action_slab_grad": 0}:
        raise AssertionError("a 4-D check missed its kernel")
    check_tiled(counters, "4-D general checks", tiled=False)
    try:
        phi4.phi4_action(torch.zeros((2, 2, 2, 2, 2, 2), device="cuda"),
                         *w)
    except ValueError as e:
        print(f"a 5-D field on the card: refused ({e})")
    else:
        raise AssertionError("phi4_action took a 5-D field")

    def time_it():
        """First, by profiler name (no profiler runs before the rates in
        turns), one launch of each tiled nd kernel at the 8^4 batch and
        step.  Then the tiled nd kernels at ``ND_CASES``' shapes, warm and
        cold, in turns with the general kernels on the same tensors
        (general, tiled nd, tiled nd, general): the record's times, read
        warm, at the 8^4 batch's action and step's force, the rest under
        ``variants``, the general kernels' beside them
        (``general_in_turns``); the odd shape, general, read warm, under
        ``variants``."""
        from normflow__tpu_torch.tools.kernel_times import cold_ms, warm_ms

        dev = device_profile(lambda: (nd_cases[0][2](), nd_cases[1][2]()),
                             1)[1]
        names = [n for n, _ in dev if "phi4_action" in n]
        print(f"the 8^4 batch's action and step's force, by profiler name: "
              f"{names}")
        if len(names) != 2 or not re.search(
                r"\bphi4_action_tiled_nd_kernel\b", names[0]) or not \
                re.search(r"\bphi4_action_grad_tiled_nd_kernel\b", names[1]):
            raise AssertionError("the 8^4 shapes did not launch the tiled nd "
                                 "kernels")
        for name, shape, fn, plain, general in nd_cases:
            nd = ND_RECORDS[name]
            gen = [dict(ms=warm_ms(general), ms_cold=cold_ms(general))]
            t = kernel_times(name, fn, plain, plain_reps=5)
            again = dict(ms=warm_ms(fn), ms_cold=cold_ms(fn))
            gen.append(dict(ms=warm_ms(general), ms_cold=cold_ms(general)))
            print(f"{nd} at {shape} in turns with the general kernel: "
                  f"general {gen[0]['ms']:.5f} / {gen[0]['ms_cold']:.5f}, "
                  f"tiled nd {t['ms']:.5f} / {t['ms_cold']:.5f}, "
                  f"{again['ms']:.5f} / {again['ms_cold']:.5f}, general "
                  f"{gen[1]['ms']:.5f} / {gen[1]['ms_cold']:.5f} ms (warm / "
                  f"cold)")
            kernels[nd].setdefault("general_in_turns", {})[str(shape)] = gen
            if (name, shape) in ND_CASES[:2]:
                report(nd, t, shape, peaks, kernels, "warm")
            else:
                record_variant(nd, f"{shape} tiled nd", t, shape, peaks,
                               kernels)
        for name, shape, fn, plain in cases:
            record_variant(name, f"{shape} general (4-D)",
                           kernel_times(name, fn, plain, plain_reps=5),
                           shape, peaks, kernels)

    return time_it


def exact_free_phi2(lat, action):
    """<phi^2> of the free field (``lambd`` 0) on the periodic lattice
    ``lat``, from ``get_coef``'s quadratic form S = sum_x w2 phi_x^2 - w0
    sum_{x,mu} phi_x phi_{x+mu}: (1/V) sum_p 1 / (2 w2 - 2 w0 sum_mu cos
    p_mu), which at a = 1 is (1/V) sum_p 1 / (m^2 + 4 kappa sum_mu
    sin^2(p_mu / 2))."""
    w0, w2, w4 = action.get_coef(len(lat))
    if w4 != 0.0:
        raise ValueError("the free field has no phi^4 term")
    p = np.meshgrid(*[2 * np.pi * np.arange(n) / n for n in lat],
                    indexing="ij")
    return float(np.mean(1.0 / (2 * w2 - 2 * w0 * sum(np.cos(q)
                                                         for q in p))))


def run_4d(torch, kernels, card):
    """Phase 23: the 4-D flagship at 8^4 (``build_phi4_model(LAT4,
    packed=False)``) with seeded perturbed weights: logq against a float64
    CPU copy; ``logqp_stream(LAT4_BATCHES, 1024)`` profiled, the counters
    set to 0 just before (4 ``rqs_coupling``, tiled, and 1 ``phi4_action``,
    general, per batch), a replayed batch against its eager body bit for
    bit and by name, where its time goes, raw samples/s eager and graphed
    in turns; one graphed chain round of 1024 (4 / 1 / 1 ``accept_scan``),
    against its eager body bit for bit; then a fresh 8^4 flagship: one
    path-gradient step against float64 with the per-leaf bars
    (``LAT4_STEP_BATCH``), ``LAT4_STEPS`` steps of :func:`fit_protocol`
    at ``LAT4_LR`` profiled with the counters set to 0 just before (8 / 8 / 1 / 1 per
    step), all under cuDNN's deterministic algorithms (:func:`train_4d`);
    last, the free field (:func:`run_free_field`).  Returns what phase 24
    reuses: the sampling flagship, the logq check's draws and their float64
    logq, and the trained flagship with its captured step."""
    from normflow__tpu_torch import calc_ess
    from normflow__tpu_torch.tools.kernel_times import (device_launches,
                                                         perturb_)
    from normflow__tpu_torch.zoo import build_phi4_model

    t_phase = time.perf_counter()
    marks = []

    def mark(what):
        marks.append((what, round(time.perf_counter() - t_phase, 1)))

    rng = np.random.default_rng(LAT4_SEED + 1)
    model = build_phi4_model(LAT4, packed=False, seed=0)
    perturb_(model.net_, rng)
    n_par = sum(p.numel() for p in model.net_.parameters())
    print(f"4-D flagship {LAT4}: {n_par} parameters on {model.device}")
    cpu = build_phi4_model(LAT4, packed=False, seed=0, device="cpu",
                           dtype=torch.float64)
    cpu.net_.load_state_dict({k: v.double().cpu() for k, v in
                              model.net_.state_dict().items()})
    x = rng.standard_normal((LAT4_LOGQ_DRAWS, *LAT4))
    logq = []
    with torch.no_grad():
        for m, dtype in ((model, torch.float32), (cpu, torch.float64)):
            t0 = time.perf_counter()
            xd = torch.tensor(x, dtype=dtype, device=m.device)
            logq.append((m.prior.log_prob(xd) - m.net_.forward(xd)[1])
                        .double().cpu())
    rel = float(((logq[0] - logq[1]).abs()
                 / logq[1].abs().clamp(min=1.0)).max())
    print(f"4-D GPU vs float64 CPU forward, {LAT4_LOGQ_DRAWS} draws: max rel "
          f"logq {rel:.3e} (tol {LOGQ_REL_TOL}); the CPU copy took "
          f"{time.perf_counter() - t0:.2f} s")
    if not rel <= LOGQ_REL_TOL:
        raise AssertionError("GPU and CPU 4-D flagship disagree")
    del cpu
    mark("logq")

    n_layers = len(model.net_[2].nets)
    per_batch = {"rqs_coupling": n_layers, "phi4_action": 1}
    counters = path_counters(per_batch)
    reset_counts(counters)
    t0 = time.perf_counter()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(LAT4_BATCHES, BATCH))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "4d sample", per_batch, LAT4_BATCHES,
              device, LAT4_TILED, nd=True)
    if logqp.shape != (LAT4_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("the 4-D logqp stream is not finite or has "
                             "the wrong shape")
    print(f"4-D logqp_stream({LAT4_BATCHES}, {BATCH}): ESS "
          f"{float(calc_ess(logqp)):.5f} (random perturbed weights); the "
          f"first call, capture included, profiled, {seconds:.2f} s on "
          f"{card}")
    post, gen = model.posterior, model.generator
    model.seed(21)
    got = post.logqp_stream(1, BATCH)
    model.seed(21)
    want = post.logqp_batch(BATCH, gen)
    same = same_bits(torch, (got,), (want,))
    print(f"4-D replayed vs eager batch of {BATCH}: "
          f"{'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("a 4-D replayed batch differs from its eager "
                             "body")
    gate_replays(counters, kernels, "4d sample", per_batch, 1,
                 lambda: post.logqp_stream(1, BATCH), tiled=LAT4_TILED,
                 nd=True)
    profile_step(lambda: post.logqp_stream(1, BATCH),
                 f"one replayed 4-D sampled batch of {BATCH}")
    in_turns(torch, card, f"4-D flagship {LAT4} sampling, "
             f"{LAT4_TURNS} batches of {BATCH}", "raw samples/s",
             LAT4_TURNS * BATCH,
             {"eager": lambda: [post.logqp_batch(BATCH, gen)
                                for _ in range(LAT4_TURNS)],
              "graphed": lambda: post.logqp_stream(LAT4_TURNS, BATCH)},
             runs=1, warm=True)
    mark("sampling")

    mcmc = model.mcmc
    per_round = {**per_batch, "accept_scan": 1}
    counters = path_counters(per_round)
    reset_counts(counters)
    device, out = device_launches(lambda: mcmc.sample_chain(1, BATCH))
    gate_path(counters, kernels, "4d chain", per_round, 1, device,
              LAT4_TILED, nd=True)
    if out["logq"].shape != (1, BATCH) or not bool(
            torch.isfinite(out["logq"]).all()):
        raise AssertionError("the 4-D chain's output is not finite or has "
                             "the wrong shape")
    mcmc.reset()
    model.seed(31)
    got = mcmc.sample_chain(1, BATCH, collect_samples=True)
    ref = mcmc._ref
    model.seed(31)
    carry = [torch.zeros(LAT4, device="cuda"),
             torch.tensor(math.inf, device="cuda"),
             torch.zeros((), device="cuda")]
    r = mcmc.chain_body(BATCH, gen, carry)
    same = same_bits(torch, (got["logq"], got["logp"], got["accept_rate"],
                             got["samples"], *ref),
                     (*(r[k][None] for k in (1, 2, 3, 0)), *carry))
    print(f"4-D sample_chain(1, {BATCH}) graphed vs its eager round from "
          f"one generator state: logq, logp, accept rate, samples and the "
          f"final _ref {'bit for bit' if same else 'NOT bit-identical'}; "
          f"accept rate {float(got['accept_rate'].mean()):.4f}")
    if not same:
        raise AssertionError("a graphed 4-D chain round differs from its "
                             "eager body")
    del post, mcmc, got, ref, carry, r, logqp
    mark("chain")

    trained = build_phi4_model(LAT4, packed=False, seed=0)
    check_train_grads(torch, trained, rng, packed=False, lat=LAT4,
                      batch=LAT4_STEP_BATCH)
    mark("step vs float64")
    counters = _counters()
    per_step = {"rqs_coupling": 2 * n_layers,
                "rqs_coupling_bwd": 2 * n_layers, "phi4_action": 1,
                "phi4_action_grad": 1}
    # the step is captured under cuDNN's deterministic algorithms, so a
    # replay and an eager body can be held bit for bit without a second
    # capture (a step takes ~1.7 s)
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train_4d(torch, kernels, trained, counters, per_step, card)
    finally:
        torch.backends.cudnn.deterministic = flag
    mark("fit, replays, profile")
    run_free_field(torch, card)
    mark("free field")
    print(f"phase 23 (4-D) took {time.perf_counter() - t_phase:.1f} s on "
          f"{card}; seconds at its marks: {marks}")
    return dict(model=model, x=x, logq64=logq[1], trained=trained)


def train_4d(torch, kernels, trained, counters, per_step, card):
    """Phase 23's training: ``LAT4_STEPS`` steps of :func:`fit_protocol`
    at ``LAT4_LR`` profiled, the counters set to 0 just before, gated by
    name and by wrapper; a replayed step by name and where its time goes;
    a replayed step against an eager one bit for bit.  Its graphed steps/s
    are taken in phase 24, in turns with the channels-last route's."""
    from normflow__tpu_torch.tools.kernel_times import device_launches

    reset_counts(counters)
    t0 = time.perf_counter()
    device, hist = device_launches(lambda: fit_protocol(
        trained, LAT4_STEPS, lr=LAT4_LR, decay_steps=LAT4_STEPS))
    seconds = time.perf_counter() - t0
    gate_path(counters, kernels, "4d train", per_step, LAT4_STEPS, device,
              LAT4_TILED, nd=True)
    loss = np.asarray(hist["loss"])
    print(f"4-D model.fit: {LAT4_STEPS} steps at batch {TRAIN_BATCH}, lr "
          f"{LAT4_LR}, in {seconds:.2f} s (capture included, profiled) on "
          f"{card}; loss {np.round(loss, 2).tolist()}")
    if loss.shape != (LAT4_STEPS,) or not np.isfinite(loss).all():
        raise AssertionError("the 4-D training loss is not finite")
    fit = trained.fit
    gate_replays(counters, kernels, "4d train", per_step, 1, fit.step,
                 tiled=LAT4_TILED, nd=True)
    profile_step(fit.step, f"one replayed 4-D training step at batch "
                 f"{TRAIN_BATCH}", reps=1)
    replayed_vs_eager_steps(torch, trained, "4-D: ", n=1, captured=True)



def run_free_field(torch, card):
    """The flagship's architecture at ``FREE_LAT`` on the free field
    (``FREE_ACTION``: kappa 1, m^2 1, lambda 0), trained ``FREE_STEPS``
    steps at batch ``TRAIN_BATCH`` (:func:`fit_protocol` at ``LAT4_LR``);
    then
    ``sample_chain(FREE_ROUNDS, BATCH)``, the first round dropped: <phi^2>
    (each state's lattice mean of phi^2, binned errors) within
    ``OBS_SIGMAS`` of :func:`exact_free_phi2`."""
    from normflow__tpu_torch.examples.u1_gauge import binned
    from normflow__tpu_torch.zoo import build_phi4_model

    t0 = time.perf_counter()
    model = build_phi4_model(FREE_LAT, packed=False, seed=0, **FREE_ACTION)
    hist = fit_protocol(model, FREE_STEPS, lr=LAT4_LR,
                        decay_steps=FREE_STEPS)
    loss = np.asarray(hist["loss"])
    trained = time.perf_counter() - t0
    out = model.mcmc.sample_chain(FREE_ROUNDS, BATCH, collect_samples=True)
    samples = out["samples"][1:].reshape(-1, math.prod(FREE_LAT))
    phi2 = samples.double().pow(2).mean(1).cpu().numpy()
    value, err = binned(phi2)
    exact = exact_free_phi2(FREE_LAT, model.action)
    sigma = abs(value - exact) / err
    print(f"free field {FREE_LAT} ({FREE_ACTION}): trained {FREE_STEPS} "
          f"steps at batch {TRAIN_BATCH} in {trained:.1f} s, loss "
          f"{loss[0]:.4f} -> {loss[-1]:.4f}; sample_chain({FREE_ROUNDS}, "
          f"{BATCH}), round 1 dropped: <phi^2> {value:.6f} +- {err:.6f} "
          f"(binned, {len(phi2)} states) vs exact {exact:.6f}: {sigma:.2f} "
          f"sigma (bar {OBS_SIGMAS}); accept rate "
          f"{float(out['accept_rate'][1:].mean()):.4f}; "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    if not (np.isfinite(loss).all() and sigma <= OBS_SIGMAS):
        raise AssertionError("the free field's <phi^2> misses the exact "
                             "value")


# --------------------------------------------------------------------- #
# Phase 24: the channels-last route at 1-, 3- and 4-D
# --------------------------------------------------------------------- #
# the 8^4 flagship on the route (``with_coupling_backend(.., "pallas_reg")``
# on phase 23's weights: conditioners channels-last through one stacked
# 3-D conv per 4-D conv into the channels-last coupling kernels), the
# kernels at its shapes, and small 1-D and 3-D flagships, on numpy streams
# of their own (CL_ND_SEED)
CL_ND_SEED = 20261024
CL4_BATCHES = 4       # the route's profiled logqp_stream(CL4_BATCHES, BATCH)
CL4_STEPS = 2         # the route's profiled fit at 8^4
CL_ND_LATS = ((64,), (8, 8, 8))  # the small flagships, sampled at
CL_ND_BATCH = 256                # batches of CL_ND_BATCH
CL_ND_LOGQ_DRAWS = 16            # draws of their logq check against float64
# the route's variants off 2-D: the couplings channels-last and tiled, the
# action and its force on the tiled nd kernels at 3-D and 4-D and general
# at 1-D (no tile), accept_scan general
CL_ND_TILED = {"rqs_coupling_cl": True, "rqs_coupling_bwd_cl": True,
               "phi4_action": True, "phi4_action_grad": True,
               "accept_scan": False}
CL_1D_TILED = {**CL_ND_TILED, "phi4_action": False,
               "phi4_action_grad": False}


def check_cl_kernels_4d(torch, kernels, peaks, rng):
    """The channels-last tiled kernels at the 8^4 flagship's shapes, with
    linear tails, from ``rng``: ``rqs_coupling`` forward and inverse at
    (1024, 22, 8^4) and (512, 22, 8^4) and ``rqs_coupling_bwd`` at (512,
    22, 8^4), each bit for bit against the NCHW tiled kernel on
    ``out.contiguous()`` and within phase 22's bars of its plain version
    (:func:`hold_cl`); then each timed warm and cold against its byte
    bound, with its plain version (the record's ``variants``)."""
    from normflow__tpu_torch.ops.kernels import spline_coupling as sc

    def f32(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    k3, s = 22, math.prod(LAT4)
    out = f32((BATCH, *LAT4, k3)).movedim(-1, 1)  # channels-last
    x = f32((BATCH, *LAT4))
    cot = [f32((TRAIN_BATCH, *LAT4)) for _ in range(2)]
    if sc.coupling_layout(out) != "channels_last" or sc.coupling_variant(
            s, [out.data_ptr(), x.data_ptr()], "channels_last",
            BATCH) != "tiled":
        raise AssertionError("the 8^4 output does not take the tiled "
                             "channels-last kernels")
    worst = {"rqs_coupling_cl": 0.0, "rqs_coupling_bwd_cl": 0.0}
    cases = []
    for inverse in (False, True):
        what = "inverse" if inverse else "forward"
        kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                  right="linear", inverse=inverse)
        for b, c in ((BATCH, []), (TRAIN_BATCH, []), (TRAIN_BATCH, cot)):
            xb, ob = x[:b], out[:b]
            hold_cl(torch, worst, xb, ob, c, kw, f"S={s} (8^4) B={b}")
            fn, plain = ((sc.rqs_coupling_bwd, sc.rqs_coupling_vjp_plain)
                         if c else (sc.rqs_coupling, sc.rqs_coupling_plain))
            cases.append((
                "rqs_coupling_bwd_cl" if c else "rqs_coupling_cl",
                f"{(b, k3, *LAT4)} channels-last tiled {what}",
                (b, k3, *LAT4),
                lambda fn=fn, xb=xb, ob=ob, c=c, kw=kw: fn(xb, ob, *c, **kw),
                lambda fn=plain, xb=xb, ob=ob, c=c, kw=kw: fn(xb, ob, *c,
                                                             **kw)))
    for name, err in worst.items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                           err)
    for name, what, shape, fn, plain in cases:
        record_variant(name, what, kernel_times(name, fn, plain,
                                                plain_reps=5),
                       shape, peaks, kernels)


def cl_layouts(torch, net_, x, what):
    """Raise unless, in one forward of ``net_`` on ``x``, every conv
    layer's output and every coupling's conditioner output is
    channels-last, the conditioners' in the caller's dtype."""
    from normflow__tpu_torch.models.nets import CircularConv, ConvNet
    from normflow__tpu_torch.ops.lattice import channels_last

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(
            (type(mod).__name__, channels_last(out), out.dtype)))
        for m in net_.modules() if isinstance(m, (CircularConv, ConvNet))]
    try:
        with torch.no_grad():
            net_.forward(x)
    finally:
        for h in hooks:
            h.remove()
    convs = [ok for kind, ok, _ in seen if kind == "CircularConv"]
    nets = [(ok, dtype) for kind, ok, dtype in seen if kind == "ConvNet"]
    print(f"{what}: {sum(convs)} of {len(convs)} conv outputs and "
          f"{sum(ok for ok, _ in nets)} of {len(nets)} conditioner outputs "
          f"channels-last ({sorted({str(d) for _, d in nets})})")
    if not (convs and nets and all(convs) and all(
            ok and dtype == x.dtype for ok, dtype in nets)):
        raise AssertionError(f"{what}: an activation left the "
                             "channels-last layout")


def replay_matches_eager(torch, model, batch, what):
    """One replayed batch of ``batch`` against its eager body from one
    generator state, bit for bit, both under cuDNN's deterministic
    algorithms (a capture of their own); the batch is captured anew
    afterwards, outside any profiled window."""
    post = model.posterior
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    post._graphs.clear()
    try:
        model.seed(21)
        got = post.logqp_stream(1, batch)
        model.seed(21)
        want = post.logqp_batch(batch, model.generator)
    finally:
        torch.backends.cudnn.deterministic = flag
        post._graphs.clear()
    same = same_bits(torch, (got,), (want,))
    print(f"{what} replayed vs eager batch of {batch}, cuDNN "
          f"deterministic: {'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError(f"{what}: a replayed batch differs from its "
                             "eager body")
    post.logqp_stream(1, batch)


def run_cl_small(torch, kernels, card, lat, rng):
    """A small flagship on the route at ``lat`` (1-D or 3-D), full widths,
    seeded perturbed weights: logq of ``CL_ND_LOGQ_DRAWS`` draws against a
    float64 CPU copy (``LOGQ_REL_TOL``); every conv and conditioner output
    channels-last, in float32 and through bf16 conditioners; one
    ``logqp_stream(1, CL_ND_BATCH)`` profiled with the counters set to 0
    just before (4 channels-last tiled couplings and 1 action a batch:
    general at 1-D, the tiled nd kernel at 3-D); a replayed batch bit for
    bit with its eager body."""
    from normflow__tpu_torch.tools.kernel_times import (device_launches,
                                                         perturb_)
    from normflow__tpu_torch.zoo import (build_phi4_model,
                                         with_conv_compute_dtype)

    model = build_phi4_model(lat, packed=False, seed=0,
                             coupling_backend="pallas_reg")
    perturb_(model.net_, rng)
    cpu = build_phi4_model(lat, packed=False, seed=0, device="cpu",
                           dtype=torch.float64, coupling_backend="pallas_reg")
    cpu.net_.load_state_dict({k: v.double().cpu() for k, v in
                              model.net_.state_dict().items()})
    x = rng.standard_normal((CL_ND_LOGQ_DRAWS, *lat))
    with torch.no_grad():
        xg = torch.tensor(x, dtype=torch.float32, device="cuda")
        logq = (model.prior.log_prob(xg) - model.net_.forward(xg)[1]).cpu()
        x64 = torch.tensor(x, dtype=torch.float64)
        want = cpu.prior.log_prob(x64) - cpu.net_.forward(x64)[1]
    rel = float(((logq.double() - want).abs() / want.abs().clamp(min=1.0))
                .max())
    print(f"{len(lat)}-D channels-last flagship {lat}, GPU vs a float64 CPU "
          f"copy: max rel logq {rel:.3e} (tol {LOGQ_REL_TOL})")
    if not rel <= LOGQ_REL_TOL:
        raise AssertionError(f"the {len(lat)}-D channels-last flagship "
                             "disagrees with its float64 CPU copy")
    cl_layouts(torch, model.net_, xg, f"{len(lat)}-D route, float32")
    cl_layouts(torch, with_conv_compute_dtype(model.net_, torch.bfloat16),
               xg, f"{len(lat)}-D route, bf16 conditioners")
    path = f"{len(lat)}d channels-last sample"
    per_batch = {"rqs_coupling_cl": len(model.net_[2].nets),
                 "phi4_action": 1}
    reset_cl_counts()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(1, CL_ND_BATCH))
    gate_cl_path(kernels, path, per_batch, 1, device,
                 CL_1D_TILED if len(lat) == 1 else CL_ND_TILED,
                 nd=len(lat) > 2)
    if logqp.shape != (CL_ND_BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError(f"{path}: logqp not finite or wrong shape")
    replay_matches_eager(torch, model, CL_ND_BATCH, f"{len(lat)}-D route")


def run_cl_nd(torch, kernels, peaks, card, state):
    """Phase 24: the channels-last route at 1-, 3- and 4-D.  The kernels
    at the 8^4 shapes (:func:`check_cl_kernels_4d`); phase 23's seeded
    perturbed 8^4 flagship through ``with_coupling_backend(..,
    "pallas_reg")`` (``state``): logq of phase 23's draws against its
    float64 CPU logq; every conv and conditioner output channels-last, in
    float32 and bf16; ``logqp_stream(CL4_BATCHES, 1024)`` profiled with
    the counters set to 0 just before (4 channels-last tiled couplings, 0
    NCHW, 1 general action a batch); a replayed batch bit for bit with its
    eager body under cuDNN's deterministic algorithms, and by name; one
    graphed chain round of 1024 by name and bit for bit with its eager
    body; a fresh 8^4 route flagship: one path-gradient step against
    float64 with the per-leaf bars (``LAT4_STEP_BATCH``), then
    ``CL4_STEPS`` steps of :func:`fit_protocol` at ``LAT4_LR`` captured
    under cuDNN's deterministic algorithms and profiled with the counters
    set to 0 just before (8 / 8 / 1 / 1 a step), a replayed step by name
    and bit for bit with an eager one.  Printed, not gated: raw samples/s
    and (deterministic captures both) steps/s against the NCHW 8^4
    flagship in turns, and where a replayed batch's and step's time goes
    on each route.  Last, the small 1-D and 3-D flagships
    (:func:`run_cl_small`)."""
    from normflow__tpu_torch import Model
    from normflow__tpu_torch.ops.kernels.accept_scan import accept_scan
    from normflow__tpu_torch.tools.kernel_times import device_launches
    from normflow__tpu_torch.zoo import (build_phi4_model,
                                         with_conv_compute_dtype,
                                         with_coupling_backend)

    t_phase = time.perf_counter()
    marks = []

    def mark(what):
        marks.append((what, round(time.perf_counter() - t_phase, 1)))

    rng = np.random.default_rng(CL_ND_SEED)
    check_cl_kernels_4d(torch, kernels, peaks, rng)
    mark("kernels")

    nchw = state["model"]
    model = Model(net_=with_coupling_backend(nchw.net_, "pallas_reg"),
                  prior=nchw.prior, action=nchw.action, seed=0)
    with torch.no_grad():
        xd = torch.tensor(state["x"], dtype=torch.float32, device="cuda")
        logq = (model.prior.log_prob(xd) - model.net_.forward(xd)[1]).double(
            ).cpu()
    want = state["logq64"]
    rel = float(((logq - want).abs() / want.abs().clamp(min=1.0)).max())
    print(f"4-D channels-last route on phase 23's weights vs its float64 "
          f"CPU logq, {len(want)} draws: max rel logq {rel:.3e} (tol "
          f"{LOGQ_REL_TOL})")
    if not rel <= LOGQ_REL_TOL:
        raise AssertionError("the 8^4 route disagrees with float64")
    xl = xd[:2]
    cl_layouts(torch, model.net_, xl, "4-D route, float32")
    cl_layouts(torch, with_conv_compute_dtype(model.net_, torch.bfloat16),
               xl, "4-D route, bf16 conditioners")
    mark("logq, layouts")

    n_layers = len(model.net_[2].nets)
    per_batch = {"rqs_coupling_cl": n_layers, "phi4_action": 1}
    reset_cl_counts()
    device, logqp = device_launches(
        lambda: model.posterior.logqp_stream(CL4_BATCHES, BATCH))
    gate_cl_path(kernels, "4d channels-last sample", per_batch, CL4_BATCHES,
                 device, CL_ND_TILED, nd=True)
    if logqp.shape != (CL4_BATCHES * BATCH,) or not bool(
            torch.isfinite(logqp).all()):
        raise AssertionError("the 8^4 route's logqp stream is not finite or "
                             "has the wrong shape")
    post = model.posterior
    replay_matches_eager(torch, model, BATCH, "4-D route")
    gate_replays(cl_counters(), kernels, "4d channels-last sample",
                 per_batch, 1, lambda: post.logqp_stream(1, BATCH),
                 tiled=CL_ND_TILED, nd=True)
    mark("sampling")

    mcmc, gen = model.mcmc, model.generator
    per_round = {**per_batch, "accept_scan": 1}
    mcmc.sample_chain(1, BATCH)  # captured outside the profiled window
    gate_replays({**cl_counters(), "accept_scan": accept_scan}, kernels,
                 "4d channels-last chain", per_round, 1,
                 lambda: mcmc.sample_chain(1, BATCH), tiled=CL_ND_TILED,
                 nd=True)
    mcmc.reset()
    model.seed(31)
    got = mcmc.sample_chain(1, BATCH, collect_samples=True)
    ref = mcmc._ref
    model.seed(31)
    carry = [torch.zeros(LAT4, device="cuda"),
             torch.tensor(math.inf, device="cuda"),
             torch.zeros((), device="cuda")]
    r = mcmc.chain_body(BATCH, gen, carry)
    same = same_bits(torch, (got["logq"], got["logp"], got["accept_rate"],
                             got["samples"], *ref),
                     (*(r[k][None] for k in (1, 2, 3, 0)), *carry))
    print(f"4-D route sample_chain(1, {BATCH}) graphed vs its eager round: "
          f"logq, logp, accept rate, samples and the final _ref "
          f"{'bit for bit' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError("a graphed chain round on the 8^4 route "
                             "differs from its eager body")
    del mcmc, got, ref, carry, r
    mark("chain")

    arms = {"NCHW": nchw, "channels-last": model}
    in_turns(torch, card, f"8^4 flagship, NCHW vs channels-last route, "
             f"sampling, {LAT4_TURNS} batches of {BATCH}, graphed",
             "raw samples/s", LAT4_TURNS * BATCH,
             {k: (lambda m=m: m.posterior.logqp_stream(LAT4_TURNS, BATCH))
              for k, m in arms.items()}, runs=1)
    for what, m in arms.items():
        profile_step(lambda m=m: m.posterior.logqp_stream(1, BATCH),
                     f"one replayed 8^4 {what} batch of {BATCH}", reps=1)
    del arms, model, post, nchw
    state.pop("model")
    mark("sampling rates, profiles")

    trained = build_phi4_model(LAT4, packed=False, seed=0,
                               coupling_backend="pallas_reg")
    check_train_grads(torch, trained, rng, packed=False,
                      backend="pallas_reg", lat=LAT4, batch=LAT4_STEP_BATCH)
    mark("step vs float64")
    per_step = {"rqs_coupling_cl": 2 * n_layers,
                "rqs_coupling_bwd_cl": 2 * n_layers, "phi4_action": 1,
                "phi4_action_grad": 1}
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_cl_counts()
        device, hist = device_launches(lambda: fit_protocol(
            trained, CL4_STEPS, lr=LAT4_LR, decay_steps=CL4_STEPS))
        gate_cl_path(kernels, "4d channels-last train", per_step,
                     CL4_STEPS, device, CL_ND_TILED, nd=True)
        loss = np.asarray(hist["loss"])
        print(f"8^4 route model.fit: {CL4_STEPS} steps at batch "
              f"{TRAIN_BATCH}, lr {LAT4_LR}; loss "
              f"{np.round(loss, 2).tolist()}")
        if loss.shape != (CL4_STEPS,) or not np.isfinite(loss).all():
            raise AssertionError("the 8^4 route's training loss is not "
                                 "finite")
        fit = trained.fit
        gate_replays(cl_counters(), kernels, "4d channels-last train",
                     per_step, 1, fit.step, tiled=CL_ND_TILED, nd=True)
        replayed_vs_eager_steps(torch, trained, "4-D channels-last: ", n=1,
                                captured=True)
    finally:
        torch.backends.cudnn.deterministic = flag
    steps = {"NCHW": state["trained"], "channels-last": trained}
    in_turns(torch, card, f"8^4 flagship, NCHW vs channels-last route, "
             f"replayed training steps at batch {TRAIN_BATCH}, both captured "
             f"under cuDNN's deterministic algorithms, one step a run",
             "steps/s", 1, {k: m.fit.step for k, m in steps.items()},
             runs=1)
    profile_step(fit.step, f"one replayed 8^4 channels-last training step "
                 f"at batch {TRAIN_BATCH} (deterministic capture)", reps=1)
    del steps, trained, fit
    mark("fit, replays, rates, profile")

    for lat in CL_ND_LATS:
        run_cl_small(torch, kernels, card, lat, rng)
    mark("1-D and 3-D")
    print(f"phase 24 (the channels-last route at 1-, 3- and 4-D) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}; seconds at its "
          f"marks: {marks}")


def profile_step(fn, what, reps=4):
    """Where the device time of ``fn`` goes: busy, wall, idle share and the
    top kernels; returns the busy seconds per call.  A window that lost
    its closing marker lost the body's last records too
    (``kernel_times.CLOSE_LOSSES``): it is profiled once more."""
    from normflow__tpu_torch.tools.kernel_times import CLOSE_LOSSES

    closes = len(CLOSE_LOSSES)
    wall, dev = device_profile(fn, reps)
    if len(CLOSE_LOSSES) > closes:
        print(f"{what}: the profiler lost the window's closing marker and "
              "last records; profiled again")
        wall, dev = device_profile(fn, reps)
    if not dev:
        raise AssertionError(f"the profiler saw no device activity in {what}")
    busy = sum(us for _, us in dev) / 1e6
    by_name: dict = {}
    for kname, us in dev:
        by_name[kname] = by_name.get(kname, 0.0) + us
    print(f"profile of {what} x{reps}: wall {wall / reps * 1e3:.4f} ms, "
          f"device busy {busy / reps * 1e3:.4f} ms, idle share "
          f"{1 - busy / wall:.4f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in ranked[10:] if any(
        k in kv[0] for k in ("rqs_coupling", "phi4_action", "accept_scan"))]
    for kname, us in ranked[:10] + ours:
        print(f"  {us / reps / 1e3:9.4f} ms {us / 1e6 / busy:7.2%}  "
              f"{kname[:90]}")
    return busy / reps


def print_windows(card):
    """What the profiled windows so far lost at their edges
    (``kernel_times.device_window``)."""
    from normflow__tpu_torch.tools.kernel_times import (CLOSE_LOSSES,
                                                         HEAD_LOSSES,
                                                         HEAD_NODES,
                                                         TAIL_LOSSES,
                                                         TAIL_NODES)
    print(f"profiled windows: {len(HEAD_LOSSES)}, the most head activities "
          f"one lost {max(HEAD_LOSSES, default=0)} of {HEAD_NODES}; "
          f"{sum(n > 0 for n in TAIL_LOSSES)} lost tail activities, the most "
          f"{max(TAIL_LOSSES, default=0)} of {TAIL_NODES} (the last window: "
          f"{TAIL_LOSSES[-1:]}); {len(CLOSE_LOSSES)} lost the closing marker "
          f"on {card}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.ops.kernels import _lib
    from normflow__tpu_torch.tools.kernel_times import (card_peaks,
                                                         event_floor_ms)

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
    ptxas = ptxas_by_kernel(log)

    rng = np.random.default_rng(20261016)
    kernels: dict = {}
    action = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5)
    phases = []

    def phase(name, fn, *args):
        t = time.perf_counter()
        try:
            out = fn(*args)
        except BaseException:
            print_windows(card)
            raise
        phases.append((name, time.perf_counter() - t))
        return out

    timers = [phase("check rqs_coupling", check_rqs, torch, kernels, peaks,
                    rng),
              phase("check phi4_action", check_phi4, torch, kernels, peaks,
                    rng, action),
              phase("check rqs_coupling_bwd", check_rqs_bwd, torch, kernels,
                    peaks, rng),
              phase("check phi4_action_grad", check_phi4_grad, torch,
                    kernels, peaks, rng, action),
              phase("check accept_scan", check_accept_scan, torch, kernels,
                    peaks),
              phase("check the coupling kernels at S = 1024",
                    check_coupling_at, torch, kernels, peaks, LAT,
                    COUPLING_AT_SEED),
              phase("check the phi4 kernels at (128, 8, 8)",
                    check_phi4_general, torch, kernels, peaks),
              phase("check the slab kernels", check_slab_kernels, torch,
                    kernels, peaks, np.random.default_rng(20261020),
                    action),
              phase("check the phi4 kernels at 4-D", check_phi4_4d, torch,
                    kernels, peaks)]
    # before the main path's runs, which are profiled: the rates are taken
    # with no profiler run in the process
    phase("rates in turns", rates_in_turns, torch, card)
    phase("gauge rates in turns", gauge_rates_in_turns, torch, card)
    model = phase("sampling path", run_main_path, torch, kernels, rng, card)
    phase("chain path", run_chain_path, torch, kernels, model, card)
    phase("parallel chains path", run_parallel_path, torch, kernels, model,
          card)
    phase("blocked sampler", run_blocked, torch, kernels, model)
    # phase 22 holds the channels-last route's step on this step's inputs
    step_rng = copy.deepcopy(rng)
    phase("GPU vs CPU training step", check_train_grads, torch, model, rng)
    trained = phase("training path", run_training_path, torch, kernels,
                    card)
    zerodim = phase("zero-dim fit", run_zerodim, torch)
    phase("zero-dim exactness", run_exactness, torch, card)
    phase("replay vs eager", replay_vs_eager, torch, model, trained)
    phase("protocol resumed", run_resume, torch, card)
    phase("replay launches", replay_launches, torch, kernels, model,
          trained, zerodim)
    phase("bf16 sampling path", run_bf16_sampling, torch, kernels, model,
          card)
    phase("controlled coupling training", run_cntr_training, torch, kernels,
          card)
    unpacked = phase("unpacked sampling path", run_unpacked_sampling, torch,
                     kernels, rng, card)
    phase("unpacked training path", run_unpacked_training, torch, kernels,
          unpacked, rng, card)
    del unpacked
    phase("affine example", run_affine, torch, kernels, card)
    phase("bench", run_bench, torch)
    floor = event_floor_ms()
    print(f"CUDA events around nothing, timed as the kernels are: "
          f"{floor:.5f} ms on {card}")
    for time_it in timers:
        phase("kernel times", time_it)
    # the U(1) gauge and Schwinger paths, on numpy draws of their own
    grng = np.random.default_rng(20261017)
    phase("U(1) sampling path", run_u1_sampling, torch, kernels, grng, card)
    u1 = phase("U(1) training path", run_u1_training, torch, kernels, grng,
               card)
    phase("U(1) chain", run_u1_chain, torch, kernels, u1, card)
    del u1
    phase("Schwinger example", run_schwinger, torch, kernels, card)
    phase("stochastic log-det", run_stochastic, torch, kernels, card)
    phase("config 4", run_config4, torch, kernels, peaks, card)
    phase("space sharding", run_space, torch, kernels, card)
    phase("channels-last route", run_channels_last, torch, kernels, peaks,
          card, model, step_rng)
    state4 = phase("4-D phi^4", run_4d, torch, kernels, card)
    # phase 26's weights, before phase 24 lets phase 23's model go
    weights4 = {k: v.detach().cpu().numpy()
                for k, v in state4["model"].net_.state_dict().items()}
    phase("channels-last route at 1-, 3- and 4-D", run_cl_nd, torch,
          kernels, peaks, card, state4)
    del state4
    phase("every loss over two data ranks", run_losses, torch, kernels,
          card)
    phase("the 8^4 flagship over two space ranks", run_space4, torch,
          kernels, card, weights4)
    print("phase seconds: " + ", ".join(f"{n} {t:.1f}" for n, t in phases))
    print_windows(card)

    for kname, rec in kernels.items():
        fns = DEVICE_FUNCTIONS[kname]
        rows = ptxas[fns[0]]  # the path's device function
        rec["registers"] = max(
            [r for inst, r, _ in rows if FLAGSHIP_INSTANCE in inst]
            or [r for _, r, _ in rows])
        rec["spill_bytes"] = sum(sp for fn in fns for _, _, sp in ptxas[fn])
        rec["device_functions"] = fns
        rec["launches"] = sum(rec["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "ms_cold", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "bound_share_cold", "headline", "library_ms",
            "registers", "spill_bytes", "device_functions", "call_ms",
            "plain_call_ms", "timing", "launches_by_path",
            "replay_launches_per_unit")
    print(json.dumps({"kernels": [
        {**{k: rec[k] for k in keys},
         **{k: rec[k] for k in ("variants", "tiled_launches_by_path",
                                "general_in_turns") if k in rec}}
        for rec in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
