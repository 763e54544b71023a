#!/usr/bin/env python3
"""How often a profiled window loses device activities, and why, on one
card::

    python3 normflow__tpu_torch/tools/profiler_windows.py [N [M [H:P ...]]]

Opens :func:`kernel_times.profiled_window` at each setting ``H:P`` (``H``
one-element kernels at its head, ``P`` seconds of pause after it opens;
default :data:`SETTINGS`), in turns: ``N`` (default 200) small windows
over the body of ``tests/test_torch_cuda.py::test_flagship_coupling_launches_the_tiled_kernel``
(3 launches of the tiled ``rqs_coupling`` at the flagship's
(1024, 22, 32, 16)), then, after one long window over 200 replayed
training steps of the 32x32 flagship (as the smoke profiles before it
counts), ``M`` (default 40) large windows over 4 replayed steps.  For
each setting and size it prints the windows that lost a marker kernel
(:func:`kernel_times.device_window` raises for those), the small windows
whose body counted other than 3 launches, the head's activities lost
(all, and the most in one window), and two clocks: the least ``skew``,
a device activity's start less the start of the host's runtime call
that launched it (a kernel cannot start before its launch, so a skew
below 0 is a device clock behind the host's), and for every launch the
profiler reported on the host but not on the device, how long after the
profiler's start the host made it.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

# the checkout this file lies in, for ``normflow__tpu_torch``
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# (head kernels, pause in seconds)
SETTINGS = ((0, 0.0), (0, 0.001), (0, 0.01), (0, 0.05), (64, 0.0),
            (2048, 0.0), (2048, 0.05))
COUPLING_RE = re.compile(r"\brqs_coupling(_tiled)?_kernel\b")
LAUNCH_RE = re.compile(r"^cuda(Launch|GraphLaunch)")


def read(window, head):
    """``(markers, couplings, head lost, least skew ns, [ns after the
    start of each launch the device side lost])`` of one closed window."""
    from normflow__tpu_torch.tools.kernel_times import MARKER_RE

    host = {c: t for t, n, _, c, dev in window.events
            if not dev and LAUNCH_RE.search(n)}
    dev = [(t, n, c) for t, n, _, c, on in window.events if on]
    seen = {c for _, _, c in dev}
    skew = min((t - host[c] for t, _, c in dev if c in host), default=None)
    lost = [host[c] - window.start_ns for c in host if c not in seen]
    graph = [c for t, n, _, c, on in window.events
             if not on and n.startswith("cudaGraphLaunch")]
    head_seen = sum(c == graph[0] for _, _, c in dev) if graph and head \
        else head
    return (sum(bool(MARKER_RE.search(n)) for _, n, _ in dev),
            sum(bool(COUPLING_RE.search(n)) for _, n, _ in dev),
            head - head_seen if head else 0, skew, lost)


class Tally:
    """What the windows of one setting and size showed."""

    def __init__(self):
        self.n = self.lost_marker = self.short = self.head_lost = 0
        self.head_max = 0
        self.skews, self.lost_at = [], []

    def add(self, reading, launches=None):
        marks, couplings, head_lost, skew, lost = reading
        self.n += 1
        self.lost_marker += marks < 2
        self.short += launches is not None and couplings != launches
        self.head_lost += head_lost
        self.head_max = max(self.head_max, head_lost)
        if skew is not None:
            self.skews.append(skew)
        self.lost_at.extend(lost)

    def line(self):
        import numpy as np

        sk = np.array(self.skews or [np.nan]) / 1e3
        at = sorted(self.lost_at)
        return (f"{self.n} windows: lost a marker {self.lost_marker}, "
                f"short {self.short}, head lost {self.head_lost} (most "
                f"{self.head_max}), least skew {sk.min():.3f} us (median of "
                f"windows' least {np.median(sk):.3f}); {len(at)} launches "
                "lost on the device, made "
                + (f"{at[0] / 1e3:.1f}-{at[-1] / 1e3:.1f} us after the start"
                   if at else "-"))


def main(n=200, m=40, settings=SETTINGS):
    import numpy as np
    import torch

    from normflow__tpu_torch.ops.kernels import spline_coupling as sc
    from normflow__tpu_torch.tools.kernel_times import profiled_window
    from normflow__tpu_torch.zoo import build_phi4_model

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    out = torch.tensor(rng.standard_normal((1024, 22, 32, 16)),
                       dtype=torch.float32, device="cuda")
    x = torch.tensor(rng.standard_normal((1024, 32, 16)),
                     dtype=torch.float32, device="cuda")
    small = {s: Tally() for s in settings}
    for i in range(n):
        kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
                  right="linear", inverse=bool(i % 2))
        for head, pad in settings:
            sc.rqs_coupling(x, out, **kw)
            with profiled_window(pad, head) as w:
                for _ in range(3):
                    sc.rqs_coupling(x, out, **kw)
            small[head, pad].add(read(w, head), 3)

    model = build_phi4_model((32, 32))
    model.fit(n_epochs=1, batch_size=512,
              checkpoint_dict=dict(print_stride=None))
    with profiled_window(0.0, 0):
        for _ in range(200):
            model.fit.step()
    large = {s: Tally() for s in settings}
    for _ in range(m):
        for head, pad in settings:
            with profiled_window(pad, head) as w:
                for _ in range(4):
                    model.fit.step()
            large[head, pad].add(read(w, head))
    for name, tallies in (("small", small), ("large", large)):
        for (head, pad), t in tallies.items():
            print(f"{name} head {head} pause {pad} s: {t.line()}")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(*(int(a) for a in args[:2]), *(
        [tuple((int(h), float(p)) for h, p in
               (a.split(":") for a in args[2:]))] if args[2:] else [])))
