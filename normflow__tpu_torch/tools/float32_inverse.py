#!/usr/bin/env python3
"""Whether an 8x8 flagship still inverts in float32 at a given weight
noise, and what that does to one training step, on one CUDA card::

    python3 normflow__tpu_torch/tools/float32_inverse.py

For two noise levels on the seed-0 weights (``strong``: N(0, 0.1^2) on
every leaf; ``mild``: 0.3 times the init bound on the convs and N(0, 0.3^2)
elsewhere, as ``chip_smoke.py`` and ``tests/test_torch_cuda_grad.py``
perturb them) and both gradient estimators, it computes the loss and the
gradients of one draw of 64 on the card (float32, TF32 off), on a float32
CPU copy and on a float64 CPU copy.  It prints, for each pair, the loss's
relative difference, the per-sample ``|d log q|`` and the per-leaf
``|dg|/|g|``; and, for each copy, ``max |x - f^-1(f(x))|`` per sample.
"""

import copy
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from normflow__tpu_torch.models.nets import CircularConv  # noqa: E402
from normflow__tpu_torch.utils.transplant import jax_leaf_order  # noqa: E402
from normflow__tpu_torch.zoo import build_phi4_model  # noqa: E402


def step(noise, estimator):
    np_rng = np.random.default_rng(20261017)
    model = build_phi4_model((8, 8), device="cuda")
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(model.net_):
            if noise == "strong":
                s = 0.1
            else:
                s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                    if isinstance(owner, CircularConv) else 0.3
            p.add_(torch.tensor(np_rng.standard_normal(tuple(p.shape)) * s,
                                dtype=torch.float32, device="cuda"))
    x = np_rng.standard_normal((64, 8, 8))
    res = {}
    for key, dev, dt in (("gpu", "cuda", torch.float32),
                         ("cpu", "cpu", torch.float32),
                         ("cpu64", "cpu", torch.float64)):
        m = model
        if key != "gpu":
            m = build_phi4_model((8, 8), device="cpu", dtype=dt)
            m.net_.load_state_dict({k: v.to(dt) for k, v in copy.deepcopy(
                model.net_).cpu().state_dict().items()})
        m.fit.grad_estimator = estimator
        xd = torch.tensor(x, dtype=dt, device=dev)
        loss, logq, _ = m.fit.loss_of(xd, m.prior.log_prob(xd))
        g = torch.autograd.grad(loss, list(m.net_.parameters()))
        with torch.no_grad():
            back, _ = m.net_.backward(m.net_.forward(xd)[0])
            rt = (back - xd).abs().flatten(1).max(1).values
        res[key] = (float(loss.detach()), logq.detach().cpu().double(),
                    [t.cpu().double() for t in g], rt.cpu().double())
    print(f"--- noise={noise} estimator={estimator}: loss gpu "
          f"{res['gpu'][0]:.6f} cpu {res['cpu'][0]:.6f} cpu64 "
          f"{res['cpu64'][0]:.6f}")
    for a, b in (("gpu", "cpu"), ("gpu", "cpu64"), ("cpu", "cpu64")):
        rel = abs(res[a][0] - res[b][0]) / max(1.0, abs(res[b][0]))
        dq = (res[a][1] - res[b][1]).abs()
        leaves = [float((p - q).norm()) / max(float(q.norm()), 1e-30)
                  for p, q in zip(res[a][2], res[b][2])]
        print(f"  {a} vs {b}: loss rel {rel:.3e}; per-sample |dlogq| max "
              f"{float(dq.max()):.3e}, median {float(dq.median()):.3e}; "
              f"|dg|/|g| per leaf max {max(leaves):.3e}, median "
              f"{np.median(leaves):.3e}")
    for key in ("gpu", "cpu", "cpu64"):
        rt = res[key][3]
        print(f"  max|x - f^-1(f(x))| per sample, {key}: max "
              f"{float(rt.max()):.3e}, median {float(rt.median()):.3e}")


def main():
    if not torch.cuda.is_available():
        print("float32_inverse: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for noise in ("strong", "mild"):
        for estimator in ("rep", "path"):
            step(noise, estimator)
    return 0


if __name__ == "__main__":
    sys.exit(main())
