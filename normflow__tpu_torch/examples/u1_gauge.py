"""2-D U(1) gauge theory with gauge-equivariant plaquette couplings.

Counterpart of ``examples/u1_gauge.py`` (BASELINE config 5): link angles
over a uniform prior, flowed by the plaquette couplings of
``models/gauge.py`` (``zoo.build_u1_model``), trained by reverse KL against
the Wilson action on angles and sampled with ``mcmc.sample_chain``::

    python3 -m normflow__tpu_torch.examples.u1_gauge [--n_epochs N]

It runs on the GPU unless ``--device cpu`` is given; ``--n_devices N``
shards the batch over N processes (``torchrun --nproc_per_node N``).
:func:`observables` is the plaquette
mean with its binned error (:func:`binned`), and the topological charge.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..models.gauge import u1_plaq_angle
from ..parallel.mesh import init_distributed
from ..training.model import backward_sanitychecker
from ..zoo import build_u1_model

__all__ = ["main", "plaquette_series", "binned", "observables", "report"]


def main(beta=2.0, lat_shape=(16, 16), n_epochs=2000, batch_size=256,
         n_cycles=4, knots_len=8, lr=1e-3, seed=0, steps_per_call=None,
         n_devices=1, dtype=torch.float32, device=None):
    """Build, fit and sample the model; returns the model.
    ``n_devices > 1`` shards the batch over that many processes, one per
    device: run it under ``torchrun --nproc_per_node N`` or
    ``spawnprocesses``."""
    model = build_u1_model(lat_shape, beta=beta, knots_len=knots_len,
                           hidden=(16,), n_cycles=n_cycles, seed=seed,
                           dtype=dtype, device=device)
    print("number of model parameters =", model.net_.npar)
    if n_devices > 1:  # one process per device: torchrun, spawnprocesses
        init_distributed(device=model.device)
        model.device_handler.use_mesh(n_devices=n_devices)
        model.device_handler.replicate_params()
    model.fit(n_epochs=n_epochs, batch_size=batch_size,
              hyperparam=dict(lr=lr, weight_decay=0.0),
              steps_per_call=steps_per_call,
              checkpoint_dict=dict(print_stride=max(n_epochs // 10, 1)))
    backward_sanitychecker(model)
    report(model.mcmc.sample_chain(8, batch_size, collect_samples=True),
           lat_shape)
    return model


def plaquette_series(theta):
    """Per configuration of link angles ``(n, 2, L0, L1)`` (on any device):
    ``(<cos P>, topological charge)``, two ``(n,)`` tensors."""
    p = u1_plaq_angle(theta)
    return torch.cos(p).mean(dim=(1, 2)), p.sum(dim=(1, 2)) / (2 * math.pi)


def binned(x, n_bins=20):
    """Mean and binned error of a chain-ordered series: the standard error
    of the means of ``n_bins`` chain-ordered bins, which absorb the
    chain's autocorrelation."""
    x = np.asarray(x, dtype=np.float64)
    n_bins = max(2, min(n_bins, len(x)))
    n = (len(x) // n_bins) * n_bins
    bins = x[:n].reshape(n_bins, -1).mean(axis=1)
    return float(x.mean()), float(bins.std(ddof=1) / math.sqrt(n_bins))


def observables(theta, n_bins=20):
    """Of chain-ordered link angles ``(n_configs, 2, L0, L1)``:
    ``{"cos_p": (<cos P>, binned error), "q": charges}``."""
    cos_p, q = plaquette_series(torch.as_tensor(np.asarray(theta,
                                                           np.float64)))
    return {"cos_p": binned(cos_p.numpy(), n_bins), "q": q.numpy()}


def report(out, lat_shape):
    """Print <cos P>, the topological charge and the accept rate of a
    ``sample_chain(..., collect_samples=True)`` output; returns
    :func:`observables` of its samples."""
    theta = out["samples"].reshape(-1, 2, *lat_shape).cpu().numpy()
    obs = observables(theta)
    (cos_p, err), q = obs["cos_p"], obs["q"]
    print(f"<cos P> = {cos_p:.4f} +- {err:.4f}   topological charge: mean "
          f"{q.mean():+.3f} std {q.std():.3f}   accept_rate = "
          f"{float(out['accept_rate'].mean()):.3f}")
    return obs


if __name__ == "__main__":
    import ast
    from argparse import ArgumentParser

    parser = ArgumentParser()
    add = parser.add_argument
    add("--beta", type=float)
    add("--lat_shape", type=str)
    add("--n_epochs", type=int)
    add("--batch_size", type=int)
    add("--n_cycles", type=int)
    add("--knots_len", type=int)
    add("--lr", type=float)
    add("--seed", type=int)
    add("--steps_per_call", type=int)
    add("--n_devices", type=int)
    add("--device", type=str)
    args = {k: v for k, v in vars(parser.parse_args()).items()
            if v is not None}
    if "lat_shape" in args:
        args["lat_shape"] = ast.literal_eval(args["lat_shape"])
    try:
        main(**args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
