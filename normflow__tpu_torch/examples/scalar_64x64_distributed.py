"""64x64 phi^4: data-parallel reverse-KL training and 1024 Metropolis chains.

Counterpart of ``examples/scalar_64x64_distributed.py`` (BASELINE config
4): the packed flagship at 64x64 (4 couplings, conditioners 2 -> 16 -> 16
-> 22, 8 knots) at kappa 0.6, m^2 -2.4, lambda 0.5, trained by reverse KL
at batch 512 (AdamW, lr 3e-3 on a cosine schedule, weight decay 1e-4), then
sampled by ``sample_parallel_chains`` over 1024 independent chains, 16
rounds after 4 of burn-in.  On one card::

    python3 -m normflow__tpu_torch.examples.scalar_64x64_distributed

and on ``N`` cards, one process each, the batch and the chains split over
them (``normflow__tpu_torch/parallel/mesh.py``)::

    torchrun --nproc_per_node N -m \\
        normflow__tpu_torch.examples.scalar_64x64_distributed

The process group is formed when ``torchrun``'s environment is present or
``--multihost`` is given; the model is then attached to it, whatever its
size.  ``--coarse_epochs n`` first trains the same flow at half the
lattice size for ``n`` epochs and transfers it up (coarse-to-fine,
``docs/TRAINING.md``).  ``--device cpu`` runs the plain path on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.actions import ScalarPhi4Action
from ..models.masks import PackedEvenOddMask
from ..ops import observables as obs
from ..parallel.mesh import init_distributed
from ..training.optim import cosine_decay_schedule
from ..utils.device import resolve_device
from ..zoo import build_phi4_model

__all__ = ["main", "fit", "chain_observables"]


def main(lat_shape=(64, 64), kappa=0.6, m_sq=-2.4, lambd=0.5,
         n_epochs=4000, batch_size=512, chains=1024, chain_rounds=16,
         knots=8, hidden=(16, 16), n_layers=4, lr=3e-3, seed=0,
         n_devices=None, steps_per_call=500, multihost=False,
         coarse_epochs=0, device=None):
    """Train and sample (see the module docstring); returns the model."""
    device = resolve_device(device)
    if multihost or "RANK" in os.environ:
        init_distributed(device=device)
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    lat_shape = tuple(lat_shape)
    build = dict(knots=knots, seed=seed, n_layers=n_layers, hidden=hidden,
                 kappa=kappa, m_sq=m_sq, lambd=lambd, device=device)
    model = build_phi4_model(lat_shape, **build)

    if coarse_epochs > 0:
        # coarse-to-fine: converge the flow at half the lattice size and
        # transfer it up, the best start for large lattices measured on
        # the TPU (docs/TRAINING.md "Scaling to larger lattices")
        coarse = build_phi4_model(tuple(s // 2 for s in lat_shape), **build)
        fit(coarse, coarse_epochs, batch_size, lr, steps_per_call, None)
        model.net_ = coarse.net_.transfer(
            shape=lat_shape, mask=PackedEvenOddMask(shape=lat_shape))

    if dist.is_initialized():
        model.device_handler.use_mesh(n_devices=n_devices)
        model.device_handler.replicate_params()
    elif n_devices not in (None, 1):
        raise ValueError(f"n_devices={n_devices} without a process group: "
                         "run one process per card under torchrun")
    say(f"devices={model.device_handler.nranks} params={model.net_.npar}")

    fit(model, n_epochs, batch_size, lr, steps_per_call,
        max(n_epochs // 8, 1))

    # independent Metropolis chains, split over the ranks with no
    # collective inside a round; the first rounds are burn-in (round 0 is
    # the flow's raw samples)
    burn = min(4, chain_rounds - 1)
    out = model.mcmc.sample_parallel_chains(chain_rounds + burn, chains,
                                            collect_samples=True)
    o = chain_observables(out, burn)
    say(f"<phi^2> = {o['phi2']:.5f} +- {o['phi2_err']:.5f}"
        f"   chi = {o['chi']:.3f}   tau_int(phi^2, per chain) = "
        f"{o['tau']:.1f}   accept = {o['accept']:.3f}")
    return model


def fit(model, n_epochs, batch_size, lr, steps_per_call, print_stride):
    """``model.fit`` with the example's settings: AdamW at ``lr`` on a
    cosine schedule over ``n_epochs`` (floor 0.05), weight decay 1e-4."""
    return model.fit(
        n_epochs=n_epochs, batch_size=batch_size,
        hyperparam=dict(lr=lr, weight_decay=1e-4),
        scheduler=cosine_decay_schedule(1.0, decay_steps=max(n_epochs, 1),
                                        alpha=0.05),
        steps_per_call=steps_per_call,
        checkpoint_dict=dict(print_stride=print_stride))


def chain_observables(out, burn):
    """<phi^2> with the error of the independent chains' means, chi, the
    mean integrated autocorrelation time of phi^2 along a chain (over every
    chain, or 32 spread over them) and the mean accept rate of a
    ``sample_parallel_chains`` output with ``collect_samples``, the first
    ``burn`` rounds left out of all but the accept rate."""
    samples = out["samples"][burn:]  # (rounds, chains, *lat)
    flat = samples.reshape(-1, *samples.shape[2:])
    p2 = obs.phi2(flat).reshape(samples.shape[:2]).cpu().numpy()
    # the autocorrelation lives along each chain (the rounds' axis); the
    # error bar is the spread of the independent chains' means, unbiased
    # for any autocorrelation within a chain
    tau = float(np.mean([obs.integrated_autocorr_time(p2[:, c])
                         for c in range(0, p2.shape[1],
                                        max(p2.shape[1] // 32, 1))]))
    mu_c = p2.mean(axis=0)
    return dict(phi2=float(p2.mean()),
                phi2_err=float(mu_c.std(ddof=1) / np.sqrt(mu_c.size)),
                chi=float(obs.susceptibility(flat)), tau=tau,
                accept=float(np.mean(out["accept_rate"])))


if __name__ == "__main__":
    import ast
    from argparse import ArgumentParser

    parser = ArgumentParser()
    add = parser.add_argument
    add("--lat_shape", type=str)
    add("--n_epochs", type=int)
    add("--batch_size", type=int)
    add("--chains", type=int)
    add("--chain_rounds", type=int)
    add("--n_devices", type=int)
    add("--lr", type=float)
    add("--seed", type=int)
    add("--multihost", action="store_true", default=None)
    add("--coarse_epochs", type=int,
        help="coarse-to-fine: pre-train at half the lattice size for this "
             "many epochs, then transfer (0 = off)")
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
