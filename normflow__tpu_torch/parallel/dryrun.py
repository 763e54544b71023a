"""The data-parallel dry run: one sharded step and both production samplers.

Counterpart of pass 1 of ``dryrun_multichip`` (``__graft_entry__.py:40-72``):
the flagship at 8x8 (4 knots, hidden (4,), 2 couplings) on ``n_devices``
ranks, one process each (``ModelDeviceHandler.spawnprocesses``; NCCL on
the cards, gloo on the CPU), fits one step at batch ``4 n_devices``,
draws ``posterior.sample__``, and runs ``sample_parallel_chains`` and
``sample_chain`` for 2 rounds each, checking shapes and finite values.
Pass 2, the data x lattice mesh, waits for lattice sharding::

    python3 -m normflow__tpu_torch.parallel.dryrun N [--device cpu]
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..zoo import build_phi4_model

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks; returns each rank's
    loss (equal on every rank)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"{n_devices} ranks need {n_devices} cards, "
                         f"{torch.cuda.device_count()} present")
    handler = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                               device=device).device_handler
    losses = handler.spawnprocesses(dryrun_rank, n_devices, str(device.type))
    print(f"dryrun_multichip({n_devices}): OK, dp loss={losses[0]:.4f}")
    return losses


def dryrun_rank(device: str) -> float:
    """One rank of the dry run, in a process group that is formed."""
    torch.set_num_threads(1)
    n = dist.get_world_size()
    batch_size = 4 * n
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device=device)
    dh = model.device_handler
    dh.use_mesh(n_devices=n)
    dh.replicate_params()
    hist = model.fit(n_epochs=1, batch_size=batch_size,
                     hyperparam=dict(lr=1e-3),
                     checkpoint_dict=dict(print_stride=None))
    losses = torch.tensor(hist["loss"] or [0.0], dtype=torch.float64,
                          device=model.device)
    dist.broadcast(losses, 0)  # rank 0 alone keeps the history
    loss = float(losses[-1])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss in the dry run: {loss}")
    y, logq, logp = model.posterior.sample__(batch_size)
    if y.shape[0] * n != batch_size:
        raise AssertionError(f"rank share {y.shape[0]} of {batch_size}")
    par = model.mcmc.sample_parallel_chains(2, batch_size)
    chain = model.mcmc.sample_chain(2, batch_size)
    for out in (par, chain):
        if out["logq"].shape != (2, batch_size) or not bool(
                torch.isfinite(out["logq"]).all()):
            raise AssertionError("a sampler's output has the wrong shape "
                                 "or is not finite")
    return loss


if __name__ == "__main__":
    from argparse import ArgumentParser

    parser = ArgumentParser()
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", type=str)
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
