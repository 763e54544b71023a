"""The multi-rank dry run: a sharded step and both production samplers,
then a step on a data x space mesh.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:40-116``), on
``n_devices`` ranks, one process each (``ModelDeviceHandler.
spawnprocesses``; NCCL on the cards, gloo on the CPU).  Pass 1: the
flagship at 8x8 (4 knots, hidden (4,), 2 couplings) on the data axis fits
one step at batch ``4 n_devices``, draws ``posterior.sample__``, and runs
``sample_parallel_chains`` and ``sample_chain`` for 2 rounds each,
checking shapes and finite values.  Pass 2, where ``n_devices`` is even and
at least 4: the packed flagship coupling stack (``DistConvertor`` and a
packed RQ-spline coupling of two ``RowParityFeature(ConvAct)``
conditioners, built through the JAX names' ``build``) on
``use_mesh(axes={"data": n_devices // 2, "space": 2})`` fits one step::

    python3 -m normflow__tpu_torch.parallel.dryrun N [--device cpu]
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import nn
from ..models.masks import PackedEvenOddMask
from ..models.nets import RowParityFeature
from ..models.priors import NormalPrior
from ..training.model import Model
from ..utils.device import resolve_device
from ..zoo import build_phi4_model

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks; returns each rank's
    ``(dp loss, dp x sp loss)`` (equal on every rank; the second is NaN
    where pass 2 does not run)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"{n_devices} ranks need {n_devices} cards, "
                         f"{torch.cuda.device_count()} present")
    handler = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                               device=device).device_handler
    losses = handler.spawnprocesses(dryrun_rank, n_devices, str(device.type))
    print(f"dryrun_multichip({n_devices}): OK, dp loss={losses[0][0]:.4f}, "
          f"dp x sp loss={losses[0][1]:.4f}")
    return losses


def dryrun_rank(device: str) -> tuple:
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
    loss = _last_loss(hist, model.device)
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

    # pass 2: the data x space mesh on the packed flagship coupling stack
    loss2 = math.nan
    if n % 2 == 0 and n >= 4:
        model2 = _packed_stack(model.action, device)
        mesh2 = model2.device_handler.use_mesh(axes={"data": n // 2,
                                                     "space": 2})
        if mesh2.size != n:
            raise AssertionError(f"a mesh of {mesh2.size} ranks, want {n}")
        model2.device_handler.replicate_params()
        hist2 = model2.fit(n_epochs=1, batch_size=batch_size,
                           hyperparam=dict(lr=1e-3),
                           checkpoint_dict=dict(print_stride=None))
        loss2 = _last_loss(hist2, model2.device)
        if not math.isfinite(loss2):
            raise AssertionError(f"non-finite dp x sp loss: {loss2}")
    return loss, loss2


def _last_loss(hist, device):
    """The last loss of a fit's history, which rank 0 alone keeps,
    broadcast to every rank."""
    losses = torch.tensor(hist["loss"] or [0.0], dtype=torch.float64,
                          device=device)
    dist.broadcast(losses, 0)
    return float(losses[-1])


def _packed_stack(action, device, lat_shape=(8, 8), m=4):
    """``__graft_entry__.py:81-106``'s model: ``DistConvertor`` and a
    packed RQ-spline coupling of two ``RowParityFeature(ConvAct)``
    conditioners (``m`` knots), built through the JAX names' ``build``,
    over a standard normal prior, with ``action``."""
    gen = torch.Generator().manual_seed(7)
    conv = dict(in_channels=2, out_channels=3 * m - 2, hidden_sizes=(4,),
                kernel_size=3, conv_dim=2, acts=("tanh", None), bias=False,
                device=device)
    net_ = nn.ModuleList_([
        nn.DistConvertor_.build(8, symmetric=True, smooth=True,
                                device=device),
        nn.RQSplineCoupling_.build(
            [RowParityFeature(nn.ConvAct.build(gen, **conv))
             for _ in range(2)],
            mask=PackedEvenOddMask(shape=lat_shape), xlim=(-4.0, 4.0),
            ylim=(-4.0, 4.0), extrap={"left": "linear", "right": "linear"}),
    ])
    return Model(net_=net_, action=action, seed=1,
                 prior=NormalPrior.build(shape=lat_shape, device=device))


if __name__ == "__main__":
    from argparse import ArgumentParser

    parser = ArgumentParser()
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", type=str)
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
