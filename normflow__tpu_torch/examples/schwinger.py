"""The Schwinger model: 2-D U(1) gauge theory with staggered fermions.

Counterpart of ``examples/schwinger.py``: the plaquette-coupling flow of
``models/gauge.py`` trained against the Wilson action PLUS the exact
staggered Dirac log-determinant (``models/fermions.py``, even/odd Schur
complement by batched Cholesky), then sampled with ``mcmc.sample_chain``::

    python3 -m normflow__tpu_torch.examples.schwinger [--n_epochs N]

It runs on the GPU unless ``--device cpu`` is given; ``--n_devices N``
shards the batch over N processes (``torchrun --nproc_per_node N``).
The exact determinant
is cubic in the lattice volume; for larger volumes train with a
``StochasticStaggeredLogDet`` as ``SchwingerAngleAction``'s
``logdet_func`` (sampling keeps the exact log-det).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.fermions import SchwingerAngleAction
from ..models.gauge import build_u1_gauge_flow
from ..models.priors import UniformPrior
from ..parallel.mesh import init_distributed
from ..training.model import Model
from ..utils.device import resolve_device
from .u1_gauge import report

__all__ = ["main"]


def main(beta=2.0, mass=0.2, lat_shape=(8, 8), n_epochs=1000,
         batch_size=128, n_cycles=2, knots_len=8, lr=1e-3, seed=0,
         steps_per_call=None, n_devices=1, dtype=torch.float32,
         device=None):
    """Build, fit and sample the model; returns the model.
    ``n_devices > 1`` shards the batch over that many processes, one per
    device: run it under ``torchrun --nproc_per_node N`` or
    ``spawnprocesses``."""
    device = resolve_device(device)
    lat_shape = tuple(lat_shape)
    kw = dict(dtype=dtype, device=device)
    flow = build_u1_gauge_flow(torch.Generator().manual_seed(seed),
                               lat_shape, knots_len=knots_len, hidden=(16,),
                               n_cycles=n_cycles, **kw)
    prior = UniformPrior(torch.full((2, *lat_shape), -math.pi, **kw),
                         torch.full((2, *lat_shape), math.pi, **kw))
    action = SchwingerAngleAction(beta=beta, lat_shape=lat_shape, mass=mass,
                                  n_copies=1)
    model = Model(net_=flow, prior=prior, action=action, seed=seed)
    print("number of model parameters =", model.net_.npar)
    if n_devices > 1:  # one process per device: torchrun, spawnprocesses
        init_distributed(device=model.device)
        model.device_handler.use_mesh(n_devices=n_devices)
        model.device_handler.replicate_params()
    model.fit(n_epochs=n_epochs, batch_size=batch_size,
              hyperparam=dict(lr=lr, weight_decay=0.0),
              steps_per_call=steps_per_call,
              checkpoint_dict=dict(print_stride=max(n_epochs // 10, 1)))
    report(model.mcmc.sample_chain(8, batch_size, collect_samples=True),
           lat_shape)
    return model


if __name__ == "__main__":
    import ast
    from argparse import ArgumentParser

    parser = ArgumentParser()
    add = parser.add_argument
    add("--beta", type=float)
    add("--mass", type=float)
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
