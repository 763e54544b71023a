"""Zero-dimensional phi^4 with a DistConvertor flow (BASELINE config 1).

Counterpart of ``examples/scalar_zerodim.py``: a 10-knot odd
``DistConvertor`` over a standard normal prior on one site, trained by
reverse KL against ``S = m^2 phi^2 / 2 + lambda phi^4`` (kappa 0, m^2
-1.2, lambda 0.5); the reference reaches a loss of about -1.05 and an
accept rate of about 0.914 at epoch 500::

    python3 -m normflow__tpu_torch.examples.scalar_zerodim [--n_epochs N]

It runs on the GPU unless ``--device cpu`` is given; ``--n_devices N``
shards the batch over N processes (``torchrun --nproc_per_node N``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.actions import ScalarPhi4Action
from ..models.elementwise import DistConvertor
from ..models.priors import NormalPrior
from ..parallel.mesh import init_distributed
from ..training.model import Model, backward_sanitychecker
from ..utils.device import resolve_device

__all__ = ["main"]


def main(m_sq=-1.2, lambd=0.5, knots_len=10, n_epochs=1000, batch_size=1024,
         lat_shape=1, n_devices=1, seed=0, snapshot_path=None,
         dtype=torch.float32, device=None):
    """Build and fit the model, check the round trip through the flow;
    returns the model."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    lat_shape = (lat_shape,) if isinstance(lat_shape, int) \
        else tuple(lat_shape)
    model = Model(net_=DistConvertor(knots_len, **kw),
                  prior=NormalPrior(shape=lat_shape, **kw),
                  action=ScalarPhi4Action(kappa=0, m_sq=m_sq, lambd=lambd),
                  seed=seed)
    print("number of model parameters =", model.net_.npar)
    if n_devices > 1:  # one process per device: torchrun, spawnprocesses
        init_distributed(device=model.device)
        model.device_handler.use_mesh(n_devices=n_devices)
        model.device_handler.replicate_params()
    model.fit(n_epochs=n_epochs, save_every=None, batch_size=batch_size,
              hyperparam=dict(lr=0.01, weight_decay=0.0),
              checkpoint_dict=dict(print_stride=100,
                                   snapshot_path=snapshot_path))
    backward_sanitychecker(model)
    return model


if __name__ == "__main__":
    import ast
    from argparse import ArgumentParser

    parser = ArgumentParser()
    add = parser.add_argument
    add("--lat_shape", type=str)
    add("--m_sq", type=float)
    add("--lambd", type=float)
    add("--knots_len", type=int)
    add("--batch_size", type=int)
    add("--n_epochs", type=int)
    add("--n_devices", type=int)
    add("--seed", type=int)
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
