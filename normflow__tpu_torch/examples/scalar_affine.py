"""2-D phi^4 with a PSD block and affine couplings, on the port.

Counterpart of ``examples/scalar_affine.py``: the reference's own example,
``PSDBlock -> DistConvertor -> AffineCoupling(n_layers x ConvNet,
EvenOddMask) -> DistConvertor`` over a standard normal prior, trained by
reverse KL on an 8x8 lattice at kappa 0.67, m^2 -2.68, lambda 0.5::

    python3 -m normflow__tpu_torch.examples.scalar_affine [--n_epochs N]

It runs on the GPU unless ``--device cpu`` is given.  :func:`observables`
is the binned, delete-one-bin jackknife of <phi^2> and the susceptibility
by which the two packages' Metropolis-corrected samples are compared
(``scripts/parity_observables.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.actions import ScalarPhi4Action
from ..models.core import FlowList
from ..models.couplings import AffineCoupling
from ..models.elementwise import DistConvertor, Identity
from ..models.masks import EvenOddMask
from ..models.nets import ConvNet
from ..models.priors import NormalPrior
from ..models.spectral import FFTFlow, MeanFieldFlow, PSDBlock
from ..parallel.mesh import init_distributed
from ..training.model import Model, backward_sanitychecker
from ..utils.device import resolve_device

__all__ = ["PARAM_GROUPS", "main", "assemble_net", "observables"]

# weight decay per top-level flow: the convertors and the PSD block, then
# the coupling stack
PARAM_GROUPS = (
    {"ind": [0, 1, 3], "hyper": dict(weight_decay=1e-4)},
    {"ind": [2], "hyper": dict(weight_decay=1e-2)},
)


def main(kappa=0.67, m_sq=-4 * 0.67, lambd=0.5, n_epochs=1000,
         batch_size=128, lat_shape=(8, 8), n_devices=1, seed=0, lr=0.001,
         snapshot_path=None, save_every=200, param_groups=PARAM_GROUPS,
         steps_per_call=None, print_stride=100, dtype=torch.float32,
         device=None, **net_kwargs):
    """Build the model, fit it and check the round trip through the flow;
    returns the model.  ``n_devices > 1`` shards the batch over that many
    processes, one per device (``parallel/mesh.py``): run it under
    ``torchrun --nproc_per_node N`` or ``spawnprocesses``."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    model = Model(net_=assemble_net(lat_shape=lat_shape, seed=seed,
                                    **net_kwargs, **kw),
                  prior=NormalPrior(shape=lat_shape, **kw),
                  action=ScalarPhi4Action(kappa=kappa, m_sq=m_sq,
                                          lambd=lambd),
                  seed=seed)
    print("number of model parameters =", model.net_.npar)
    if n_devices > 1:  # one process per device: torchrun, spawnprocesses
        init_distributed(device=model.device)
        model.device_handler.use_mesh(n_devices=n_devices)
        model.device_handler.replicate_params()
    model.fit(n_epochs=n_epochs, save_every=save_every,
              batch_size=batch_size, hyperparam=dict(lr=lr),
              param_groups=[dict(g) for g in param_groups],
              steps_per_call=steps_per_call,
              checkpoint_dict=dict(print_stride=print_stride,
                                   snapshot_path=snapshot_path))
    backward_sanitychecker(model)
    return model


def assemble_net(*, lat_shape, seed=0, n_layers=4, hidden_sizes=(8, 8),
                 zee2sym=True, acts=None, knots0_len=10, knots1_len=10,
                 knots2_len=50, knots4_len=50, dtype=torch.float32,
                 device=None):
    """The reference's composite architecture; the conditioners' weights
    are drawn from a generator seeded with ``seed`` (the JAX package takes
    a key).  ``zee2sym`` makes every convertor odd and the conditioners
    bias-free tanh stacks (else leaky-ReLU with biases)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    gen = torch.Generator().manual_seed(seed)
    mfnet = (MeanFieldFlow(knots0_len, symmetric=zee2sym, final_scale=True,
                           smooth=True, **kw)
             if knots0_len > 1 else Identity())
    fftnet = FFTFlow(lat_shape, knots_len=knots1_len, ignore_zeromode=True,
                     **kw)
    flows = [PSDBlock(mfnet=mfnet, fftnet=fftnet)]
    if knots2_len > 1:
        flows.append(DistConvertor(knots2_len, symmetric=zee2sym,
                                   smooth=True, **kw))
    if acts is None:
        tag = "tanh" if zee2sym else "leaky_relu"
        acts = (*[tag] * len(hidden_sizes), None)
    flows.append(AffineCoupling(
        [ConvNet(1, 2, 3, hidden_sizes=tuple(hidden_sizes),
                 conv_dim=len(lat_shape), acts=tuple(acts),
                 bias=not zee2sym, generator=gen, **kw)
         for _ in range(n_layers)],
        mask=EvenOddMask(shape=lat_shape)))
    if knots4_len > 1:
        flows.append(DistConvertor(knots4_len, symmetric=zee2sym,
                                   smooth=True, **kw))
    return FlowList(flows)


def observables(samples, n_bins=20):
    """``{"phi2": (value, error), "chi": (value, error)}`` of chain-ordered
    samples ``(n_configs, *lat)``: <phi^2> and the susceptibility
    ``V (<m^2> - <|m|>^2)``, ``m`` the lattice mean of each configuration.
    The errors are the delete-one-bin jackknife over ``n_bins`` chain-ordered
    bins: the bins absorb the autocorrelation, the jackknife the
    nonlinearity of chi."""
    samples = np.asarray(samples, float)
    v = float(np.prod(samples.shape[1:]))
    axes = tuple(range(1, samples.ndim))
    phi2 = (samples**2).mean(axis=axes)
    m = samples.mean(axis=axes)
    n_bins = max(2, min(n_bins, len(m) // 10))
    n = (len(m) // n_bins) * n_bins

    def bins(x):
        return x[:n].reshape(n_bins, -1).mean(axis=1)

    def jack(fn, *series):
        bs = [bins(s) for s in series]
        full = fn(*[b.mean() for b in bs])
        leave = np.array([fn(*[np.delete(b, i).mean() for b in bs])
                          for i in range(n_bins)])
        err = np.sqrt((n_bins - 1) / n_bins
                      * ((leave - leave.mean()) ** 2).sum())
        return float(full), float(err)

    return {"phi2": jack(lambda a: a, phi2),
            "chi": jack(lambda m2, am: v * (m2 - am**2), m**2, np.abs(m))}


if __name__ == "__main__":
    import ast
    from argparse import ArgumentParser

    parser = ArgumentParser()
    add = parser.add_argument
    add("--lat_shape", type=str)
    add("--m_sq", type=float)
    add("--lambd", type=float)
    add("--kappa", type=float)
    add("--knots0_len", type=int)
    add("--knots1_len", type=int)
    add("--knots2_len", type=int)
    add("--knots4_len", type=int)
    add("--zee2sym", type=lambda s: s.lower() in ("1", "true", "yes"))
    add("--batch_size", type=int)
    add("--n_epochs", type=int)
    add("--n_devices", type=int)
    add("--lr", type=float)
    add("--n_layers", type=int)
    add("--hidden_sizes", type=str)
    add("--snapshot_path", type=str)
    add("--seed", type=int)
    add("--steps_per_call", type=int)
    add("--device", type=str)
    args = {k: v for k, v in vars(parser.parse_args()).items()
            if v is not None}
    for k in ("lat_shape", "hidden_sizes"):
        if k in args:
            args[k] = ast.literal_eval(args[k])
    try:
        main(**args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
