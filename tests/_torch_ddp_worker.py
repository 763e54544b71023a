"""One rank of the port's 2-rank data-parallel tests (not collected by
pytest).

``tests/test_torch_parallel.py`` runs :func:`run_rank` on two ranks of a
gloo group through ``ModelDeviceHandler.spawnprocesses``
(``torch.multiprocessing``, ``spawn``, a free ``localhost`` port).  It
imports ``torch`` and the port only.  Every draw comes from the parent as
numpy: rank ``r`` takes rows ``[r B / 2, (r + 1) B / 2)`` of each global
draw, so that the parent can hold the sharded runs against one rank's run
on the whole draws.
"""

import numpy as np
import torch
import torch.distributed as dist

from normflow__tpu_torch.utils.transplant import (jax_leaf_grads,
                                                  load_jax_leaves)
from normflow__tpu_torch.zoo import build_phi4_model

SMALL = dict(lat_shape=(8, 8), knots=4, hidden=(4,), n_layers=2)
FIT = dict(hyperparam=dict(lr=1e-2, weight_decay=1e-4),
           checkpoint_dict=dict(print_stride=None))


def small_model(leaves=None):
    """The small float64 flagship on the CPU, with ``leaves`` (JAX order)
    loaded where given."""
    model = build_phi4_model(**SMALL, dtype=torch.float64, device="cpu",
                             seed=3)
    if leaves is not None:
        load_jax_leaves(model.net_, leaves)
    return model


def share(a, rank, n):
    """Rank ``rank``'s rows of ``a``."""
    b = a.shape[0] // n
    return a[rank * b:(rank + 1) * b]


def feed_fit(model, draws, rank=0, n=1, scale=None):
    """Make ``model.fit`` take step ``k``'s draw from ``draws[k]`` (this
    rank's share), times ``scale[k]`` where that is given."""
    it = iter(range(len(draws)))

    def _draw(batch_size, generator):
        k = next(it)
        x = torch.from_numpy(share(draws[k], rank, n).copy())
        if scale is not None:
            x = x * scale[k]
        assert x.shape[0] == batch_size
        return x, model.prior.log_prob(x)

    model.fit._draw = _draw


def feed_sampler(sampler, prior, rounds, rank=0, n=1):
    """Make ``sampler`` take its rounds' ``(x, lrand)`` from ``rounds``."""
    it = iter(rounds)

    def _draws(batch_size, generator):
        x, lrand = (torch.from_numpy(share(a, rank, n).copy())
                    for a in next(it))
        assert x.shape[0] == batch_size
        return x, prior.log_prob(x), lrand

    sampler._draws = _draws


def fit_steps(model, draws, rank=0, n=1):
    """Four steps (segments of 2) on the fed draws: ``(loss history,
    parameters)``."""
    feed_fit(model, draws, rank, n)
    hist = model.fit(n_epochs=len(draws), batch_size=draws[0].shape[0],
                     steps_per_call=2, **FIT)
    return (list(hist["loss"]),
            [p.detach().numpy().copy() for p in model.net_.parameters()])


def rewind_run(model, draws, spike, rank=0, n=1):
    """Six steps in segments of 2 with the spike guard armed; the draws of
    ``spike`` (step indices) are scaled by 50 on the last rank only.
    Returns ``(rewinds, parameters)``."""
    scale = [50.0 if (k in spike and rank == n - 1) else 1.0
             for k in range(len(draws))]
    feed_fit(model, draws, rank, n, scale)
    hist = model.fit(n_epochs=6, batch_size=draws[0].shape[0],
                     steps_per_call=2, rewind_on_spike=10.0, **FIT)
    return (list(hist.get("rewinds", [])),
            [p.detach().numpy().copy() for p in model.net_.parameters()])


def reduced_grads(model, x):
    """The global batch's loss and the gradients summed over the group
    from this rank's share of ``x``, as the training step takes them, in
    the JAX package's leaf order."""
    dh = model.device_handler
    fit = model.fit
    tx = torch.from_numpy(share(x, dh.rank, dh.nranks).copy())
    loss, _, _ = fit.loss_of(tx, model.prior.log_prob(tx))
    params = list(model.net_.parameters())
    grads = dh.reduce_step(torch.autograd.grad(loss, params))
    for p, g in zip(params, grads):
        p.grad = g
    return float(loss.detach()), jax_leaf_grads(model.net_)


def attached(leaves, perturbed_on_rank0_only=True):
    """A small model attached to the group, rank 0's weights broadcast."""
    rank = dist.get_rank()
    model = small_model(leaves if rank == 0 or not perturbed_on_rank0_only
                        else None)
    model.device_handler.use_mesh(n_devices=dist.get_world_size())
    model.device_handler.replicate_params()
    return model


def run_rank(leaves, fit_draws, spike_draws, chain_rounds, par_rounds):
    """Everything the parent checks, on this rank."""
    torch.set_num_threads(1)
    rank, n = dist.get_rank(), dist.get_world_size()
    out = dict(rank=rank, nranks=n)

    model = attached(leaves)
    out["replicated"] = [p.detach().numpy().copy()
                         for p in model.net_.parameters()]
    out["grads"] = reduced_grads(model, fit_draws[0])
    out["fit"] = fit_steps(attached(leaves), fit_draws, rank, n)
    out["rewind"] = rewind_run(attached(leaves), spike_draws, {2, 3}, rank,
                               n)
    out["seed"] = attached(leaves).generator.initial_seed()

    model = attached(leaves)
    feed_sampler(model.mcmc, model.prior, chain_rounds, rank, n)
    chain = model.mcmc.sample_chain(len(chain_rounds),
                                    chain_rounds[0][0].shape[0],
                                    collect_samples=True)
    feed_sampler(model.mcmc, model.prior, par_rounds, rank, n)
    par = model.mcmc.sample_parallel_chains(len(par_rounds),
                                            par_rounds[0][0].shape[0],
                                            collect_samples=True)
    out["chain"] = {k: np.asarray(v) for k, v in chain.items()}
    out["chain_ref"] = [t.numpy() for t in model.mcmc._ref]
    out["parallel"] = {k: np.asarray(v) for k, v in par.items()}

    # the guard rule, raised on every rank before any collective
    model = attached(leaves)
    try:
        model.fit(n_epochs=1, batch_size=2 * n + 1, **FIT)
        out["odd_batch"] = None
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


def failing_rank():
    """Raises on rank 1 only."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return dist.get_rank()


def affine_rank(n_epochs):
    """``examples.scalar_affine.main(n_devices=2)`` on the CPU in this
    rank's group, a small net: the rank, its parameters flattened and its
    loss history (rank 0's alone is kept)."""
    from normflow__tpu_torch.examples import scalar_affine

    model = scalar_affine.main(n_epochs=n_epochs, batch_size=8, n_devices=2,
                               print_stride=None, n_layers=2,
                               hidden_sizes=(2,), device="cpu")
    flat = torch.cat([p.detach().reshape(-1)
                      for p in model.net_.parameters()])
    return (dist.get_rank(), model.device_handler.nranks, flat.numpy(),
            list(model.fit.train_history["loss"]))
