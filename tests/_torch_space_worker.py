"""One rank of the port's lattice-sharding tests (not collected by pytest).

``tests/test_torch_space.py`` runs :func:`run_rank` on the ranks of a gloo
group (``ModelDeviceHandler.spawnprocesses``: ``torch.multiprocessing``,
``spawn``, a free ``localhost`` port, one thread each) under a data x space
mesh, and the parent holds each sharded run against one rank's run on the
whole draws.  It imports ``torch`` and the port only.  Every draw comes
from the parent as numpy: rank ``(d, s)`` takes rows ``[d B / n, (d + 1) B
/ n)`` of each global draw and the lattice rows of its slab
(:func:`share`).  Everything runs in float64 on the CPU.
"""

import numpy as np
import torch
import torch.distributed as dist

from normflow__tpu_torch import nn as tnn
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.masks import EvenOddMask, PackedEvenOddMask
from normflow__tpu_torch.models.nets import RowParityFeature
from normflow__tpu_torch.models.priors import NormalPrior
from normflow__tpu_torch.parallel import space
from normflow__tpu_torch.training.model import Model
from normflow__tpu_torch.utils.transplant import (jax_leaf_grads,
                                                  load_jax_leaves)
from normflow__tpu_torch.zoo import build_phi4_model

LAT = (8, 8)
F64 = dict(dtype=torch.float64, device="cpu")
SMALL = dict(lat_shape=LAT, knots=4, hidden=(4,), n_layers=2)
QUIET = dict(checkpoint_dict=dict(print_stride=None))


def packed_model(leaves=None, lat=LAT):
    """``tests/test_parallel.py:133-178``'s model: DistConvertor and a
    packed RQ-spline coupling of two ``RowParityFeature(ConvAct)``
    conditioners (m = 4), built through the JAX names' ``build``."""
    m = 4
    gen = torch.Generator().manual_seed(13)
    nets = [RowParityFeature(tnn.ConvAct.build(
        gen, 2, 3 * m - 2, kernel_size=3, conv_dim=2, hidden_sizes=(4,),
        acts=("tanh", None), bias=False, **F64)) for _ in range(2)]
    net_ = tnn.ModuleList_([
        tnn.DistConvertor_.build(8, symmetric=True, smooth=True, **F64),
        tnn.RQSplineCoupling_.build(
            nets, mask=PackedEvenOddMask(shape=lat), xlim=(-4.0, 4.0),
            ylim=(-4.0, 4.0), extrap={"left": "linear", "right": "linear"}),
    ])
    return _model(net_, leaves, 13, lat)


def affine_model(leaves=None, lat=LAT):
    """``tests/test_parallel.py:17-29``'s model: one affine coupling over
    ``EvenOddMask`` with two ``ConvAct`` conditioners."""
    gen = torch.Generator().manual_seed(7)
    nets = [tnn.ConvAct.build(gen, 1, 2, kernel_size=3, conv_dim=2,
                              hidden_sizes=(4,), acts=("tanh", None),
                              bias=False, **F64) for _ in range(2)]
    net_ = tnn.ModuleList_([tnn.AffineCoupling_(
        nets, mask=EvenOddMask(shape=lat))])
    return _model(net_, leaves, 7, lat)


def _model(net_, leaves, seed, lat):
    if leaves is not None:
        load_jax_leaves(net_, leaves)
    return Model(net_=net_, prior=NormalPrior.build(shape=lat, **F64),
                 action=ScalarPhi4Action(kappa=0.67, m_sq=-2.68, lambd=0.5),
                 seed=seed)


def flagship(leaves=None):
    """The small float64 flagship (PSD block, packed coupling, two
    DistConvertors) on the CPU."""
    model = build_phi4_model(**SMALL, **F64, seed=3)
    if leaves is not None:
        load_jax_leaves(model.net_, leaves)
    return model


MODELS = dict(packed=packed_model, affine=affine_model, flagship=flagship)


class SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over ``group``:
    each rank's copy of one tensor gets the gradient of all of them (the
    input of a ``gradcheck`` of a collective, the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def share(a, dh, lattice=True):
    """This rank's rows of the global draw ``a`` and, with ``lattice``,
    its slab's lattice rows."""
    n = dh.n_data if dh.group is not None else 1
    b = a.shape[0] // n
    a = a[dh.data_rank * b:(dh.data_rank + 1) * b]
    if lattice and dh.slab is not None:
        a = a[:, dh.slab.row0:dh.slab.row0 + dh.slab.rows]
    return torch.from_numpy(np.ascontiguousarray(a))


def attached(kind, leaves, axes):
    """A model on the mesh ``axes`` (none: unsharded), rank 0's weights
    broadcast."""
    model = MODELS[kind](leaves)
    if axes is not None:
        model.device_handler.use_mesh(axes=axes)
        model.device_handler.replicate_params()
    return model


def feed_fit(model, draws):
    """Make ``model.fit`` take step ``k``'s draw from ``draws[k]`` (this
    rank's share); the training body calls it with the slab current."""
    it = iter(range(len(draws)))
    dh = model.device_handler

    def _draw(batch_size, generator):
        x = share(draws[next(it)], dh)
        assert x.shape[0] == batch_size
        return x, model.prior.log_prob(x)

    model.fit._draw = _draw


def fit_run(model, draws, estimator="rep"):
    """``len(draws)`` steps on the fed draws: ``(loss history, parameters
    flattened)``; the history is rank 0's."""
    feed_fit(model, draws)
    hist = model.fit(n_epochs=len(draws), batch_size=draws[0].shape[0],
                     hyperparam=dict(lr=1e-3), grad_estimator=estimator,
                     **QUIET)
    flat = torch.cat([p.detach().reshape(-1)
                      for p in model.net_.parameters()])
    return list(hist["loss"]), flat.numpy()


def grads_of(model, x, estimator):
    """One step's loss, gradients (JAX leaf order) and per-sample logq and
    logp of the global draw ``x``, reduced over the group as the training
    step reduces them; the loss and logq and logp are the global batch's
    on every rank (``Fitter.loss_of`` gathers them over the data axis)."""
    dh = model.device_handler
    fit = model.fit
    fit.grad_estimator = estimator
    tx = share(x, dh)
    with dh.sharded():
        loss, logq, logp = fit.loss_of(tx, model.prior.log_prob(tx))
    params = list(model.net_.parameters())
    grads = torch.autograd.grad(loss, params)
    if dh.group is not None:
        grads = dh.reduce_step(grads)
    for p, g in zip(params, grads):
        p.grad = g
    return dict(loss=float(loss.detach()), grads=jax_leaf_grads(model.net_),
                logq=logq.detach().numpy(), logp=logp.detach().numpy())


def feed_sampler(model, rounds):
    """Make the samplers take their rounds' ``(x, lrand)`` from
    ``rounds``: this rank's share and slab of ``x``, its share of the
    uniforms (the same on every space rank)."""
    it = iter(rounds)
    dh = model.device_handler

    def _draws(batch_size, generator):
        x, lrand = next(it)
        x, lrand = share(x, dh), share(lrand, dh, lattice=False)
        assert x.shape[0] == batch_size
        return x, model.prior.log_prob(x), lrand

    model.mcmc._draws = _draws


def samplers(model, chain_rounds, par_rounds):
    """``sample_chain`` and ``sample_parallel_chains`` on the fed rounds,
    as numpy, with the chain's reference."""
    feed_sampler(model, chain_rounds)
    chain = model.mcmc.sample_chain(len(chain_rounds),
                                    chain_rounds[0][0].shape[0],
                                    collect_samples=True)
    ref = [t.numpy() for t in model.mcmc._ref]
    feed_sampler(model, par_rounds)
    par = model.mcmc.sample_parallel_chains(len(par_rounds),
                                            par_rounds[0][0].shape[0],
                                            collect_samples=True)
    return dict(chain={k: np.asarray(v) for k, v in chain.items()},
                chain_ref=ref,
                parallel={k: np.asarray(v) for k, v in par.items()})


def blocked(model, x, proposals, lrand):
    """One blocked sweep from the latent state ``x`` on fed proposals, and
    one ``sample__`` call, run inside a slab block to show that the
    blocked sampler takes the whole lattice anyway."""
    bm = model.blocked_mcmc
    with model.device_handler.sharded():
        sweep = bm.sweep(torch.from_numpy(x), 0.0, False,
                         torch.from_numpy(proposals),
                         torch.from_numpy(lrand))
        cfgs, logq, logp = bm.sample__(2, n_blocks=4)
    return dict(sweep=[t.numpy() for t in sweep],
                sample_shape=tuple(cfgs.shape),
                sample_finite=bool(torch.isfinite(logq - logp).all()))


def action_halo(model, x, g):
    """The action's one-way halo: the gradient of ``sum g S`` with the
    cotangent ``g`` of the totals (the same on every space rank), and of
    ``sum c_r g S_r`` with a cotangent ``c_r = 1 + space rank`` of each
    rank's partial action ``S_r`` (not the same): this rank's slab of
    each."""
    dh = model.device_handler
    gx = share(g, dh, lattice=False)
    out = []
    for equal in (True, False):
        tx = share(x, dh).requires_grad_(True)
        with dh.sharded():
            part = model.action(tx)
            if equal:
                (tot,) = space.totals(dh.slab, part)
                loss = (gx * tot).sum()
            else:
                loss = ((1.0 + dh.slab.rank) * gx * part).sum()
        out.append(torch.autograd.grad(loss, tx)[0].numpy())
    return out


CONV_CASES = ((2, 3, 2), (2, 2, 1), (4, 3, 1))  # (conv_dim, kernel, dilation)


def convs(dh, inputs):
    """``CircularConv`` on this rank's slab (lattice axis 0 is NCHW axis 2)
    of each ``(x, g)`` of ``inputs``, one per :data:`CONV_CASES`: the output
    and the gradient of ``sum g y`` in the input, through the halos."""
    from normflow__tpu_torch.models.nets import CircularConv

    out = []
    for (conv_dim, k, d), (x, g) in zip(CONV_CASES, inputs):
        conv = CircularConv(2, 3, k, conv_dim=conv_dim, dilation=d,
                            generator=torch.Generator().manual_seed(5),
                            **F64)
        rows = slice(dh.slab.row0, dh.slab.row0 + dh.slab.rows)
        xs = torch.from_numpy(np.ascontiguousarray(x[:, :, rows]))
        xs.requires_grad_(True)
        with dh.sharded():
            y = conv(xs)
        gx = torch.autograd.grad((torch.from_numpy(np.ascontiguousarray(
            g[:, :, rows])) * y).sum(), xs)[0]
        out.append((y.detach().numpy(), gx.numpy()))
    return out


def topology(model):
    """What the handler made of the mesh."""
    dh = model.device_handler
    return dict(rank=dh.rank, data_axis=dh.data_axis,
                space_axis=dh.space_axis, n_data=dh.n_data,
                data_rank=dh.data_rank,
                slab=None if dh.slab is None else (
                    dh.slab.rank, dh.slab.size, dh.slab.row0, dh.slab.rows),
                seed=model.generator.initial_seed(),
                uniform_seed=None if dh.slab is None
                else dh._uniform.initial_seed())


def run_rank(job):
    """Everything the parent checks, on this rank, under ``job["axes"]``."""
    torch.set_num_threads(1)
    axes = job["axes"]
    out = dict(rank=dist.get_rank())
    for kind, draws in job.get("fits", {}).items():
        out[f"fit {kind}"] = fit_run(attached(kind, job["leaves"][kind],
                                              axes), draws)
        out[f"grads {kind}"] = grads_of(attached(kind, job["leaves"][kind],
                                                 axes), draws[0], "rep")
    for est in job.get("estimators", ()):
        out[f"flagship {est}"] = grads_of(
            attached("flagship", job["leaves"]["flagship"], axes),
            job["x"], est)
    if "convs" in job:
        out["convs"] = convs(attached("flagship", None, axes)
                             .device_handler, job["convs"])
    if "chain_rounds" in job:
        model = attached("flagship", job["leaves"]["flagship"], axes)
        out["samplers"] = samplers(model, job["chain_rounds"],
                                   job["par_rounds"])
        out["blocked"] = blocked(model, *job["blocked"])
        out["action"] = action_halo(model, job["x"], job["g"])
        out["topology"] = topology(model)
        y, logq, logp = model.posterior.sample__(job["x"].shape[0])
        out["sample__"] = (tuple(y.shape), bool(torch.isfinite(
            logq - logp).all()))
    if "order" in job:  # the axis-order rule, the dict's order flipped
        model = attached("affine", None, job["order"])
        out["order"] = topology(model)
        y, logq, logp = model.posterior.sample__(8)
        out["order sample"] = (tuple(y.shape), bool(torch.isfinite(
            logq).all()))
    return out


def replica_rank(job):
    """A mesh with a replica axis, one that is neither the batch axis nor
    ``space``: under ``job["axes"]`` (``{"data": 2, "replica": 2}``) the
    topology, the first draw's reduced loss and gradients, a fit, the
    samplers on fed rounds and an unfed ``posterior.sample__``; under
    ``job["space_axes"]`` (``{"data": 1, "space": 2, "replica": 2}``) the
    topology and a fit."""
    torch.set_num_threads(1)
    leaves, axes = job["leaves"], job["axes"]
    model = attached("flagship", leaves, axes)
    dh = model.device_handler
    out = dict(topology=dict(topology(model), stream_rank=dh.stream_rank,
                             reduce_ranks=dist.get_world_size(
                                 dh.reduce_group)),
               grads=grads_of(model, job["x"], "rep"),
               fit=fit_run(attached("flagship", leaves, axes), job["fits"]),
               samplers=samplers(attached("flagship", leaves, axes),
                                 job["chain_rounds"], job["par_rounds"]))
    y, logq, logp = attached("flagship", leaves, axes).posterior.sample__(
        job["x"].shape[0])
    out["sample__"] = [t.detach().numpy() for t in (y, logq, logp)]
    model = attached("flagship", leaves, job["space_axes"])
    out["space topology"] = dict(topology(model),
                                 stream_rank=model.device_handler
                                 .stream_rank)
    out["space fit"] = fit_run(model, job["space_fits"])
    return out
