"""One rank of the port's uneven-slab tests (not collected by pytest).

``tests/test_torch_uneven_slabs.py`` runs :func:`run_rank` on the ranks of
a gloo group of two and one of three (``ModelDeviceHandler.
spawnprocesses``: ``torch.multiprocessing``, ``spawn``, a free
``localhost`` port, one thread each) under ``{"data": 1, "space": m}``,
where the lattice's rows split as XLA splits them: shorter last slabs, an
empty one, slabs that start at an odd row, a halo deeper than a slab.  It
imports ``torch`` and the port only.  Every draw comes from the parent as
numpy and each rank takes its slab (``_torch_space_worker.share``).
Everything runs in float64 on the CPU.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from normflow__tpu_torch.parallel import space
from normflow__tpu_torch.utils.transplant import load_jax_leaves
from normflow__tpu_torch.zoo import build_phi4_model

import _torch_space_worker as S

# name: the lattice, the packed mask or not, the space ranks, the
# conditioners' dilation, and each rank's (first row, rows)
CASES = {
    "5/4": ((9, 8), False, 2, None, [(0, 5), (5, 4)]),
    "5/5 packed": ((10, 8), True, 2, None, [(0, 5), (5, 5)]),
    "11/11/10 packed": ((32, 8), True, 3, None,
                        [(0, 11), (11, 11), (22, 10)]),
    "2/2/0": ((4, 8), True, 3, None, [(0, 2), (2, 2), (4, 0)]),
    "2/1 deep halo": ((3, 8), False, 2, 2, [(0, 2), (2, 1)]),
}
# (rows, space ranks, halo rows before, after) of the gradchecks
SPLITS = ((5, 3, 2, 2), (4, 3, 1, 1), (3, 2, 2, 2), (9, 2, 1, 2))


def flagship(case, leaves=None):
    """The small float64 flagship of ``case`` (knots 4, hidden (4,), two
    couplings) on the CPU, with ``leaves`` (JAX order) where given."""
    lat, packed, _, dilation, _ = CASES[case]
    model = build_phi4_model(lat, knots=4, hidden=(4,), n_layers=2,
                             packed=packed, conv_dilations=dilation, seed=3,
                             **S.F64)
    if leaves is not None:
        load_jax_leaves(model.net_, leaves)
    return model


def attached(case, leaves, m=None):
    """``case``'s flagship on ``{"data": 1, "space": m}`` (none:
    unsharded), rank 0's weights broadcast."""
    model = flagship(case, leaves)
    if m is not None:
        model.device_handler.use_mesh(axes={"data": 1, "space": m})
        model.device_handler.replicate_params()
    return model


def run_case(model, job):
    """What the parent holds for one case: the slab, the fed batch's
    samples, logq and logp, one step's loss and gradients, and both chain
    samplers on fed rounds."""
    dh = model.device_handler
    x = S.share(job["x"], dh)
    y, logq, logp = model.posterior.sample__(
        x.shape[0],
        preprocess_func=lambda _x, _l: (x, model.prior.log_prob(x)))
    slab = dh.slab
    return dict(
        slab=None if slab is None else (slab.row0, slab.rows),
        sample=(y.numpy(), logq.numpy(), logp.numpy()),
        step=S.grads_of(model, job["x"], "rep"),
        samplers=S.samplers(model, job["chain_rounds"], job["par_rounds"]))


class _Gathered(torch.autograd.Function):
    """Every rank's ``t`` (one shape) stacked in rank order; the backward
    keeps this rank's part of a cotangent that every rank holds alike."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def _padded(t, rows):
    """``t`` with zero rows after its own along axis 1, ``rows`` in all."""
    return F.pad(t, [0, 0, 0, rows - t.shape[1]])


def gradchecks(split):
    """``torch.autograd.gradcheck`` of ``space.halo`` and
    ``space.gather_rows`` on the slabs of ``split`` (this group's ranks),
    each as a function of a field ``X`` ``(2, rows, 3)`` that every rank
    holds alike: each rank cuts its slab (whose backward sums the ranks'
    gradients), applies the collective, pads its result to one shape and
    gathers every rank's (whose backward keeps its own part), so that the
    function is the same on every rank.  ``(halo, gather_rows)``: ``True``
    each, or the error."""
    rows, m, lo, hi = split
    group = dist.group.WORLD
    slab = space.slab_of(group, dist.get_rank(), m, rows)

    def cut(x):
        return S.SumGrad.apply(x, group).narrow(1, slab.row0, slab.rows)

    def halo(x):
        out = space.halo(cut(x), 1, lo, hi, slab)
        return _Gathered.apply(_padded(out, slab.per + lo + hi), group)

    def gather_rows(x):
        whole = space.gather_rows(cut(x), 1, slab)
        mixed = whole * torch.roll(whole, 1, 1)  # each row reads the last
        own = mixed.narrow(1, slab.row0, slab.rows)
        return _Gathered.apply(_padded(own, slab.per), group)

    x = torch.linspace(-1.0, 1.5, 2 * rows * 3, dtype=torch.float64)
    x = x.reshape(2, rows, 3).requires_grad_(True)
    out = []
    for fn in (halo, gather_rows):
        try:
            out.append(torch.autograd.gradcheck(fn, (x,)))
        except Exception as e:  # reported to the parent
            out.append(f"{type(e).__name__}: {e}")
    return tuple(out)


def run_rank(job):
    """Every case of ``job`` on this rank, then the gradchecks of the
    splits over this group's ranks."""
    torch.set_num_threads(1)
    m = dist.get_world_size()
    out = dict(rank=dist.get_rank())
    for case, case_job in job["cases"].items():
        out[case] = run_case(attached(case, case_job["leaves"], m), case_job)
    for split in SPLITS:
        if split[1] == m:
            out[split] = gradchecks(split)
    return out
