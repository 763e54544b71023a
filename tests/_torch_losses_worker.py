"""One rank of the port's every-loss data-parallel tests (not collected by
pytest).

``tests/test_torch_data_losses.py`` runs :func:`run_rank` on the four ranks
of a gloo group (``ModelDeviceHandler.spawnprocesses``: ``torch.
multiprocessing``, ``spawn``, a free ``localhost`` port, one thread each).
Two meshes: each pair of ranks ``{0, 1}``, ``{2, 3}`` as a data axis of two
ranks (the second pair repeats the first), and ``{"data": 2, "space": 2}``
over all four.  On each, the affine model of ``tests/test_parallel.py:
17-29`` fits three steps for every loss of ``training/losses.py`` but
``calc_ess`` (a metric, not a loss) with each gradient estimator.  It
imports ``torch`` and the port only; every draw comes from the parent as
numpy, and each rank takes its share and its slab (``_torch_space_worker.
share``).  Everything runs in float64 on the CPU.
"""

import warnings

import torch
import torch.distributed as dist

from normflow__tpu_torch.parallel import Mesh
from normflow__tpu_torch.training import losses

import _torch_space_worker as S

LOSSES = ("calc_kl_mean", "calc_kl_var", "calc_corrcoef",
          "calc_direct_kl_mean", "calc_kl_mean_includelogz",
          "calc_least_squares", "calc_minus_logz", "calc_minus_ess")
ESTIMATORS = ("rep", "path")
MESHES = ("data", "data x space")
FIT = dict(hyperparam=dict(lr=1e-3, weight_decay=0.01),
           checkpoint_dict=dict(print_stride=None))


def flat(model):
    """The model's parameters, flattened in the port's order."""
    return torch.cat([p.detach().reshape(-1)
                      for p in model.net_.parameters()]).numpy()


def fit_run(model, draws, loss, estimator):
    """``len(draws)`` steps of ``loss`` on the fed draws: ``(loss history,
    parameters)``; the history is the handler's rank 0's."""
    S.feed_fit(model, draws)
    with warnings.catch_warnings():  # the path estimator's bias warning
        warnings.simplefilter("ignore")
        hist = model.fit(n_epochs=len(draws), batch_size=draws[0].shape[0],
                         loss_fn=getattr(losses, loss),
                         grad_estimator=estimator, **FIT)
    return list(hist["loss"]), flat(model)


def attached(leaves, mesh):
    """The affine model on ``mesh`` (a group or a ``Mesh``), rank 0's
    weights broadcast."""
    model = S.affine_model(leaves)
    model.device_handler.use_mesh(mesh=mesh)
    model.device_handler.replicate_params()
    return model


def gather_gradcheck(dh):
    """``torch.autograd.gradcheck`` of ``gather_rows`` over the data
    axis: the function from a global batch ``X`` (the same on every rank)
    to the gathered ``(x, x sin x)`` of each rank's share ``x``, which is
    ``(X, X sin X)``.  Its analytic Jacobian takes the gather's backward
    (this rank's rows of the cotangent) and sums the ranks' parts, as the
    training step does.  ``True``, or the error."""
    n, b = dh.n_data, 3

    def fn(x):
        x = S.SumGrad.apply(x, dh.data_group).narrow(0, dh.data_rank * b, b)
        return dh.gather_rows(x, x * torch.sin(x))

    x = torch.linspace(-1.5, 2.0, n * b, dtype=torch.float64,
                       requires_grad=True)
    try:
        return torch.autograd.gradcheck(fn, (x,))
    except Exception as e:  # reported to the parent
        return f"{type(e).__name__}: {e}"


def run_rank(job):
    """Every fit and the gradcheck, on this rank."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    meshes = dict(zip(MESHES, (pairs[rank // 2],
                               Mesh({"data": 2, "space": 2}))))
    out = dict(rank=rank)
    for name, mesh in meshes.items():
        for loss in LOSSES:
            for est in ESTIMATORS:
                out[name, loss, est] = fit_run(attached(job["leaves"], mesh),
                                               job["draws"], loss, est)
    out["gradcheck"] = gather_gradcheck(
        attached(None, pairs[rank // 2]).device_handler)
    return out


def one_rank_fits(leaves, draws):
    """Every fit on one rank, no group: ``{(loss, estimator): (losses,
    parameters)}``."""
    return {(loss, est): fit_run(S.affine_model(leaves), draws, loss, est)
            for loss in LOSSES for est in ESTIMATORS}


def as_port_params(leaves):
    """The JAX leaves as the port's flattened parameters."""
    return flat(S.affine_model(leaves))
