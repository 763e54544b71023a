"""One rank of the port's 4-D lattice-sharding test (not collected by
pytest).

``tests/test_torch_4d.py`` runs :func:`run_rank` on the two ranks of a gloo
group under ``use_mesh(axes={"data": 1, "space": 2})``: the small 4-D
flagship (``build_phi4_model((4, 4, 4, 4), packed=False)``, 3^4 circular
convs by roll-and-sum, the FFT flow on the gathered lattice) on slabs of
two rows, float64 on the CPU.  Draws and weights come from the parent as
numpy; each rank takes its slab (``_torch_space_worker.share``).  It
imports ``torch`` and the port only.
"""

import torch
import torch.distributed as dist

from normflow__tpu_torch.utils.transplant import load_jax_leaves
from normflow__tpu_torch.zoo import build_phi4_model

import _torch_space_worker as W

LAT = (4, 4, 4, 4)
SMALL = dict(lat_shape=LAT, knots=4, hidden=(4,), n_layers=2, packed=False)


def model4(leaves, axes=None):
    """The small float64 4-D flagship with ``leaves`` (the JAX package's
    leaf order) on the mesh ``axes`` (none: unsharded)."""
    model = build_phi4_model(**SMALL, dtype=torch.float64, device="cpu",
                             seed=3)
    load_jax_leaves(model.net_, leaves)
    if axes is not None:
        model.device_handler.use_mesh(axes=axes)
        model.device_handler.replicate_params()
    return model


def run_rank(job):
    """Both estimators' loss, gradients, logq and logp of ``job["x"]``, and
    ``sample_chain`` / ``sample_parallel_chains`` on the fed rounds, under
    ``job["axes"]``."""
    torch.set_num_threads(1)
    out = dict(rank=dist.get_rank())
    for est in ("rep", "path"):
        out[est] = W.grads_of(model4(job["leaves"], job["axes"]), job["x"],
                              est)
    out["samplers"] = W.samplers(model4(job["leaves"], job["axes"]),
                                 job["chain_rounds"], job["par_rounds"])
    return out
