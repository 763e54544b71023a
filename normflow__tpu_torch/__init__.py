"""PyTorch + CUDA port of ``normflow__tpu`` for NVIDIA Hopper GPUs.

The JAX package ``normflow__tpu`` stays the reference; this package keeps
its module and class names so each counterpart is easy to find.  It imports
``torch`` and ``numpy`` only, never JAX or anything of the JAX package.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Every hand-written kernel sits beside a plain PyTorch
version of the same function; its wrapper takes the plain version only for a
tensor on the CPU, launches the kernel for a CUDA tensor, and raises for any
other device.

The reference's layout is kept too: ``nn`` (the flows under the
reference's names), ``prior``, ``action``, ``mask``, ``lib`` (the numerical
building blocks) and ``zoo``; ``normflow__tpu_torch.examples`` holds the
ported examples.
"""

from . import mcmc, models, nn, ops, parallel, training, zoo
from .models import actions as action
from .models import masks as mask
from .models import priors as prior
from . import ops as lib
from .mcmc.metropolis import (BlockedMCMCSampler, MCMCHistory, MCMCSampler,
                              Metropolis, ModifiedMetropolis, accept_scan,
                              accept_scan_core, estimate_accept_rate)
from .models.priors import NormalPrior, PriorList, UniformPrior
from .ops import observables
from .ops.stats import Resampler, calc_ess, estimate_logz, fmt_val_err
from .training import losses
from .training.fitter import Fitter
from .training.losses import (calc_corrcoef, calc_direct_kl_mean,
                              calc_kl_mean, calc_kl_mean_includelogz,
                              calc_kl_var, calc_least_squares, calc_minus_ess,
                              calc_minus_logz)
from .training.model import Model, Posterior, backward_sanitychecker
from .training.optim import cosine_decay_schedule

__all__ = [
    "Model", "Posterior", "backward_sanitychecker", "MCMCSampler",
    "BlockedMCMCSampler", "MCMCHistory", "Metropolis", "ModifiedMetropolis",
    "accept_scan", "accept_scan_core", "estimate_accept_rate", "mcmc", "ops",
    "observables", "NormalPrior", "UniformPrior", "PriorList", "Resampler",
    "calc_ess", "estimate_logz", "fmt_val_err", "Fitter", "losses",
    "calc_kl_mean", "calc_kl_var", "calc_corrcoef", "calc_direct_kl_mean",
    "calc_kl_mean_includelogz", "calc_least_squares", "calc_minus_logz",
    "calc_minus_ess", "cosine_decay_schedule", "nn", "zoo", "prior",
    "action", "mask", "lib", "models", "parallel", "training",
]
