"""PyTorch + CUDA port of ``normflow__tpu`` for NVIDIA Hopper GPUs.

The JAX package ``normflow__tpu`` stays the reference; this package keeps
its module and class names so each counterpart is easy to find.  It imports
``torch`` and ``numpy`` only, never JAX or anything of the JAX package.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Every hand-written kernel sits beside a plain PyTorch
version of the same function; its wrapper takes the plain version only for a
tensor on the CPU, launches the kernel for a CUDA tensor, and raises for any
other device.
"""

from .mcmc.metropolis import (MCMCSampler, Metropolis, accept_scan_core,
                              estimate_accept_rate)
from .ops.stats import Resampler, calc_ess
from .training.model import Model, Posterior, backward_sanitychecker

__all__ = [
    "Model", "Posterior", "backward_sanitychecker", "MCMCSampler",
    "Metropolis", "accept_scan_core", "estimate_accept_rate", "Resampler",
    "calc_ess",
]
