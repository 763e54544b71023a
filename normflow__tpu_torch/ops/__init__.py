"""Numerical building blocks: splines, lattice grids, statistics,
observables, kernels.  The names the JAX package's ``ops`` (its ``lib``)
re-exports (``normflow__tpu/ops/__init__.py:13-26``) are here too."""

from . import lattice, observables, spline, stats
from .lattice import (arange_like, lattice_k2, neighbor_mean, outer,
                      outer_arange, outer_linspace, outer_sum,
                      rfft_lattice_k2)
from .spline import augment_knots, rls, rqs
from .stats import Resampler, calc_ess, estimate_logz, fmt_val_err

__all__ = [
    "spline", "lattice", "stats", "observables",
    "rqs", "rls", "augment_knots",
    "Resampler", "estimate_logz", "fmt_val_err", "calc_ess",
    "lattice_k2", "rfft_lattice_k2", "neighbor_mean", "outer", "outer_sum",
    "outer_arange", "outer_linspace", "arange_like",
]
