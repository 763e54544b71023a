"""Numerical building blocks: splines, lattice grids, statistics,
observables, kernels."""

from . import observables

__all__ = ["observables"]
