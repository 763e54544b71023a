"""Numerical building blocks: splines, lattice grids, statistics, kernels."""
