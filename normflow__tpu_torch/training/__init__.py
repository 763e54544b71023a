"""The ``Model`` wrapper, its posterior sampler and its fitter."""
