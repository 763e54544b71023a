"""The ``Model`` wrapper and its posterior sampler."""
