"""Helpers: device resolution, CUDA graphs, the weight transplant from
the JAX package, and the profiling hooks (exported here, as in
``normflow__tpu/utils``)."""

from .profiling import Timer, profile_fn, trace

__all__ = ["trace", "profile_fn", "Timer"]
