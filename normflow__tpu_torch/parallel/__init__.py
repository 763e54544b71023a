"""Data parallelism over ``torch.distributed`` (``normflow__tpu/parallel``)."""

from .mesh import (ModelDeviceHandler, fold_key, fold_seed, free_port,
                   init_distributed, make_mesh)

__all__ = ["ModelDeviceHandler", "make_mesh", "init_distributed", "fold_key",
           "fold_seed", "free_port"]
