"""Data and lattice (``space``) parallelism over ``torch.distributed``
(``normflow__tpu/parallel``)."""

from . import space
from .mesh import (Mesh, ModelDeviceHandler, batch_axis, fold_key, fold_seed,
                   free_port, init_distributed, make_mesh)

__all__ = ["ModelDeviceHandler", "make_mesh", "init_distributed", "fold_key",
           "fold_seed", "free_port", "Mesh", "batch_axis", "space"]
