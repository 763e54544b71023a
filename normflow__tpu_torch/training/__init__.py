"""Training: ``Model``, ``Posterior``, ``Fitter``, the losses and the
snapshots, exported as in ``normflow__tpu/training``."""

from . import checkpoint, losses
from .fitter import Fitter
from .model import Model, Posterior, backward_sanitychecker

__all__ = ["Model", "Posterior", "Fitter", "backward_sanitychecker",
           "losses", "checkpoint"]
