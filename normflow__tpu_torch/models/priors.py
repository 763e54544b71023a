"""Prior distributions sampled from an explicit ``torch.Generator``.

Counterpart of ``Prior``/``NormalPrior``
(``normflow__tpu/models/priors.py:45-103``): where the JAX package threads
``jax.random`` keys, the port takes a generator on the prior's device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Prior", "NormalPrior"]

_LOG_2PI = math.log(2.0 * math.pi)


class Prior(nn.Module):
    """``sample_`` returns ``(x, log_prob(x))``; ``log_prob`` sums the
    density over the non-batch axes unless ``density=True``."""

    def sample(self, batch_size: int = 1, generator=None):
        raise NotImplementedError

    def sample_(self, batch_size: int = 1, generator=None):
        x = self.sample(batch_size, generator)
        return x, self.log_prob(x)

    def log_prob(self, x, *, density: bool = False):
        d = self.log_prob_density(x)
        if density:
            return d
        return torch.sum(d, dim=tuple(range(1, d.dim())))

    def log_prob_density(self, x):
        raise NotImplementedError


class NormalPrior(Prior):
    """Independent normal prior with per-site ``loc``/``scale`` buffers;
    ``NormalPrior(shape=...)`` is the standard normal."""

    def __init__(self, loc=None, scale=None, *, shape=None, dtype=None,
                 device=None):
        super().__init__()
        if shape is not None:
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            loc = torch.zeros(shape, dtype=dtype, device=device)
            scale = torch.ones(shape, dtype=dtype, device=device)
        else:
            loc = torch.as_tensor(loc, dtype=dtype, device=device)
            scale = torch.as_tensor(scale, dtype=dtype, device=device)
        self.register_buffer("loc", loc)
        self.register_buffer("scale", scale)
        self.shape = tuple(loc.shape)

    def sample(self, batch_size: int = 1, generator=None):
        z = torch.randn((batch_size, *self.shape), generator=generator,
                        dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * z

    def log_prob_density(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)
