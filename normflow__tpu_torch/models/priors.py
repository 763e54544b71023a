"""Prior distributions sampled from an explicit ``torch.Generator``.

Counterpart of ``normflow__tpu/models/priors.py``: ``Prior``,
``NormalPrior`` and ``UniformPrior`` with ``chopped`` for blocked
proposals, and ``PriorList``.  Where the JAX package threads
``jax.random`` keys, the port takes a generator on the prior's device;
``PriorList`` draws its priors in order from the one generator.  Under a
space axis (``parallel/space.py``) a prior draws the slab's rows of its
lattice and its ``log_prob`` sums over the slab (a partial sum).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel import space

__all__ = ["Prior", "NormalPrior", "UniformPrior", "PriorList"]

_LOG_2PI = math.log(2.0 * math.pi)


def _check_homogeneous(tensors, what):
    """Raise unless every tensor holds one value at every site.  Blocked
    proposals reuse one chopped prior for every block, so the proposal
    density matches each block's own marginal only for a homogeneous prior;
    per-site parameters would bias every block after the first."""
    for t in tensors:
        t = t.reshape(-1)
        if t.numel() and not bool((t == t[0]).all()):
            raise ValueError(
                "blocked proposals need a homogeneous prior (identical "
                f"{what} at every site); per-site parameters would bias "
                "every block after the first")


class Prior(nn.Module):
    """``sample_`` returns ``(x, log_prob(x))``; ``log_prob`` sums the
    density over the non-batch axes unless ``density=True``."""

    def sample(self, batch_size: int = 1, generator=None):
        raise NotImplementedError

    def sample_(self, batch_size: int = 1, generator=None, *,
                density: bool = False):
        x = self.sample(batch_size, generator)
        return x, self.log_prob(x, density=density)

    def log_prob(self, x, *, density: bool = False):
        d = self.log_prob_density(x)
        if density:
            return d
        return torch.sum(d, dim=tuple(range(1, d.dim())))

    def log_prob_density(self, x):
        raise NotImplementedError

    @property
    def nvar(self) -> int:
        return math.prod(self.shape)

    @staticmethod
    def _local(t):
        """A per-site parameter ``t`` ``(*shape)``, or its slab's rows
        under a space axis (``parallel/space.py``)."""
        slab = space.current()
        if slab is None:
            return t
        return t.narrow(0, slab.row0, slab.rows)

    @property
    def device(self) -> torch.device:
        """The device of the prior's first buffer."""
        return next(self.buffers()).device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of the prior's first buffer."""
        return next(self.buffers()).dtype


def _pair(a, b, shape, fill, dtype, device):
    """Two parameter tensors: ``fill`` at ``shape``, or ``a`` and ``b``."""
    if shape is not None:
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return (torch.full(shape, fill[0], dtype=dtype, device=device),
                torch.full(shape, fill[1], dtype=dtype, device=device))
    return (torch.as_tensor(a, dtype=dtype, device=device),
            torch.as_tensor(b, dtype=dtype, device=device))


class NormalPrior(Prior):
    """Independent normal prior with per-site ``loc``/``scale`` buffers;
    ``NormalPrior(shape=...)`` is the standard normal."""

    @classmethod
    def build(cls, loc=None, scale=None, shape=None, dtype=None, *,
              device=None):
        """The JAX package's factory."""
        return cls(loc, scale, shape=shape, dtype=dtype, device=device)

    def __init__(self, loc=None, scale=None, *, shape=None, dtype=None,
                 device=None):
        super().__init__()
        loc, scale = _pair(loc, scale, shape, (0.0, 1.0), dtype, device)
        self.register_buffer("loc", loc)
        self.register_buffer("scale", scale)
        self.shape = tuple(loc.shape)

    def sample(self, batch_size: int = 1, generator=None):
        loc, scale = self._local(self.loc), self._local(self.scale)
        z = torch.randn((batch_size, *loc.shape), generator=generator,
                        dtype=loc.dtype, device=loc.device)
        return loc + scale * z

    def log_prob_density(self, x):
        loc, scale = self._local(self.loc), self._local(self.scale)
        z = (x - loc) / scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)

    def chopped(self, block_len: int) -> "NormalPrior":
        """A flattened prior over the first ``block_len`` sites, for
        block-Gibbs proposals; raises ``ValueError`` unless the prior is
        homogeneous."""
        loc, scale = self.loc.reshape(-1), self.scale.reshape(-1)
        _check_homogeneous((loc, scale), "loc/scale")
        return NormalPrior(loc[:block_len], scale[:block_len])


class UniformPrior(Prior):
    """Uniform prior on ``[low, high]`` per site;
    ``UniformPrior(shape=...)`` is uniform on ``[0, 1]``."""

    @classmethod
    def build(cls, low=None, high=None, shape=None, dtype=None, *,
              device=None):
        """The JAX package's factory."""
        return cls(low, high, shape=shape, dtype=dtype, device=device)

    def __init__(self, low=None, high=None, *, shape=None, dtype=None,
                 device=None):
        super().__init__()
        low, high = _pair(low, high, shape, (0.0, 1.0), dtype, device)
        self.register_buffer("low", low)
        self.register_buffer("high", high)
        self.shape = tuple(low.shape)

    def sample(self, batch_size: int = 1, generator=None):
        low, high = self._local(self.low), self._local(self.high)
        u = torch.rand((batch_size, *low.shape), generator=generator,
                       dtype=low.dtype, device=low.device)
        return low + (high - low) * u

    def log_prob_density(self, x):
        low, high = self._local(self.low), self._local(self.high)
        inside = (x >= low) & (x <= high)
        d = -torch.log(high - low)
        return torch.where(inside, d, -math.inf)

    def chopped(self, block_len: int) -> "UniformPrior":
        """As :meth:`NormalPrior.chopped`."""
        low, high = self.low.reshape(-1), self.high.reshape(-1)
        _check_homogeneous((low, high), "low/high")
        return UniformPrior(low[:block_len], high[:block_len])


class PriorList(Prior):
    """Product of priors over a list of fields: samples and log-probs are
    lists, one entry per prior, drawn in order from one generator."""

    def __init__(self, priors):
        super().__init__()
        self.priors = nn.ModuleList(priors)

    def sample(self, batch_size: int = 1, generator=None):
        return [p.sample(batch_size, generator) for p in self.priors]

    def log_prob(self, x, *, density: bool = False):
        return [p.log_prob(x_, density=density)
                for p, x_ in zip(self.priors, x)]

    @property
    def nvar(self) -> int:
        return sum(p.nvar for p in self.priors)

    @property
    def device(self) -> torch.device:
        return self.priors[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.priors[0].dtype
