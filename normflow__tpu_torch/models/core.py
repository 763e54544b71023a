"""Bijection core: the ``(y, logJ)`` flow protocol and the flow list.

Counterpart of ``normflow__tpu/models/core.py:33-150``.  Flows are
``torch.nn.Module``s holding their weights as ``nn.Parameter``s;
``forward(x, log0=0., density=False) -> (y, log0 + logJ)`` and
``backward(y, log0=0., density=False) -> (x, log0 - logJ)``.  ``logJ`` is
per sample, shape ``(B,)``, or its per-site density when ``density=True``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Flow", "FlowList", "sum_density"]


def sum_density(x, density: bool = False):
    """Reduce a per-site log-Jacobian density over the non-batch axes
    (axis 0 is the batch axis); ``density=True`` keeps the density."""
    if density or x.dim() <= 1:
        return x
    return torch.sum(x, dim=tuple(range(1, x.dim())))


class Flow(nn.Module):
    """Base invertible module (see the module docstring for the contract)."""

    def forward(self, x, log0=0.0, *, density: bool = False):
        raise NotImplementedError

    def backward(self, x, log0=0.0, *, density: bool = False):
        raise NotImplementedError


class FlowList(Flow):
    """Sequential composition: ``forward`` in order, ``backward`` in
    reverse order, accumulating the log-Jacobian."""

    def __init__(self, flows):
        super().__init__()
        self.flows = nn.ModuleList(flows)

    def forward(self, x, log0=0.0, *, density: bool = False):
        for f in self.flows:
            x, log0 = f.forward(x, log0, density=density)
        return x, log0

    def backward(self, x, log0=0.0, *, density: bool = False):
        for f in reversed(self.flows):
            x, log0 = f.backward(x, log0, density=density)
        return x, log0

    def __getitem__(self, i):
        return self.flows[i]

    @property
    def npar(self) -> int:
        return sum(p.numel() for p in self.parameters())
