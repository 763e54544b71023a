"""Conditioner nets: circular convolutions, conv stacks, row-parity feature.

Counterpart of ``normflow__tpu/models/nets.py``: ``CircularConv``
(l.64-132), ``ConvNet`` (l.149-222), ``RowParityFeature`` (l.244-261) and
the ``ACTIVATIONS`` the flagship uses.  Data here is NCHW, PyTorch's
layout; weights are OIHW (the JAX package keeps channels last and HWIO
weights, ``utils.transplant`` converts).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ACTIVATIONS", "CircularConv", "ConvNet", "RowParityFeature"]

ACTIVATIONS = {"tanh": torch.tanh}

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class CircularConv(nn.Module):
    """One conv layer with periodic padding, 1-3 spatial dims.

    Weights start Kaiming-uniform with bound ``1/sqrt(fan_in)``, PyTorch's
    conv default and the JAX package's init (``nets.py:49-61``)."""

    def __init__(self, in_channels, out_channels, kernel_size, *, conv_dim=2,
                 bias=True, generator=None, dtype=None, device=None):
        super().__init__()
        ks = ((kernel_size,) * conv_dim if isinstance(kernel_size, int)
              else tuple(kernel_size))
        if len(ks) != conv_dim or conv_dim not in _CONV:
            raise ValueError(f"conv_dim {conv_dim} with kernel {ks}")
        bound = 1.0 / math.sqrt(in_channels * math.prod(ks))

        def uniform(shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float64)
            return nn.Parameter(((2 * u - 1) * bound).to(dtype=dtype,
                                                         device=device))

        self.weight = uniform((out_channels, in_channels, *ks))
        self.bias = uniform((out_channels,)) if bias else None
        self.conv_dim = conv_dim

    def forward(self, x):
        # periodic 'same' padding split ((k-1)//2, k//2) as in the JAX
        # package; F.pad lists the last spatial dim first
        pad = []
        for k in reversed(self.weight.shape[2:]):
            pad += [(k - 1) // 2, k // 2]
        x = F.pad(x, pad, mode="circular")
        return _CONV[self.conv_dim](x, self.weight, self.bias)


class ConvNet(nn.Module):
    """Stack of circular conv layers, one activation name (or ``None``)
    per layer; sizes ``[in_channels, *hidden_sizes, out_channels]``."""

    def __init__(self, in_channels, out_channels, kernel_size, *, conv_dim=2,
                 hidden_sizes=(), acts=(None,), bias=True, generator=None,
                 dtype=None, device=None):
        super().__init__()
        sizes = [in_channels, *hidden_sizes, out_channels]
        acts = tuple(acts)
        if len(acts) != len(hidden_sizes) + 1:
            raise ValueError("one activation per layer")
        self.layers = nn.ModuleList(
            CircularConv(sizes[i], sizes[i + 1], kernel_size,
                         conv_dim=conv_dim, bias=bias, generator=generator,
                         dtype=dtype, device=device)
            for i in range(len(acts)))
        self.acts = acts

    def forward(self, x):
        for layer, act in zip(self.layers, self.acts):
            x = layer(x)
            if act is not None:
                x = ACTIVATIONS[act](x)
        return x


class RowParityFeature(nn.Module):
    """Appends a +-1 row-parity plane ``2 (row % 2) - 1`` as the last input
    channel, after the field, so a shared-weight conv on the
    checkerboard-packed grid can tell its row-skewed geometry apart."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        rows = torch.arange(x.shape[2], device=x.device)
        par = (2.0 * (rows % 2) - 1.0).to(x.dtype)
        shape = [1, 1, x.shape[2]] + [1] * (x.dim() - 3)
        plane = par.reshape(shape).expand(x.shape[0], 1, *x.shape[2:])
        return self.net(torch.cat([x, plane], dim=1))
