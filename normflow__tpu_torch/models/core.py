"""Bijection core: the ``(y, logJ)`` flow protocol and the flow list.

Counterpart of ``normflow__tpu/models/core.py``.  Flows are
``torch.nn.Module``s holding their weights as ``nn.Parameter``s;
``forward(x, log0=0., density=False) -> (y, log0 + logJ)`` and
``backward(y, log0=0., density=False) -> (x, log0 - logJ)``.  ``logJ`` is
per sample, shape ``(B,)``, or its per-site density when ``density=True``.

A frozen flow (:class:`Frozen`, :func:`freeze`) is one whose parameters do
not require gradients: they take no gradient, and the ``Fitter``, which
trains exactly the parameters that require one, gives them no update and
no weight decay.

``FlowList`` also has the JAX list's ``hack`` (every intermediate),
portable weight blobs (``get_weights_blob`` / ``set_weights_blob``: base64
of the port's own ``torch.save`` of the ``state_dict``, not the JAX
package's flax msgpack, so neither package reads the other's blob) and
``freeze_parameters`` / ``unfreeze_parameters`` (``normflow__tpu/models/
core.py:104-160``).

``transfer(**kwargs)`` maps a flow onto another lattice (coarse-to-fine
training, ``normflow__tpu/models/core.py:62, 135``).  The JAX flows are
immutable, so their ``transfer`` returns a new pytree; here it returns a
new module with weights of its own and leaves the source as it was.
"""

from __future__ import annotations

import base64
import copy
import io

import torch
from torch import nn

__all__ = ["Flow", "FlowList", "MultiChannelFlow", "MultiOutChannelFlow",
           "InvisibilityMaskWrapper", "Frozen", "freeze", "unfreeze",
           "trainable_mask", "sum_density"]


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

    def transfer(self, **kwargs):
        """This flow on another lattice, as a new module: a copy, for a
        flow that does not depend on the lattice (the keywords, e.g.
        ``shape`` and ``mask``, are for the flows that do)."""
        return copy.deepcopy(self)


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

    def hack(self, x, log0=0.0, **kwargs):
        """The forward pass with every intermediate: ``[(x, log0), (x1,
        log1), ...]``, one pair per flow after the input."""
        stack = [(x, log0)]
        for f in self.flows:
            x, log0 = f.forward(x, log0, **kwargs)
            stack.append((x, log0))
        return stack

    def get_weights_blob(self) -> str:
        """The ``state_dict`` as a base64 string."""
        buf = io.BytesIO()
        torch.save(self.state_dict(), buf)
        return base64.b64encode(buf.getvalue()).decode("utf-8")

    def set_weights_blob(self, blob: str) -> "FlowList":
        """A copy of this list with the weights of ``blob``
        (:meth:`get_weights_blob`); raises ``ValueError`` unless the blob's
        names and shapes are this list's."""
        device = next(self.parameters()).device
        state = torch.load(io.BytesIO(base64.b64decode(blob.strip())),
                           map_location=device, weights_only=True)
        new = copy.deepcopy(self)
        try:
            new.load_state_dict(state)
        except RuntimeError as e:
            raise ValueError(f"weights blob does not fit this flow -- model "
                             f"architecture mismatch: {e}") from None
        return new

    @property
    def npar(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def transfer(self, **kwargs):
        """Every flow transferred with the same keywords, in a new list."""
        return FlowList([f.transfer(**kwargs) for f in self.flows])

    def freeze_parameters(self) -> "FlowList":
        """A copy of this list whose flows are each :class:`Frozen`."""
        return FlowList([freeze(f) for f in copy.deepcopy(self).flows])

    def unfreeze_parameters(self) -> "FlowList":
        """A copy of this list with every :class:`Frozen` flow unwrapped
        (its parameters require gradients again)."""
        return FlowList([unfreeze(f) for f in copy.deepcopy(self).flows])


class Frozen(Flow):
    """An inner flow whose parameters take no gradient and no update: it
    sets ``requires_grad`` off on them (:func:`unfreeze` sets it back)."""

    def __init__(self, flow):
        super().__init__()
        self.flow = flow.requires_grad_(False)

    def forward(self, x, log0=0.0, **kwargs):
        return self.flow.forward(x, log0, **kwargs)

    def backward(self, x, log0=0.0, **kwargs):
        return self.flow.backward(x, log0, **kwargs)


def freeze(flow):
    return flow if isinstance(flow, Frozen) else Frozen(flow)


def unfreeze(flow):
    return flow.flow.requires_grad_(True) if isinstance(flow, Frozen) else flow


def trainable_mask(net) -> dict:
    """``{parameter name: bool}`` of ``net``: ``False`` under every
    :class:`Frozen` module."""
    frozen = {name for name, m in net.named_modules()
              if isinstance(m, Frozen)}

    def under(name):
        parts = name.split(".")
        return any(".".join(parts[:i]) in frozen for i in range(len(parts)))

    return {name: not under(name) for name, _ in net.named_parameters()}


class MultiChannelFlow(Flow):
    """Flow ``k`` acts on channel ``k`` along ``channels_axis``: as a slice
    of size 1 (``keep_channels_axis=True``) or with the axis dropped and
    restacked after."""

    def __init__(self, flows, channels_axis=-1, keep_channels_axis=True):
        super().__init__()
        self.flows = nn.ModuleList(flows)
        self.channels_axis = channels_axis
        self.keep_channels_axis = keep_channels_axis

    def forward(self, x, log0=0.0, *, density: bool = False):
        return self._map(x, [f.forward for f in self.flows], log0, density)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return self._map(x, [f.backward for f in self.flows], log0, density)

    def _map(self, x, fns, log0, density):
        axis = self.channels_axis % x.dim()
        if x.shape[axis] != len(fns):
            raise ValueError("mismatch in channels of input & network.")
        if self.keep_channels_axis:
            parts = x.split(1, dim=axis)
        else:
            parts = x.unbind(axis)
        outs = [fn(p, density=density) for fn, p in zip(fns, parts)]
        stack = torch.cat if self.keep_channels_axis else torch.stack
        y = stack([o[0] for o in outs], dim=axis)
        return y, log0 + sum(o[1] for o in outs)


class MultiOutChannelFlow(MultiChannelFlow):
    """Every flow sees the whole input; the outputs are concatenated along
    ``channels_axis``."""

    def _map(self, x, fns, log0, density):
        outs = [fn(x, density=density) for fn in fns]
        y = torch.cat([o[0] for o in outs], dim=self.channels_axis)
        return y, log0 + sum(o[1] for o in outs)


class InvisibilityMaskWrapper(Flow):
    """The inner flow transforms only the visible partition of ``mask``;
    its log-Jacobian is taken as a density so that the invisible sites'
    share is masked out before the sum."""

    def __init__(self, flow, mask):
        super().__init__()
        self.flow = flow
        self.mask = mask

    def forward(self, x, log0=0.0, *, density: bool = False):
        return self._visible(x, log0, density, self.flow.forward)

    def backward(self, x, log0=0.0, *, density: bool = False):
        return self._visible(x, log0, density, self.flow.backward)

    def _visible(self, x, log0, density, fn):
        x_v, x_inv = self.mask.split(x)
        x_v, logj_density = fn(x_v, density=True)
        x_v = self.mask.purify(x_v, channel=0)
        logj = sum_density(self.mask.purify(logj_density, channel=0),
                           density)
        return self.mask.cat(x_v, x_inv), log0 + logj
