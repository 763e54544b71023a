"""Weight transplant between the JAX package and the port.

``load_jax_leaves(net, leaves)`` takes the ``{str(i): ndarray}`` dict that
``normflow__tpu.utils.serialization.leaves_of(jax_net)`` produces and copies
it into the port's parameters, in the JAX package's leaf order;
``jax_leaf_grads(net)`` goes the other way for the gradients, so that they
compare leaf by leaf with ``leaves_of(jax_grads)``.  The numpy dict is the
only interface: this module imports nothing of JAX.

A JAX ``CntrCoupling`` holds its control as a ``Const`` leaf after its
nets; the port's keeps it as a buffer, named last in its ``leaf_order``.
The control leaf is copied (not skipped) when both sides have one: the
port's coupling must have drawn its control at the JAX control's shape
first (``refresh_control``), and a coupling without a control on either
side has no such leaf.  Its gradient is zero on both sides.  A
``ConvNet``'s ``compute_dtype`` and ``fuse_out_cast`` are settings, not
leaves (static fields in JAX): they go to the port's constructor or
attribute (``zoo.with_conv_compute_dtype``) under the same names, and the
weights load the same either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.nets import CircularConv, Dense

__all__ = ["jax_leaf_order", "load_jax_leaves", "jax_leaf_grads"]


def jax_leaf_order(module):
    """``(owner, name, tensor)`` for every parameter of ``module``, in
    the JAX package's leaf order: a module's parameters, then its children,
    each in registration order, except where a module names its own order
    (``leaf_order``), which may name a buffer that holds a JAX leaf (a
    ``CntrCoupling``'s control, where it is set)."""
    names = getattr(module, "leaf_order", None)
    listed = names is not None
    if not listed:
        names = [*module._parameters, *module._modules]
    for name in names:
        value = getattr(module, name)
        if isinstance(value, torch.nn.Parameter) or (
                listed and isinstance(value, torch.Tensor)):
            yield module, name, value
        elif isinstance(value, torch.nn.Module):
            yield from jax_leaf_order(value)


@torch.no_grad()
def load_jax_leaves(net, leaves: dict):
    """Copy JAX leaves into ``net``.  Conv weights go HWIO -> OIHW (the
    input-channel order is kept: field first, row parity second) and
    ``Dense`` weights ``(in, out) -> (out, in)``.  Raises on a count or
    shape mismatch."""
    params = list(jax_leaf_order(net))
    if len(params) != len(leaves):
        raise ValueError(f"{len(leaves)} JAX leaves for {len(params)} "
                         "parameters: architecture mismatch")
    for i, (owner, name, p) in enumerate(params):
        a = np.asarray(leaves[str(i)])
        if _is_transposed(owner, name):
            a = a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"leaf {i} ({type(owner).__name__}.{name}): "
                             f"shape {a.shape}, parameter {tuple(p.shape)}")
        p.copy_(torch.tensor(a, dtype=p.dtype))
    return net


def _is_transposed(owner, name):
    """Conv and ``Dense`` weights, whose axes the two packages order
    differently."""
    return isinstance(owner, (CircularConv, Dense)) and name == "weight"


def jax_leaf_grads(net) -> dict:
    """``{str(i): ndarray}`` of every parameter's ``.grad`` in the JAX
    package's leaf order, conv and ``Dense`` gradients transposed back to
    the JAX layouts (a parameter without a gradient gives zeros)."""
    out = {}
    for i, (owner, name, p) in enumerate(jax_leaf_order(net)):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        a = g.detach().cpu().numpy()
        if _is_transposed(owner, name):
            a = a.transpose(*range(2, a.ndim), 1, 0)
        out[str(i)] = a
    return out
