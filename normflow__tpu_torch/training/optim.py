"""Optimizers as plain functions on lists of tensors, with optax's semantics.

Counterpart of the optax chain that ``normflow__tpu/training/fitter.py``
builds (l.145-160, 177-221).  A :class:`Transform` is a pair of functions,
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
new_state)``; ``update`` writes nothing in place, so the caller can check
the updates before it commits them (the fitter's NaN guard keeps the old
parameters *and* the old state).  The step counts are float64 scalars on
the parameters' device, as optax's traced count, and a schedule takes that
tensor, so one captured step (a CUDA graph) reads the count it replays at:
the bias corrections and the learning rate are computed from it in float64
and cast to the parameters' type.  :func:`assign_` copies a state into the
live tensors of another in place, which a captured step keeps.  ``torch.optim.AdamW`` and
``torch.nn.utils.clip_grad_norm_`` are not used: the first updates its
moments in place and decays before it steps, the second divides by
``norm + 1e-6``; both differ from optax.

Semantics kept from optax: Adam's ``count`` starts at 0 and the moments are
bias-corrected with the incremented count, ``eps`` is added outside the
square root, AdamW adds ``weight_decay * p`` to the update before the
learning rate scales it, a schedule is read at the step count before it is
incremented, and ``clip_by_global_norm`` rescales by ``max_norm / norm``
only when the norm reaches ``max_norm``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["Transform", "chain", "clip_by_global_norm", "adamw", "adam",
           "sgd", "multi_transform", "cosine_decay_schedule", "state_leaves",
           "assign_"]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _as_schedule(lr):
    return lr if callable(lr) else (lambda count: lr)


def _count(params):
    """A step count of 0: a float64 scalar on the parameters' device."""
    return torch.zeros((), dtype=torch.float64,
                       device=params[0].device if params else None)


def _in_dtype(value, t, cast):
    """``value`` (a number, or a float64 scalar tensor) in ``t``'s dtype;
    ``cast`` keeps one cast per dtype."""
    if not isinstance(value, torch.Tensor):
        return value
    if t.dtype not in cast:
        cast[t.dtype] = value.to(t.dtype)
    return cast[t.dtype]


def chain(*txs) -> Transform:
    """Apply ``txs`` in order; the state is the tuple of their states."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def clip_by_global_norm(max_norm) -> Transform:
    """Rescale to ``max_norm`` when the global norm is not below it."""

    def update(grads, state, params):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm) * max_norm)
                for g in grads], state

    return Transform(lambda params: (), update)


def _add_decayed_weights(weight_decay) -> Transform:
    def update(grads, state, params):
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return Transform(lambda params: (), update)


def _scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    def init(params):
        return dict(count=_count(params),
                    mu=[torch.zeros_like(p) for p in params],
                    nu=[torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state["nu"])]
        count = state["count"] + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        c1, c2 = {}, {}
        updates = [(m / _in_dtype(bc1, m, c1))
                   / (torch.sqrt(v / _in_dtype(bc2, v, c2)) + eps)
                   for m, v in zip(mu, nu)]
        return updates, dict(count=count, mu=mu, nu=nu)

    return Transform(init, update)


def _scale_by_learning_rate(learning_rate) -> Transform:
    lr = _as_schedule(learning_rate)

    def update(grads, state, params):
        step, cast = -lr(state["count"]), {}
        return ([_in_dtype(step, g, cast) * g for g in grads],
                dict(count=state["count"] + 1))

    return Transform(lambda params: dict(count=_count(params)), update)


def adamw(learning_rate, weight_decay=1e-4, b1=0.9, b2=0.999,
          eps=1e-8) -> Transform:
    """``optax.adamw``: Adam, then ``+ weight_decay * p``, then ``* -lr``."""
    return chain(_scale_by_adam(b1, b2, eps),
                 _add_decayed_weights(weight_decay),
                 _scale_by_learning_rate(learning_rate))


def adam(learning_rate, weight_decay=0.0) -> Transform:
    """``optax.adam`` with L2 folded into the gradient first (torch Adam's
    ``weight_decay``), as the JAX fitter builds it."""
    tx = chain(_scale_by_adam(), _scale_by_learning_rate(learning_rate))
    return chain(_add_decayed_weights(weight_decay), tx) if weight_decay \
        else tx


def sgd(learning_rate, weight_decay=0.0) -> Transform:
    """``optax.sgd`` (no momentum) with L2 folded into the gradient."""
    tx = _scale_by_learning_rate(learning_rate)
    return chain(_add_decayed_weights(weight_decay), tx) if weight_decay \
        else tx


def multi_transform(txs: dict, labels) -> Transform:
    """One transform per group: ``labels[i]`` names the key of ``txs`` that
    updates parameter ``i`` (``optax.multi_transform``).  A group with no
    parameter keeps its state too, on the parameters' device."""
    groups = {k: [i for i, lab in enumerate(labels) if lab == k] for k in txs}

    def pick(xs, k):
        return [xs[i] for i in groups[k]]

    def init(params):
        device = params[0].device if params else None
        return {k: _on(tx.init(pick(params, k)), device)
                for k, tx in txs.items()}

    def update(grads, state, params):
        out, new_state = [None] * len(grads), {}
        for k, tx in txs.items():
            upd, new_state[k] = tx.update(pick(grads, k), state[k],
                                          pick(params, k))
            for i, u in zip(groups[k], upd):
                out[i] = u
        return out, new_state

    return Transform(init, update)


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0,
                          exponent=1.0) -> Callable:
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) *
    (0.5 (1 + cos(pi t / T)))**exponent + alpha)``, ``t`` capped at
    ``T = decay_steps``.  The schedule takes a number or a tensor (the
    optimizer's float64 count, on its device) and returns a float64
    tensor there, computed without reading the count on the host."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = torch.clamp(torch.as_tensor(count, dtype=torch.float64),
                            max=float(decay_steps))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay ** exponent + alpha)

    return schedule


def _on(state, device):
    """``state`` (nested tuples, lists and dicts) with its tensors on
    ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, dict):
        return {k: _on(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_on(v, device) for v in state)
    return state


def state_leaves(state):
    """The tensors of an optimizer state (nested tuples, lists and dicts),
    in a fixed order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        state = [state[k] for k in sorted(state)]
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in state_leaves(s)]
    return []


@torch.no_grad()
def assign_(dst, src):
    """Copy the optimizer state ``src`` into the tensors of ``dst`` in
    place; both have one structure.  A number in ``src`` fills its tensor
    (a count that earlier snapshots saved as an int)."""
    if isinstance(dst, torch.Tensor):
        if isinstance(src, torch.Tensor):
            dst.copy_(src)
        else:
            dst.fill_(src)
    elif isinstance(dst, dict) and isinstance(src, dict) \
            and dst.keys() == src.keys():
        for k in dst:
            assign_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)) and isinstance(src, (list, tuple)) \
            and len(dst) == len(src):
        for d, s in zip(dst, src):
            assign_(d, s)
    else:
        raise ValueError(f"optimizer state of another structure: "
                         f"{type(src).__name__} for {type(dst).__name__}")
