"""Snapshots of a training run: one ``torch.save`` file per save epoch.

Counterpart of ``normflow__tpu/training/checkpoint.py``.  A snapshot holds
the net's ``state_dict``, the optimizer state (``training.optim``: nested
dicts, tuples and lists of tensors, the step counts float64 scalars;
snapshots of earlier versions hold the counts as ints), the epoch counter
and the state of the model's ``torch.Generator``, so that a resumed run
continues bit-exactly.  The fitter copies a loaded optimizer state into its
live tensors (``training.optim.assign_``, which fills a tensor count from
an int), because its captured step keeps those tensors.  It is read back with ``torch.load(weights_only=True)``,
which unpickles tensors and plain containers only.  Paths follow
``<base>.E<epoch>.pt``.
"""

from __future__ import annotations

import os

import torch

__all__ = ["save_snapshot", "load_snapshot", "snapshot_path_for_epoch"]


def snapshot_path_for_epoch(snapshot_path: str, epoch: int) -> str:
    """``<base>.E<epoch>.pt``.  Only the basename's ``[.E<n>][.ext]``
    suffix is stripped: dotted directories and multi-dot basenames keep
    every path component."""
    head, base = os.path.split(snapshot_path)
    parts = base.split(".")
    if len(parts) > 1:
        parts = parts[:-1]  # drop the extension
    if len(parts) > 1 and parts[-1][:1] == "E" and parts[-1][1:].isdigit():
        parts = parts[:-1]  # drop an existing .E<epoch>
    return os.path.join(head, ".".join(parts) + f".E{epoch}.pt")


def save_snapshot(path: str, *, net, opt_state=None, epoch: int = 0,
                  generator=None):
    state = {"net": net.state_dict(), "epochs_run": epoch}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if generator is not None:
        state["generator"] = generator.get_state()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)


def load_snapshot(path: str, *, net, generator=None, device=None):
    """Load the net's weights in place and restore ``generator``'s state.
    Returns ``(opt_state, epoch)``; ``opt_state`` is ``None`` if the
    snapshot has none.  Tensors of the optimizer state land on
    ``device``."""
    state = torch.load(path, map_location=device, weights_only=True)
    net.load_state_dict(state["net"])
    if generator is not None and "generator" in state:
        generator.set_state(state["generator"].cpu())
    return state.get("opt_state"), int(state["epochs_run"])
