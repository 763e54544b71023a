"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: the port's entry points run on ``cuda``
    unless the caller asks for the CPU.  Raises when no GPU is present
    rather than carrying on on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "normflow__tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return device
