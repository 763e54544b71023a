r"""Fused phi^4 action: stencil + elementwise + reduction in one pass.

Counterpart of ``normflow__tpu/ops/kernels/phi4.py`` (``phi4_action_pallas``,
Pallas kernel ``_phi4_kernel``): the per-sample action

.. math::
    S = \sum_x (w_2 \phi_x^2 + w_4 \phi_x^4)
        - w_0 \sum_{x,\mu} \phi_x \phi_{x-\hat\mu}

on a periodic lattice of 1-3 dims, ``cfgs`` ``(B, *lat)`` -> ``(B,)``.
:func:`phi4_action` is the wrapper: the plain PyTorch version for a CPU
tensor, the CUDA kernel (``csrc/phi4_action.cu``) for a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["phi4_action", "phi4_action_plain"]


def phi4_action_plain(cfgs, w0, w2, w4):
    """Plain PyTorch version: rolls, elementwise terms and a sum."""
    dims = tuple(range(1, cfgs.dim()))
    phi2 = cfgs * cfgs
    act = torch.sum(w2 * phi2 + w4 * phi2 * phi2, dim=dims)
    if w0 != 0.0:
        for mu in dims:
            act = act - w0 * torch.sum(cfgs * torch.roll(cfgs, 1, mu),
                                       dim=dims)
    return act


def phi4_action(cfgs, w0, w2, w4):
    """Per-sample phi^4 action.  CPU tensors take
    :func:`phi4_action_plain`; CUDA tensors (float32, contiguous, 1-3
    lattice dims) launch the kernel or raise.  The kernel has no backward
    yet, so a CUDA call that needs a gradient raises."""
    if cfgs.device.type == "cpu":
        return phi4_action_plain(cfgs, w0, w2, w4)
    if cfgs.device.type != "cuda":
        raise ValueError(f"phi4_action: no kernel for tensors on "
                         f"{cfgs.device}")
    nd = cfgs.dim() - 1
    if not 1 <= nd <= 3:
        raise ValueError(f"phi4_action: the kernel takes 1-3 lattice dims, "
                         f"got shape {tuple(cfgs.shape)}")
    if cfgs.dtype != torch.float32:
        raise TypeError("phi4_action: the CUDA kernel takes float32")
    if not cfgs.is_contiguous():
        raise ValueError("phi4_action: cfgs must be contiguous")
    if torch.is_grad_enabled() and cfgs.requires_grad:
        raise NotImplementedError(
            "phi4_action: the backward kernel is not ported yet")
    b = cfgs.shape[0]
    if not cfgs.numel():  # no sites: the empty sum
        return cfgs.new_zeros(b)
    act = torch.empty(b, dtype=cfgs.dtype, device=cfgs.device)
    lat = list(cfgs.shape[1:]) + [1] * (3 - nd)
    lib = _lib.library()
    with torch.cuda.device(cfgs.device):
        stream = torch.cuda.current_stream(cfgs.device).cuda_stream
        err = lib.phi4_action_f32(
            cfgs.data_ptr(), act.data_ptr(), b, nd, *lat, float(w0),
            float(w2), float(w4), stream)
    _lib.check(err, "phi4_action")
    phi4_action.launches += 1
    return act


phi4_action.launches = 0
