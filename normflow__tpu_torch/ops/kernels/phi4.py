r"""Fused phi^4 action: stencil + elementwise + reduction in one pass.

Counterpart of ``normflow__tpu/ops/kernels/phi4.py`` (``phi4_action_pallas``,
Pallas kernels ``_phi4_kernel`` and ``_phi4_grad_kernel``): the per-sample
action

.. math::
    S = \sum_x (w_2 \phi_x^2 + w_4 \phi_x^4)
        - w_0 \sum_{x,\mu} \phi_x \phi_{x-\hat\mu}

on a periodic lattice of 1-4 dims, ``cfgs`` ``(B, *lat)`` -> ``(B,)``, and
its gradient, the analytic force times the per-sample cotangent.
:func:`phi4_action` is differentiable; it and :func:`phi4_action_grad` run
the plain PyTorch version for a CPU tensor and the CUDA kernel
(``csrc/phi4_action.cu``) for a CUDA tensor.  The action and its
gradient each have three hand-written variants, chosen by shape and
alignment (:func:`action_variant`): the tiled kernel for 2-D lattices that
suit its float4 tile (the 2-D flagships'), the tiled nd kernel for 3-D and
4-D lattices that suit its tile (:func:`action_plan_nd`: the 8^4
flagship's), and the general kernel for every other lattice of 1-4 dims
(the JAX package's Pallas kernel takes 1-3 dims and leaves 4-D to XLA,
``actions.py:60-69``; the port's kernels take the fourth axis too, so no
lattice it builds falls off a kernel).  A field of 5 or more lattice dims
raises on the card.  ``phi4_action.tiled_launches`` and
``phi4_action_grad.tiled_launches`` count both tiled kernels' share of
each wrapper's ``launches``.  As for the coupling's wrappers, the counts grow
where the wrapper launches from the host: once per capture under a CUDA
graph, not once per replay (``tools/kernel_times.device_launches`` counts
a replay's launches by kernel name).

The slab variants (:func:`phi4_action_slab`, :func:`phi4_action_slab_grad`)
are what kernels 3 and 4 become under lattice sharding
(``parallel/space.py``): a rank holds the rows ``(B, l0, *rest)`` of each
sample and the ``halo`` ``(B, 2, *rest)``, the row before its slab and the
row after it.  Along the first lattice axis nothing wraps: the action sums
its slab's sites and reads the row before the slab for the first row's
backward neighbour (the row after is the next slab's to pair with), the
force on the slab's sites reads both.  The other axes are periodic.  They
port no Pallas kernel of their own (the JAX package's sharded action is
XLA's roll with the partitioner's halos), and each has its plain version
beside it, its launch counters and the whole lattice's variants by the
whole lattice's rules applied to the slab's extents (:func:`slab_variant`):
the 2-D tile, the tiled nd kernels at 3-D and 4-D (:func:`slab_plan_nd`,
whose ring stage holds the halo rows around the slab's), the general slab
kernels otherwise.  ``phi4_action_slab.tiled_launches`` and its force's
count both tiled variants.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import _lib

__all__ = ["phi4_action", "phi4_action_plain", "phi4_action_grad",
           "phi4_action_grad_plain", "action_plan", "action_plan_nd",
           "action_variant", "slab_plan_nd", "slab_variant",
           "phi4_action_slab", "phi4_action_slab_plain",
           "phi4_action_slab_grad", "phi4_action_slab_grad_plain"]

# threads per block of the tiled action kernel, filled with whole samples
# (one sample where a sample alone has more)
THREADS_PER_BLOCK = 256


def action_plan(lat):
    """``(groups, samples)`` of the tiled action kernel for a lattice
    ``lat``: float4 groups per sample (one thread each) and samples per
    block; ``None`` where the lattice does not suit the tile (not 2-D, the
    second extent not a multiple of 4, or the groups not a whole number of
    warps up to 1024, or none)."""
    if len(lat) != 2 or lat[1] % 4:
        return None
    groups = lat[0] * lat[1] // 4
    if not groups or groups % 32 or groups > 1024:
        return None
    return groups, max(1, THREADS_PER_BLOCK // groups)


# the tiled nd kernels' tile (csrc/phi4_action.cu): float4 groups a sample
# at most (kNdMaxGroups), threads a block at least (kNdThreads, or a
# sample's groups)
ND_MAX_GROUPS = 1024
ND_THREADS = 256


def action_plan_nd(lat):
    """``(groups, threads, strides)`` of the tiled nd kernels for a 3-D or
    4-D lattice ``lat``: float4 groups per sample, threads per block (the
    smallest multiple of axis 0's float4 stride that divides the groups, is
    a whole number of warps and is at least ``ND_THREADS`` or the groups;
    each thread takes ``groups // threads`` groups, ``threads`` apart) and
    the float4 strides of the axes but the last; ``None`` where the lattice
    does not suit the tile (not 3-D or 4-D, the last extent not a multiple
    of 4, or the groups not a whole number of warps up to
    ``ND_MAX_GROUPS``).  The C entry derives the same tile from the
    extents (``nd_tile``)."""
    if len(lat) not in (3, 4) or lat[-1] % 4:
        return None
    groups = math.prod(lat) // 4
    if not groups or groups % 32 or groups > ND_MAX_GROUPS:
        return None
    strides = tuple(math.prod(lat[mu + 1:]) // 4
                    for mu in range(len(lat) - 1))
    want = min(groups, ND_THREADS)
    threads = next(j * strides[0] for j in range(1, lat[0] + 1)
                   if lat[0] % j == 0 and j * strides[0] % 32 == 0
                   and j * strides[0] >= want)
    return groups, threads, strides


def action_variant(lat, *ptrs):
    """The kernel the action and its gradient take for a lattice ``lat``
    when every address in ``ptrs`` (the field's; for the gradient, the
    force's too) suits float4 accesses: ``"tiled"`` where
    :func:`action_plan` has a tile, ``"tiled_nd"`` where
    :func:`action_plan_nd` has one; ``"general"`` otherwise."""
    if not all(p % 16 == 0 for p in ptrs):
        return "general"
    if action_plan(lat) is not None:
        return "tiled"
    return "tiled_nd" if action_plan_nd(lat) is not None else "general"


def slab_plan_nd(lat):
    """``(groups, threads, strides, stage)`` of the tiled nd slab kernels
    for a slab of lattice shape ``lat`` (``l0`` rows and the rest): the
    tile :func:`action_plan_nd` gives the slab's extents, and the float4s
    of a ring stage, ``groups + 2 strides[0]``: halo row 0, the slab's
    rows, halo row 1, so that a site's neighbours along axis 0 are always
    ``strides[0]`` before and after it; ``None`` where the slab does not
    suit the tile.  The C entries derive the same from the extents
    (``slab_nd_tile``)."""
    plan = action_plan_nd(lat)
    if plan is None:
        return None
    groups, threads, strides = plan
    return groups, threads, strides, groups + 2 * strides[0]


def slab_variant(lat, *ptrs):
    """The slab kernels' variant for a slab of lattice shape ``lat``
    (rows and the rest) when every address in ``ptrs`` (the slab's and the
    halo's; for the force, the force's too) suits float4 accesses: the
    whole lattice's rules on the slab's extents (:func:`action_variant`),
    ``"tiled"`` where :func:`action_plan` has a 2-D tile, ``"tiled_nd"``
    where :func:`slab_plan_nd` has one; ``"general"`` otherwise."""
    return action_variant(lat, *ptrs)


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


def phi4_action_grad_plain(cfgs, g, w0, w2, w4):
    r"""Plain PyTorch version of the gradient: the force
    :math:`2 w_2 \phi + 4 w_4 \phi^3 - w_0 \sum_\mu (\phi_{x-\hat\mu} +
    \phi_{x+\hat\mu})` times the per-sample cotangent ``g`` ``(B,)``, in
    the order of operations of the Pallas kernel ``_phi4_grad_kernel``."""
    dv = (2.0 * w2) * cfgs + (4.0 * w4) * (cfgs * cfgs) * cfgs
    if w0 != 0.0:
        neigh = 0.0
        for mu in range(1, cfgs.dim()):
            neigh = (neigh + torch.roll(cfgs, 1, mu)
                     + torch.roll(cfgs, -1, mu))
        dv = dv - w0 * neigh
    return dv * g.reshape((-1,) + (1,) * (cfgs.dim() - 1))


def _check_cuda(name, cfgs):
    if cfgs.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {cfgs.device}")
    nd = cfgs.dim() - 1
    if not 1 <= nd <= 4:
        raise ValueError(f"{name}: the kernel takes 1-4 lattice dims, got "
                         f"shape {tuple(cfgs.shape)}")
    if cfgs.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32")
    if not cfgs.is_contiguous():
        raise ValueError(f"{name}: cfgs must be contiguous")
    return list(cfgs.shape[1:]) + [1] * (4 - nd)


def _action(cfgs, w0, w2, w4):
    if cfgs.device.type == "cpu":
        return phi4_action_plain(cfgs, w0, w2, w4)
    lat = _check_cuda("phi4_action", cfgs)
    b = cfgs.shape[0]
    if not cfgs.numel():  # no sites: the empty sum
        return cfgs.new_zeros(b)
    act = torch.empty(b, dtype=cfgs.dtype, device=cfgs.device)
    lib = _lib.library()
    w = (float(w0), float(w2), float(w4))
    with torch.cuda.device(cfgs.device):
        stream = torch.cuda.current_stream(cfgs.device).cuda_stream
        variant = action_variant(cfgs.shape[1:], cfgs.data_ptr())
        if variant == "tiled":
            _, samples = action_plan(cfgs.shape[1:])
            err = lib.phi4_action_tiled_f32(
                cfgs.data_ptr(), act.data_ptr(), b, *lat[:2], samples, *w,
                stream)
        else:
            entry = (lib.phi4_action_tiled_nd_f32 if variant == "tiled_nd"
                     else lib.phi4_action_f32)
            err = entry(cfgs.data_ptr(), act.data_ptr(), b, cfgs.dim() - 1,
                        *lat, *w, stream)
    _lib.check(err, "phi4_action")
    phi4_action.launches += 1
    phi4_action.tiled_launches += variant != "general"
    return act


def phi4_action_grad(cfgs, g, w0, w2, w4):
    """``g[b] * dS_b/dcfgs``: :func:`phi4_action_grad_plain` for CPU
    tensors; CUDA tensors (float32, contiguous, 1-4 lattice dims, ``g`` of
    shape ``(B,)``) launch the kernel or raise."""
    if g.shape != cfgs.shape[:1]:
        raise ValueError(f"phi4_action_grad: cotangent {tuple(g.shape)} for "
                         f"configurations {tuple(cfgs.shape)}")
    if cfgs.device.type == "cpu" and g.device.type == "cpu":
        return phi4_action_grad_plain(cfgs, g, w0, w2, w4)
    lat = _check_cuda("phi4_action_grad", cfgs)
    if g.device != cfgs.device or g.dtype != torch.float32 \
            or not g.is_contiguous():
        raise ValueError("phi4_action_grad: the cotangent must be a "
                         "contiguous float32 tensor on the field's device")
    grad = torch.empty_like(cfgs)
    if cfgs.numel():
        lib = _lib.library()
        ptrs = (cfgs.data_ptr(), g.data_ptr(), grad.data_ptr())
        b, w = cfgs.shape[0], (float(w0), float(w2), float(w4))
        variant = action_variant(cfgs.shape[1:], ptrs[0], ptrs[2])
        with torch.cuda.device(cfgs.device):
            stream = torch.cuda.current_stream(cfgs.device).cuda_stream
            if variant == "tiled":
                _, samples = action_plan(cfgs.shape[1:])
                err = lib.phi4_action_grad_tiled_f32(*ptrs, b, *lat[:2],
                                                     samples, *w, stream)
            else:
                entry = (lib.phi4_action_grad_tiled_nd_f32
                         if variant == "tiled_nd"
                         else lib.phi4_action_grad_f32)
                err = entry(*ptrs, b, cfgs.dim() - 1, *lat, *w, stream)
        _lib.check(err, "phi4_action_grad")
        phi4_action_grad.launches += 1
        phi4_action_grad.tiled_launches += variant != "general"
    return grad


def phi4_action_slab_plain(cfgs, halo, w0, w2, w4):
    """Plain PyTorch version of the slab action: the sum over the slab
    ``cfgs`` ``(B, l0, *rest)`` of ``w2 phi^2 + w4 phi^4 - w0 phi_x
    sum_mu phi_{x - mu}``, the backward neighbours of row 0 along the first
    axis from ``halo[:, 0]``, in :func:`phi4_action_plain`'s order."""
    dims = tuple(range(1, cfgs.dim()))
    phi2 = cfgs * cfgs
    act = torch.sum(w2 * phi2 + w4 * phi2 * phi2, dim=dims)
    if w0 != 0.0:
        for mu in dims:
            act = act - w0 * torch.sum(cfgs * _back(cfgs, halo, mu),
                                       dim=dims)
    return act


def phi4_action_slab_grad_plain(cfgs, halo, g, w0, w2, w4):
    """Plain PyTorch version of the slab force times ``g`` ``(B,)``: the
    force on the slab's sites, the neighbours across its first and last
    rows from ``halo``, in :func:`phi4_action_grad_plain`'s order."""
    dv = (2.0 * w2) * cfgs + (4.0 * w4) * (cfgs * cfgs) * cfgs
    if w0 != 0.0:
        neigh = 0.0
        for mu in range(1, cfgs.dim()):
            neigh = (neigh + _back(cfgs, halo, mu)
                     + _fore(cfgs, halo, mu))
        dv = dv - w0 * neigh
    return dv * g.reshape((-1,) + (1,) * (cfgs.dim() - 1))


def _back(cfgs, halo, mu):
    """``phi_{x - mu}``: ``roll(cfgs, 1, mu)``, along axis 1 from the row
    before the slab."""
    if mu != 1:
        return torch.roll(cfgs, 1, mu)
    return torch.cat([halo[:, :1], cfgs[:, :-1]], 1)[:, :cfgs.shape[1]]


def _fore(cfgs, halo, mu):
    """``phi_{x + mu}``, along axis 1 from the row after the slab."""
    if mu != 1:
        return torch.roll(cfgs, -1, mu)
    return torch.cat([cfgs[:, 1:], halo[:, 1:]], 1)[:, :cfgs.shape[1]]


def _check_slab(name, cfgs, halo):
    if halo.shape != (cfgs.shape[0], 2, *cfgs.shape[2:]):
        raise ValueError(f"{name}: halo {tuple(halo.shape)} for the slab "
                         f"{tuple(cfgs.shape)}")
    if cfgs.device.type == "cpu" and halo.device.type == "cpu":
        return None
    lat = _check_cuda(name, cfgs)
    if halo.device != cfgs.device or halo.dtype != torch.float32 \
            or not halo.is_contiguous():
        raise ValueError(f"{name}: the halo must be a contiguous float32 "
                         "tensor on the slab's device")
    return lat


def _action_slab(cfgs, halo, w0, w2, w4):
    lat = _check_slab("phi4_action_slab", cfgs, halo)
    if lat is None:
        return phi4_action_slab_plain(cfgs, halo, w0, w2, w4)
    b = cfgs.shape[0]
    if not cfgs.numel():
        return cfgs.new_zeros(b)
    act = torch.empty(b, dtype=cfgs.dtype, device=cfgs.device)
    lib = _lib.library()
    w = (float(w0), float(w2), float(w4))
    with torch.cuda.device(cfgs.device):
        stream = torch.cuda.current_stream(cfgs.device).cuda_stream
        variant = slab_variant(cfgs.shape[1:], cfgs.data_ptr(),
                               halo.data_ptr())
        if variant == "tiled":
            _, samples = action_plan(cfgs.shape[1:])
            err = lib.phi4_action_slab_tiled_f32(
                cfgs.data_ptr(), halo.data_ptr(), act.data_ptr(), b,
                *lat[:2], samples, *w, stream)
        else:
            entry = (lib.phi4_action_slab_tiled_nd_f32
                     if variant == "tiled_nd" else lib.phi4_action_slab_f32)
            err = entry(cfgs.data_ptr(), halo.data_ptr(), act.data_ptr(), b,
                        cfgs.dim() - 1, *lat, *w, stream)
    _lib.check(err, "phi4_action_slab")
    phi4_action_slab.launches += 1
    phi4_action_slab.tiled_launches += variant != "general"
    return act


def phi4_action_slab_grad(cfgs, halo, g, w0, w2, w4):
    """``g[b] * dS_b/dcfgs`` on the slab's sites (``S`` the whole
    lattice's action): :func:`phi4_action_slab_grad_plain` for CPU
    tensors; CUDA tensors (float32, contiguous, 1-4 lattice dims) launch
    the kernel or raise."""
    if g.shape != cfgs.shape[:1]:
        raise ValueError(f"phi4_action_slab_grad: cotangent "
                         f"{tuple(g.shape)} for the slab "
                         f"{tuple(cfgs.shape)}")
    lat = _check_slab("phi4_action_slab_grad", cfgs, halo)
    if lat is None and g.device.type == "cpu":
        return phi4_action_slab_grad_plain(cfgs, halo, g, w0, w2, w4)
    if lat is None or g.device != cfgs.device \
            or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("phi4_action_slab_grad: the cotangent must be a "
                         "contiguous float32 tensor on the slab's device")
    grad = torch.empty_like(cfgs)
    if cfgs.numel():
        lib = _lib.library()
        ptrs = (cfgs.data_ptr(), halo.data_ptr(), g.data_ptr(),
                grad.data_ptr())
        b, w = cfgs.shape[0], (float(w0), float(w2), float(w4))
        variant = slab_variant(cfgs.shape[1:], ptrs[0], ptrs[1], ptrs[3])
        with torch.cuda.device(cfgs.device):
            stream = torch.cuda.current_stream(cfgs.device).cuda_stream
            if variant == "tiled":
                _, samples = action_plan(cfgs.shape[1:])
                err = lib.phi4_action_grad_slab_tiled_f32(
                    *ptrs, b, *lat[:2], samples, *w, stream)
            else:
                entry = (lib.phi4_action_grad_slab_tiled_nd_f32
                         if variant == "tiled_nd"
                         else lib.phi4_action_grad_slab_f32)
                err = entry(*ptrs, b, cfgs.dim() - 1, *lat, *w, stream)
        _lib.check(err, "phi4_action_slab_grad")
        phi4_action_slab_grad.launches += 1
        phi4_action_slab_grad.tiled_launches += variant != "general"
    return grad


class _Phi4ActionSlab(torch.autograd.Function):
    """The slab action with the slab force as its backward.  The halo goes
    in detached: the force on the slab's sites is the derivative of the
    whole lattice's action, the neighbour slabs' terms that read this
    slab's rows included, so the halo rows need no cotangent of their own.
    That is the gradient of the loss only where each space rank's cotangent
    of its partial action is the same, the cotangent of the whole action:
    ``space.totals``'s identity backward, with the loss computed alike on
    every rank from the totals, gives exactly that."""

    @staticmethod
    def forward(ctx, cfgs, halo, w0, w2, w4):
        ctx.save_for_backward(cfgs, halo)
        ctx.coef = (w0, w2, w4)
        return _action_slab(cfgs, halo, w0, w2, w4)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        cfgs, halo = ctx.saved_tensors
        return (phi4_action_slab_grad(cfgs, halo, g.contiguous(),
                                      *ctx.coef), None, None, None, None)


def phi4_action_slab(cfgs, halo, w0, w2, w4):
    """This slab's part of the per-sample phi^4 action (module docstring),
    differentiable in ``cfgs``: CPU tensors take
    :func:`phi4_action_slab_plain`, CUDA tensors (float32, contiguous,
    1-4 lattice dims) launch the kernel or raise; the gradient goes
    through :func:`phi4_action_slab_grad`."""
    return _Phi4ActionSlab.apply(cfgs, halo.detach(), w0, w2, w4)


class _Phi4Action(torch.autograd.Function):
    """The action with the force as its backward; the input is the only
    residual, as in the JAX package's ``_phi4_fwd``."""

    @staticmethod
    def forward(ctx, cfgs, w0, w2, w4):
        ctx.save_for_backward(cfgs)
        ctx.coef = (w0, w2, w4)
        return _action(cfgs, w0, w2, w4)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (cfgs,) = ctx.saved_tensors
        return (phi4_action_grad(cfgs, g.contiguous(), *ctx.coef), None,
                None, None)


def phi4_action(cfgs, w0, w2, w4):
    """Per-sample phi^4 action, differentiable in ``cfgs``.  CPU tensors
    take :func:`phi4_action_plain`; CUDA tensors (float32, contiguous, 1-4
    lattice dims) launch the kernel or raise.  The gradient goes through
    :func:`phi4_action_grad` on the same device."""
    return _Phi4Action.apply(cfgs, w0, w2, w4)


phi4_action.launches = 0
phi4_action.tiled_launches = 0
phi4_action_grad.launches = 0
phi4_action_grad.tiled_launches = 0
phi4_action_slab.launches = 0
phi4_action_slab.tiled_launches = 0
phi4_action_slab_grad.launches = 0
phi4_action_slab_grad.tiled_launches = 0
