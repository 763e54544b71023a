r"""Fused RQ-spline coupling transform: knots + transform + log-gradient.

Counterpart of ``normflow__tpu/ops/kernels/spline_coupling.py``
(``rqs_transform_fused``, Pallas kernel ``_rqs_kernel``).  Given the
conditioner output ``out`` with ``3m - 2`` channels per site, laid out
``(B, 3m-2, *lat)`` as ``F.conv2d`` emits it, and the active field ``x``
``(B, *lat)``: build the per-site monotone knots (softmax + cumsum
coordinates in the ``xlim``/``ylim`` box, ``softplus_log2`` derivatives,
optional linear boundary knots), apply the rational-quadratic map or its
inverse, and return ``(y, log|dy/dx|)`` shaped like ``x``.

:func:`rqs_coupling` is the wrapper: the plain PyTorch version
(:func:`rqs_coupling_plain`) for a CPU tensor, the CUDA kernel
(``csrc/rqs_coupling.cu``) for a CUDA tensor.
"""

from __future__ import annotations

import math

import torch

from ...models.elementwise import softplus_log2
from . import _lib

__all__ = ["rqs_coupling", "rqs_coupling_plain", "SUPPORTED_KNOTS"]

SUPPORTED_KNOTS = (4, 6, 8, 12)  # template instances of the CUDA kernel
_EXTRAP = (None, "linear")


def rqs_coupling_plain(x, out, *, xlim, ylim, left=None, right=None,
                       inverse=False):
    """Plain PyTorch version of the kernel, in the kernel's own order of
    operations (that of the Pallas body ``_rqs_core``): per-channel
    tensors, the knot axis unrolled, the segment picked by a select chain.
    ``out`` is ``(B, 3m-2, *lat)``."""
    m = (out.shape[1] + 2) // 3
    ch = out.unbind(1)
    zero = torch.zeros_like(x)

    def coords(ws, lo, width):
        mx = ws[0]
        for w in ws[1:]:
            mx = torch.maximum(mx, w)
        es = [torch.exp(w - mx) for w in ws]
        tot = es[0]
        for e in es[1:]:
            tot = tot + e
        inv = 1.0 / tot
        knots, cum = [zero], zero
        for e in es:
            cum = cum + e
            knots.append(cum * inv)
        return [lo + width * c for c in knots]

    kx = coords(ch[:m - 1], xlim[0], xlim[1] - xlim[0])
    ky = coords(ch[m - 1:2 * (m - 1)], ylim[0], ylim[1] - ylim[0])
    kd = [softplus_log2(w) for w in ch[2 * (m - 1):]]
    if left == "linear":
        kx = [kx[0] - 1.0] + kx
        ky = [ky[0] - kd[0]] + ky
        kd = [kd[0]] + kd
    if right == "linear":
        kx = kx + [kx[-1] + 1.0]
        ky = ky + [ky[-1] + kd[-1]]
        kd = kd + [kd[-1]]

    k = len(kx)
    idx = zero.to(torch.int32)
    for lk in (ky if inverse else kx):
        idx = idx + (x > lk).to(torch.int32)
    idx = torch.clamp(idx, 1, k - 1) - 1
    x0 = x1 = y0 = y1 = d0 = d1 = zero
    for s in range(k - 1):
        sel = idx == s
        x0 = torch.where(sel, kx[s], x0)
        x1 = torch.where(sel, kx[s + 1], x1)
        y0 = torch.where(sel, ky[s], y0)
        y1 = torch.where(sel, ky[s + 1], y1)
        d0 = torch.where(sel, kd[s], d0)
        d1 = torch.where(sel, kd[s + 1], d1)

    dx = x1 - x0
    dy = y1 - y0
    mm = dy / dx
    spread = d1 + d0 - 2 * mm
    if not inverse:
        theta = (x - x0) / dx
        denom = mm + spread * theta * (1 - theta)
        y = y0 + dy * theta * (mm * theta + d0 * (1 - theta)) / denom
    else:
        eta = (x - y0) / dy
        a2 = -spread * eta + d0 - mm
        a1 = -a2 - mm
        a0 = mm * eta
        delta = torch.sqrt(torch.clamp(a1 * a1 - 4 * a0 * a2, min=0.0))
        neg = a1 <= 0
        one = torch.ones_like(x)
        tiny = torch.finfo(x.dtype).tiny

        def safe(d):
            return torch.where(torch.abs(d) < tiny, one, d)

        theta = torch.where(neg, a0 / safe(0.5 * (-a1 + delta)),
                            -0.5 * (a1 + delta) / safe(a2))
        y = x0 + dx * theta
    denom = mm + spread * theta * (1 - theta)
    num = d0 + 2 * (mm - d0) * theta + spread * theta * theta
    logg = torch.log(mm * mm * num / (denom * denom))
    return y, -logg if inverse else logg


def _check(x, out, left, right):
    if left not in _EXTRAP or right not in _EXTRAP:
        raise ValueError(f"extrapolation must be None or 'linear', got "
                         f"{left!r}, {right!r}")
    k3 = out.shape[1] if out.dim() >= 2 else 0
    if out.dim() != x.dim() + 1 or out.shape[0] != x.shape[0] \
            or out.shape[2:] != x.shape[1:] or (k3 + 2) % 3:
        raise ValueError(f"shapes x {tuple(x.shape)} / out "
                         f"{tuple(out.shape)}: want (B, *lat) and "
                         "(B, 3m-2, *lat)")


def rqs_coupling(x, out, *, xlim, ylim, left=None, right=None,
                 inverse=False):
    """``(y, logg)`` of the per-site RQ spline that ``out`` parameterises.

    CPU tensors take :func:`rqs_coupling_plain`; CUDA tensors launch the
    kernel (float32, contiguous, ``m`` in :data:`SUPPORTED_KNOTS`) or raise.
    The kernel has no backward yet, so a CUDA call that needs a gradient
    raises."""
    _check(x, out, left, right)
    if x.device.type == "cpu" and out.device.type == "cpu":
        return rqs_coupling_plain(x, out, xlim=xlim, ylim=ylim, left=left,
                                  right=right, inverse=inverse)
    if x.device.type != "cuda" or out.device != x.device:
        raise ValueError(f"rqs_coupling: no kernel for tensors on "
                         f"{x.device} / {out.device}")
    if x.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("rqs_coupling: the CUDA kernel takes float32")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("rqs_coupling: inputs must be contiguous")
    m = (out.shape[1] + 2) // 3
    if m not in SUPPORTED_KNOTS:
        raise ValueError(f"rqs_coupling: m={m} knots, kernel built for "
                         f"{SUPPORTED_KNOTS}")
    if torch.is_grad_enabled() and (x.requires_grad or out.requires_grad):
        raise NotImplementedError(
            "rqs_coupling: the backward kernel is not ported yet")
    b, s = x.shape[0], math.prod(x.shape[1:])
    y = torch.empty_like(x)
    logg = torch.empty_like(x)
    if b * s:
        lib = _lib.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.rqs_coupling_f32(
                x.data_ptr(), out.data_ptr(), y.data_ptr(), logg.data_ptr(),
                b, s, m, float(xlim[0]), float(xlim[1] - xlim[0]),
                float(ylim[0]), float(ylim[1] - ylim[0]),
                int(left == "linear"), int(right == "linear"), int(inverse),
                stream)
        _lib.check(err, "rqs_coupling")
        rqs_coupling.launches += 1
    return y, logg


rqs_coupling.launches = 0
