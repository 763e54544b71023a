r"""Fused RQ-spline coupling transform: knots + transform + log-gradient.

Counterpart of ``normflow__tpu/ops/kernels/spline_coupling.py``
(``rqs_transform_fused``, Pallas kernel ``_rqs_kernel``).  Given the
conditioner output ``out`` with ``3m - 2`` channels per site, shaped
``(B, 3m-2, *lat)`` as ``F.conv2d`` emits it, and the active field ``x``
``(B, *lat)``: build the per-site monotone knots (softmax + cumsum
coordinates in the ``xlim``/``ylim`` box, ``softplus_log2`` derivatives,
optional linear boundary knots), apply the rational-quadratic map or its
inverse, and return ``(y, log|dy/dx|)`` shaped like ``x``.

:func:`rqs_coupling` is the wrapper: the plain PyTorch version
(:func:`rqs_coupling_plain`) for a CPU tensor, the CUDA kernel
(``csrc/rqs_coupling.cu``) for a CUDA tensor.  It is differentiable: its
backward, :func:`rqs_coupling_bwd`, is the counterpart of the Pallas kernel
``_rqs_bwd_kernel``, a hand-derived VJP that recomputes the forward per
site (``csrc/rqs_coupling_bwd.cu``, plain version
:func:`rqs_coupling_vjp_plain`).  Each direction has four hand-written
kernels, which return the same bits.  :func:`coupling_layout` picks the
layout: ``out`` NCHW-contiguous, or channels-last (each site's ``3m - 2``
values one contiguous run, the NHWC output of a conv fed channels-last
data: the ``pallas_reg`` route, the Pallas kernels'
``channels_last=True``), and refuses other strides; the VJP's ``outbar``
comes back in ``out``'s layout.  :func:`coupling_variant` picks, by shape
and alignment, the layout's tiled kernel, whose persistent blocks stage
tiles of sites through a ring of shared memory with bulk copies (NCHW: the
rows of each sample's channels; channels-last: flat tiles of the batch's
one run of sites), or its per-site kernel for the shapes the bulk copies
cannot take.
``rqs_coupling.tiled_launches`` and ``rqs_coupling_bwd.tiled_launches``
count the launches of a tiled kernel of either layout among each
wrapper's ``launches``, ``.cl_launches`` those of a channels-last kernel,
tiled or per site.  The counts
grow where the wrapper launches its kernel from the host: under a CUDA
graph (``utils.graphs``) that is the warm-up and the capture, once per
capture, not once per replay; a replay's launches are counted by kernel
name in the profiler (``tools/kernel_times.device_launches``).  A launch
goes to PyTorch's current stream, the capture stream while a graph is
captured, and the variant is chosen from the addresses the capture sees.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from ..lattice import channels_last
from . import _lib

__all__ = ["rqs_coupling", "rqs_coupling_plain", "rqs_coupling_bwd",
           "rqs_coupling_vjp_plain", "SUPPORTED_KNOTS", "coupling_variant",
           "coupling_layout"]

SUPPORTED_KNOTS = (4, 6, 8, 12)  # template instances of the CUDA kernel
_EXTRAP = (None, "linear")
_LN2 = math.log(2.0)


def _softmax_parts(ws):
    """``(e_i, 1 / sum e)`` with ``e_i = exp(w_i - max w)`` of the weights
    ``ws`` (a list of per-channel tensors)."""
    mx = ws[0]
    for w in ws[1:]:
        mx = torch.maximum(mx, w)
    es = [torch.exp(w - mx) for w in ws]
    tot = es[0]
    for e in es[1:]:
        tot = tot + e
    return es, 1.0 / tot


def _coords(ws, lo, width, zero):
    """Softmax + cumsum knot coordinates ``lo + width * c_j``, ``c_0 = 0``,
    of the weights ``ws``."""
    es, inv = _softmax_parts(ws)
    knots, cum = [zero], zero
    for e in es:
        cum = cum + e
        knots.append(cum * inv)
    return [lo + width * c for c in knots]


def _knots(x, out, xlim, ylim, left, right):
    """The K = m + (left linear) + (right linear) knots of every site, as
    lists of tensors shaped like ``x``."""
    # imported here: the models package imports this module
    from ...models.elementwise import softplus_log2

    m = (out.shape[1] + 2) // 3
    ch = out.unbind(1)
    zero = torch.zeros_like(x)
    kx = _coords(ch[:m - 1], xlim[0], xlim[1] - xlim[0], zero)
    ky = _coords(ch[m - 1:2 * (m - 1)], ylim[0], ylim[1] - ylim[0], zero)
    kd = [softplus_log2(w) for w in ch[2 * (m - 1):]]
    if left == "linear":
        kx = [kx[0] - 1.0] + kx
        ky = [ky[0] - kd[0]] + ky
        kd = [kd[0]] + kd
    if right == "linear":
        kx = kx + [kx[-1] + 1.0]
        ky = ky + [ky[-1] + kd[-1]]
        kd = kd + [kd[-1]]
    return kx, ky, kd


def _segment(x, kx, ky, kd, inverse):
    """``idx = clip(#{knots < x}, 1, K-1) - 1`` (searched among the y knots
    for the inverse) and the segment's ``x0, x1, y0, y1, d0, d1``, gathered
    by a select chain."""
    k = len(kx)
    zero = torch.zeros_like(x)
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
    return idx, x0, x1, y0, y1, d0, d1


def _inverse_theta(x, y0, dy, mm, spread, d0):
    """The inverse map's theta, the root of the segment's quadratic in the
    "citardauq" form.  Each division is guarded on both sides of the
    ``where``, so that autograd through this plain version stays finite."""
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

    return torch.where(
        neg, a0 / safe(torch.where(neg, 0.5 * (-a1 + delta), one)),
        -0.5 * (a1 + delta) / safe(torch.where(neg, one, a2)))


def rqs_coupling_plain(x, out, *, xlim, ylim, left=None, right=None,
                       inverse=False):
    """Plain PyTorch version of the kernel, in the kernel's own order of
    operations (that of the Pallas body ``_rqs_core``): per-channel
    tensors, the knot axis unrolled, the segment picked by a select chain.
    ``out`` is ``(B, 3m-2, *lat)``."""
    kx, ky, kd = _knots(x, out, xlim, ylim, left, right)
    _, x0, x1, y0, y1, d0, d1 = _segment(x, kx, ky, kd, inverse)
    dx = x1 - x0
    dy = y1 - y0
    mm = dy / dx
    spread = d1 + d0 - 2 * mm
    if not inverse:
        theta = (x - x0) / dx
        denom = mm + spread * theta * (1 - theta)
        y = y0 + dy * theta * (mm * theta + d0 * (1 - theta)) / denom
    else:
        theta = _inverse_theta(x, y0, dy, mm, spread, d0)
        y = x0 + dx * theta
    denom = mm + spread * theta * (1 - theta)
    num = d0 + 2 * (mm - d0) * theta + spread * theta * theta
    logg = torch.log(mm * mm * num / (denom * denom))
    return y, -logg if inverse else logg


class _Adj:
    """Adjoints of the rational-quadratic map's parameters at fixed theta
    (``csrc/rqs_coupling_bwd.cu``'s ``Adj``)."""

    def __init__(self):
        self.mm = self.sp = self.d0 = self.dy = self.y0 = self.th = 0.0

    def lg(self, t, mm, sp, d0, lgb):
        """Adds ``lgb * d lg`` for ``lg = log(mm^2 num / denom^2)``."""
        omt = 1 - t
        denom = mm + sp * t * omt
        num = d0 + 2 * (mm - d0) * t + sp * t * t
        num_b = lgb / num
        den_b = -2 * lgb / denom
        self.mm = self.mm + (2 * lgb / mm + num_b * 2 * t + den_b)
        self.d0 = self.d0 + num_b * (1 - 2 * t)
        self.sp = self.sp + (num_b * t * t + den_b * t * omt)
        self.th = self.th + (num_b * (2 * (mm - d0) + 2 * sp * t)
                             + den_b * sp * (1 - 2 * t))

    def f(self, t, mm, sp, d0, dy, fb):
        """Adds ``fb * dF`` for ``F = y0 + dy t q / denom``,
        ``q = mm t + d0 (1 - t)``."""
        omt = 1 - t
        denom = mm + sp * t * omt
        q = mm * t + d0 * omt
        r = t * q / denom
        tb = fb * dy / denom
        den_b = -fb * dy * r / denom
        self.y0 = self.y0 + fb
        self.dy = self.dy + fb * r
        self.mm = self.mm + (tb * t * t + den_b)
        self.d0 = self.d0 + tb * t * omt
        self.sp = self.sp + den_b * t * omt
        self.th = self.th + (tb * (q + t * (mm - d0))
                             + den_b * sp * (1 - 2 * t))


def _knot_adj(j, idx, b0, b1, m, left, right):
    """Adjoint of original knot ``j`` from the adjoints of the segment's
    end points; a linear boundary knot's adjoint lands on the knot it
    copies."""
    lo = int(left == "linear")
    k = m + lo + int(right == "linear")
    zero = torch.zeros_like(b0)
    v = torch.where(idx == j + lo, b0, zero) \
        + torch.where(idx == j + lo - 1, b1, zero)
    if left == "linear" and j == 0:
        v = v + torch.where(idx == 0, b0, zero)
    if right == "linear" and j == m - 1:
        v = v + torch.where(idx == k - 2, b1, zero)
    return v


def _coords_adjoint(ws, width, kbar):
    """Transpose ``lo + width * c_j`` through the softmax + cumsum:
    ``wbar_i = s_i (sum_{j>i} cbar_j - sum_j cbar_j c_j)``, ``s_i = e_i /
    tot`` (the max shift's gradient, zero in exact arithmetic, is
    dropped).  ``kbar(j)`` gives knot ``j``'s adjoint."""
    es, inv = _softmax_parts(ws)
    cb, cum, acc = [], 0.0, 0.0
    for j, e in enumerate(es):
        cum = cum + e
        cb.append(width * kbar(j + 1))
        acc = acc + cb[j] * (cum * inv)
    wbar, suffix = [None] * len(es), 0.0
    for i in reversed(range(len(es))):
        suffix = suffix + cb[i]
        wbar[i] = (es[i] * inv) * (suffix - acc)
    return wbar


def rqs_coupling_vjp_plain(x, out, ybar, loggbar, *, xlim, ylim, left=None,
                           right=None, inverse=False):
    """Plain PyTorch version of the backward kernel: the hand-derived VJP
    of :func:`rqs_coupling_plain`, ``(xbar, outbar)`` with ``outbar``
    shaped like ``out``, ``(B, 3m-2, *lat)``, and channels-last where
    ``out`` is (:func:`coupling_layout`), in the formulas and order of
    ``csrc/rqs_coupling_bwd.cu``.  It recomputes the forward per site; the
    inverse's theta is differentiated in the implicit-function form."""
    m = (out.shape[1] + 2) // 3
    kx, ky, kd = _knots(x, out, xlim, ylim, left, right)
    k = len(kx)
    idx, x0, x1, y0, y1, d0, d1 = _segment(x, kx, ky, kd, inverse)
    del kx, ky, kd
    dx = x1 - x0
    dy = y1 - y0
    mm = dy / dx
    spread = d1 + d0 - 2 * mm
    a = _Adj()
    if not inverse:
        theta = (x - x0) / dx
        a.lg(theta, mm, spread, d0, loggbar)
        a.f(theta, mm, spread, d0, dy, ybar)
        xbar = a.th / dx
        x0b = -xbar
        dxb = -xbar * theta
    else:
        theta = _inverse_theta(x, y0, dy, mm, spread, d0)
        a.lg(theta, mm, spread, d0, -loggbar)
        thb = a.th + ybar * dx
        x0b = ybar
        dxb = ybar * theta
        omt = 1 - theta
        denom = mm + spread * theta * omt
        num = d0 + 2 * (mm - d0) * theta + spread * theta * theta
        xbar = thb / (mm * mm * num / (denom * denom) * dx)
        a.f(theta, mm, spread, d0, dy, -xbar)

    d1b = a.sp
    d0b = a.d0 + a.sp
    mmb = a.mm - 2 * a.sp
    dyb = a.dy + mmb / dx
    dxb = dxb + -mmb * mm / dx
    x1b = dxb
    x0b = x0b + -dxb
    y1b = dyb
    y0b = a.y0 - dyb

    ch = out.unbind(1)
    zero = torch.zeros_like(x)

    def kbar(b0, b1):
        return lambda j: _knot_adj(j, idx, b0, b1, m, left, right)

    wx = _coords_adjoint(ch[:m - 1], xlim[1] - xlim[0], kbar(x0b, x1b))
    wy = _coords_adjoint(ch[m - 1:2 * (m - 1)], ylim[1] - ylim[0],
                         kbar(y0b, y1b))
    wd = []
    for j, w in enumerate(ch[2 * (m - 1):]):
        kdb = _knot_adj(j, idx, d0b, d1b, m, left, right)
        if left == "linear" and j == 0:
            kdb = kdb + torch.where(idx == 0, -y0b, zero)
        if right == "linear" and j == m - 1:
            kdb = kdb + torch.where(idx == k - 2, y1b, zero)
        wd.append(kdb * (1.0 / (1.0 + torch.exp(-(w * _LN2)))))
    if _layout(out) == "channels_last":
        return xbar, torch.stack(wx + wy + wd, dim=-1).movedim(-1, 1)
    return xbar, torch.stack(wx + wy + wd, dim=1)


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


def _layout(out):
    """``"nchw"``, ``"channels_last"`` or ``None``
    (:func:`coupling_layout`)."""
    if out.is_contiguous():
        return "nchw"
    if channels_last(out):
        return "channels_last"
    return None


def coupling_layout(out):
    """Which kernels of either direction take the conditioner output
    ``out``, shaped ``(B, 3m-2, *lat)``: ``"nchw"`` where it is contiguous,
    ``"channels_last"`` where each site's ``3m - 2`` values are one
    contiguous run and the sites follow in order
    (``ops.lattice.channels_last``, any lattice rank: a conv's output on
    channels-last data); NCHW where both hold (one site per sample).  Raises ``ValueError`` for any other strides: the wrappers
    copy nothing into a layout."""
    layout = _layout(out)
    if layout is None:
        raise ValueError(f"conditioner output of shape {tuple(out.shape)} "
                         f"and strides {out.stride()}: the kernels take it "
                         "NCHW-contiguous or channels-last")
    return layout


def _check_cuda(name, x, out, *site_tensors):
    """Raise unless a kernel takes these tensors; returns ``m`` and the
    layout of ``out`` (:func:`coupling_layout`)."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (out, *site_tensors)):
        raise ValueError(f"{name}: no kernel for tensors on {x.device} / "
                         f"{out.device}")
    if any(t.dtype != torch.float32 for t in (x, out, *site_tensors)):
        raise TypeError(f"{name}: the CUDA kernel takes float32")
    if not all(t.is_contiguous() for t in (x, *site_tensors)):
        raise ValueError(f"{name}: inputs must be contiguous")
    layout = coupling_layout(out)
    if any(t.shape != x.shape for t in site_tensors):
        raise ValueError(f"{name}: cotangents must be shaped like x")
    m = (out.shape[1] + 2) // 3
    if m not in SUPPORTED_KNOTS:
        raise ValueError(f"{name}: m={m} knots, kernel built for "
                         f"{SUPPORTED_KNOTS}")
    return m, layout


def _limits(xlim, ylim, left, right, inverse):
    return (float(xlim[0]), float(xlim[1] - xlim[0]), float(ylim[0]),
            float(ylim[1] - ylim[0]), int(left == "linear"),
            int(right == "linear"), int(inverse))


def _forward(x, out, cfg):
    if x.device.type == "cpu" and out.device.type == "cpu":
        return rqs_coupling_plain(x, out, **cfg)
    m, layout = _check_cuda("rqs_coupling", x, out)
    b, s = x.shape[0], math.prod(x.shape[1:])
    y = torch.empty_like(x)
    logg = torch.empty_like(x)
    if b * s:
        lib = _lib.library()
        ptrs = [t.data_ptr() for t in (x, out, y, logg)]
        cl = layout == "channels_last"
        tiled = coupling_variant(s, ptrs, layout, b) == "tiled"
        launch = (lib.rqs_coupling_cl_tiled_f32 if cl and tiled else
                  lib.rqs_coupling_cl_f32 if cl else
                  lib.rqs_coupling_tiled_f32 if tiled
                  else lib.rqs_coupling_f32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = launch(*ptrs, b, s, m, *_limits(**cfg), stream)
        _lib.check(err, "rqs_coupling")
        rqs_coupling.launches += 1
        rqs_coupling.tiled_launches += tiled
        rqs_coupling.cl_launches += cl
    return y, logg


def coupling_variant(s, ptrs, layout="nchw", b=1):
    """Which kernel of either direction takes ``s`` sites per sample of
    ``b`` samples of an ``out`` in ``layout`` (:func:`coupling_layout`)
    with tensors at the addresses ``ptrs``: ``"tiled"`` where the bulk
    copies can move every tile's runs (16-byte aligned, a multiple of 16
    bytes long: every address a multiple of 16, and ``s % 4 == 0`` for
    NCHW, whose tiles cut each sample's rows, ``b * s % 4 == 0`` for
    channels-last, whose tiles cut the batch's one run of sites),
    ``"sites"`` otherwise."""
    sites = b * s if layout == "channels_last" else s
    return ("tiled" if sites % 4 == 0 and all(p % 16 == 0 for p in ptrs)
            else "sites")


def rqs_coupling_bwd(x, out, ybar, loggbar, *, xlim, ylim, left=None,
                     right=None, inverse=False):
    """``(xbar, outbar)``, the VJP of :func:`rqs_coupling` at ``(x, out)``
    for the cotangents ``(ybar, loggbar)``, ``outbar`` in ``out``'s
    layout.  CPU tensors take :func:`rqs_coupling_vjp_plain`; CUDA tensors
    (float32, contiguous but ``out``, which may be channels-last instead
    (:func:`coupling_layout`), ``m`` in :data:`SUPPORTED_KNOTS`) launch the
    backward kernel (``csrc/rqs_coupling_bwd.cu``) or raise."""
    _check(x, out, left, right)
    cfg = dict(xlim=xlim, ylim=ylim, left=left, right=right,
               inverse=inverse)
    if all(t.device.type == "cpu" for t in (x, out, ybar, loggbar)):
        if ybar.shape != x.shape or loggbar.shape != x.shape:
            raise ValueError("rqs_coupling_bwd: cotangents must be shaped "
                             "like x")
        return rqs_coupling_vjp_plain(x, out, ybar, loggbar, **cfg)
    m, layout = _check_cuda("rqs_coupling_bwd", x, out, ybar, loggbar)
    b, s = x.shape[0], math.prod(x.shape[1:])
    xbar = torch.empty_like(x)
    outbar = torch.empty_like(out)  # in out's layout
    if b * s:
        lib = _lib.library()
        ptrs = [t.data_ptr() for t in (x, out, ybar, loggbar, xbar, outbar)]
        cl = layout == "channels_last"
        tiled = coupling_variant(s, ptrs, layout, b) == "tiled"
        launch = (lib.rqs_coupling_bwd_cl_tiled_f32 if cl and tiled else
                  lib.rqs_coupling_bwd_cl_f32 if cl else
                  lib.rqs_coupling_bwd_tiled_f32 if tiled
                  else lib.rqs_coupling_bwd_f32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = launch(*ptrs, b, s, m, *_limits(**cfg), stream)
        _lib.check(err, "rqs_coupling_bwd")
        rqs_coupling_bwd.launches += 1
        rqs_coupling_bwd.tiled_launches += tiled
        rqs_coupling_bwd.cl_launches += cl
    return xbar, outbar


class _RQSCoupling(torch.autograd.Function):
    """The coupling transform with the backward kernel as its VJP; the
    inputs ``(x, out)`` are the only residuals, as in the JAX package's
    ``_make_op``."""

    @staticmethod
    def forward(ctx, x, out, cfg):
        ctx.save_for_backward(x, out)
        ctx.cfg = cfg
        return _forward(x, out, cfg)

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar, loggbar):
        x, out = ctx.saved_tensors
        ybar = torch.zeros_like(x) if ybar is None else ybar.contiguous()
        loggbar = (torch.zeros_like(x) if loggbar is None
                   else loggbar.contiguous())
        xbar, outbar = rqs_coupling_bwd(x, out, ybar, loggbar, **ctx.cfg)
        return (xbar if ctx.needs_input_grad[0] else None,
                outbar if ctx.needs_input_grad[1] else None, None)


def rqs_coupling(x, out, *, xlim, ylim, left=None, right=None,
                 inverse=False):
    """``(y, logg)`` of the per-site RQ spline that ``out`` parameterises,
    differentiable in ``x`` and ``out``.

    CPU tensors take :func:`rqs_coupling_plain`; CUDA tensors launch a
    kernel (float32, ``x`` contiguous, ``out`` NCHW-contiguous or
    channels-last (:func:`coupling_layout`), ``m`` in
    :data:`SUPPORTED_KNOTS`) or raise.  The gradient goes through
    :func:`rqs_coupling_bwd` on the same device."""
    _check(x, out, left, right)
    return _RQSCoupling.apply(x, out, dict(xlim=xlim, ylim=ylim, left=left,
                                           right=right, inverse=inverse))


rqs_coupling.launches = 0
rqs_coupling.tiled_launches = 0
rqs_coupling.cl_launches = 0
rqs_coupling_bwd.launches = 0
rqs_coupling_bwd.tiled_launches = 0
rqs_coupling_bwd.cl_launches = 0
