r"""Monotone rational-quadratic splines.

Counterpart of ``normflow__tpu/ops/spline.py:46-273``: the rational-quadratic
map and the rational-linear (Pade 1/1) one, their parameter-free knot
derivatives, and the knot augmentations for extrapolation.
Knots live on the last axis; ``x`` has any shape ``S`` and the knot arrays
broadcast against ``S + (K,)`` (shared knots ``(K,)`` or per-site knots).
The segment is found by a comparison count and its parameters are read
with ``torch.gather``; the inverse uses the cancellation-free "citardauq"
root of the per-segment quadratic.
"""

from __future__ import annotations

import torch

__all__ = ["knot_coords", "searchsorted_last", "segment_gather", "rqs", "rls",
           "smooth_derivatives_rq", "smooth_derivatives_rl", "augment_knots"]


def knot_coords(w, lo, width):
    """Monotone knot coordinates from unconstrained weights: softmax ->
    cumsum -> prepend 0 -> affine map to ``[lo, lo + width]`` along the
    last axis.  The cumulative sum is a product with an upper-triangular
    matrix of ones: on the card PyTorch's scan over a short last axis of
    many rows (the U(1) coupling's 32,768 rows of 7 per batch) took more
    than half of the gauge flow's device time."""
    k = w.shape[-1]
    tri = torch.ones((k, k), dtype=w.dtype, device=w.device).triu_()
    c = torch.softmax(w, dim=-1) @ tri
    zero = torch.zeros((*w.shape[:-1], 1), dtype=w.dtype, device=w.device)
    return lo + width * torch.cat([zero, c], dim=-1)


def searchsorted_last(knots, x):
    """Segment index of ``x`` in sorted ``knots`` (last axis): the count of
    knots below ``x``, clipped to ``[1, K-1]``, minus one.  Returns
    integers in ``[0, K-2]``."""
    k = knots.shape[-1]
    idx = torch.sum(x.unsqueeze(-1) > knots, dim=-1)
    return torch.clamp(idx, 1, k - 1) - 1


def segment_gather(params, idx, offset: int, k: int):
    """``params[..., idx + offset]`` for segment indices ``idx`` of ``k - 1``
    segments (``ops/spline.py:70`` of the JAX package, which selects by a
    one-hot contraction to avoid a dynamic gather on the TPU; here a
    gather).  ``params`` broadcasts against ``idx.shape + (k,)``."""
    window = params[..., offset:offset + k - 1]
    window = window.expand(*idx.shape, k - 1)
    return torch.gather(window, -1, idx.unsqueeze(-1)).squeeze(-1)


def _gather_segment_params(x, kx, ky, kd, lookup):
    shape = (*x.shape, kx.shape[-1])
    idx = searchsorted_last(lookup.expand(shape), x).unsqueeze(-1)

    def g(p, off):
        return torch.gather(p.expand(shape), -1, idx + off).squeeze(-1)

    return g(kx, 0), g(kx, 1), g(ky, 0), g(ky, 1), g(kd, 0), g(kd, 1)


def _rq_grad(theta, m, d0, d1):
    denom = m + (d1 + d0 - 2 * m) * theta * (1 - theta)
    num = d0 + 2 * (m - d0) * theta + (d1 + d0 - 2 * m) * theta**2
    return m**2 * num / denom**2


def rqs(x, kx, ky, kd, *, inverse: bool = False):
    """Rational-quadratic spline map ``y(x)`` or its inverse.

    Returns ``(out, grad)`` where ``grad`` is the derivative of the applied
    map (``dy/dx`` forward, ``dx/dy`` inverse)."""
    lookup = ky if inverse else kx
    x0, x1, y0, y1, d0, d1 = _gather_segment_params(x, kx, ky, kd, lookup)
    m = (y1 - y0) / (x1 - x0)

    if not inverse:
        theta = (x - x0) / (x1 - x0)
        denom = m + (d1 + d0 - 2 * m) * theta * (1 - theta)
        y = y0 + (y1 - y0) * theta * (m * theta + d0 * (1 - theta)) / denom
        return y, _rq_grad(theta, m, d0, d1)

    # Solve a2*theta^2 + a1*theta + a0 = 0 with the stable root choice:
    #   a1 <= 0:  theta = a0 / q,  q = (-a1 + delta)/2
    #   a1 >  0:  theta = q / a2,  q = -(a1 + delta)/2
    eta = (x - y0) / (y1 - y0)
    a2 = (2 * m - d1 - d0) * eta + d0 - m
    a1 = -a2 - m
    a0 = m * eta
    delta = torch.sqrt(torch.clamp(a1 * a1 - 4 * a0 * a2, min=0.0))
    neg_branch = a1 <= 0
    q_minus = 0.5 * (-a1 + delta)
    q_plus = -0.5 * (a1 + delta)
    tiny = torch.finfo(x.dtype).tiny
    one = torch.ones((), dtype=x.dtype, device=x.device)

    def safe(d):
        return torch.where(torch.abs(d) < tiny, one, d)

    theta = torch.where(
        neg_branch,
        a0 / safe(torch.where(neg_branch, q_minus, one)),
        q_plus / safe(torch.where(neg_branch, one, a2)),
    )
    xout = x0 + (x1 - x0) * theta
    return xout, 1.0 / _rq_grad(theta, m, d0, d1)


def rls(x, kx, ky, kd, *, inverse: bool = False):
    """Monotone rational-linear (Pade 1/1) spline map or its inverse; only
    each segment's left derivative ``d0`` is used.  Returns ``(out, grad)``
    as :func:`rqs` does."""
    lookup = ky if inverse else kx
    x0, x1, y0, y1, d0, _ = _gather_segment_params(x, kx, ky, kd, lookup)
    m = (y1 - y0) / (x1 - x0)

    def grad_of(theta):
        return m**2 * d0 / (m + (d0 - m) * theta) ** 2

    if not inverse:
        theta = (x - x0) / (x1 - x0)
        y = y0 + (y1 - y0) * d0 * theta / (m + (d0 - m) * theta)
        return y, grad_of(theta)
    eta = (x - y0) / (y1 - y0)
    theta = -eta * m / (eta * (d0 - m) - d0)
    return x0 + (x1 - x0) * theta, 1.0 / grad_of(theta)


def smooth_derivatives_rq(kx, ky):
    """Knot derivatives without parameters: the mean of the adjacent
    segment slopes inside, the adjacent slope at the two ends."""
    m = (ky[..., 1:] - ky[..., :-1]) / (kx[..., 1:] - kx[..., :-1])
    inner = 0.5 * (m[..., 1:] + m[..., :-1])
    return torch.cat([m[..., :1], inner, m[..., -1:]], dim=-1)


def smooth_derivatives_rl(kx, ky):
    """Knot derivatives for the rational-linear spline: ``d_0 = 1`` and
    ``d_{k+1} = m_k^2 / d_k``, which makes every interior derivative
    continuous."""
    m = (ky[..., 1:] - ky[..., :-1]) / (kx[..., 1:] - kx[..., :-1])
    d = torch.ones_like(m[..., :1])
    ds = [d]
    for i in range(kx.shape[-1] - 1):
        d = m[..., i:i + 1] ** 2 / d
        ds.append(d)
    return torch.cat(ds, dim=-1)


def _check_periodic_edge(edge):
    """'periodic' needs a zero derivative at the boundary knot.  The check
    reads the device, so it is left out while a CUDA graph is captured."""
    if edge.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    if not bool(torch.all(torch.abs(edge) <= 1e-8)):
        raise ValueError("periodic knot augmentation requires a zero "
                         "derivative at the boundary knot")


def augment_knots(kx, ky, kd, *, left=None, right=None):
    """Augment knots for extrapolation, in two passes: ``'linear'`` sides
    get one knot continuing the boundary derivative first; the reflections
    then act on the linearly augmented arrays: ``'anti'`` (or
    ``'anti-periodic'``) an odd mirror of all knots about the boundary
    knot, ``'periodic'`` an even one, which needs a zero derivative
    there."""
    for mode in (left, right):
        if mode not in (None, "linear", "anti", "anti-periodic", "periodic"):
            raise ValueError(f"unknown knot augmentation {mode!r}")
    kx, ky, kd = torch.broadcast_tensors(kx, ky, kd)

    def cat(parts):
        return torch.cat([p for p in parts if p is not None], dim=-1)

    # Pass 1: linear patches.
    lparts = rparts = None
    if left == "linear":
        lparts = (kx[..., :1] - 1, ky[..., :1] - kd[..., :1], kd[..., :1])
    if right == "linear":
        rparts = (kx[..., -1:] + 1, ky[..., -1:] + kd[..., -1:], kd[..., -1:])
    if lparts is not None or rparts is not None:
        kx = cat([lparts and lparts[0], kx, rparts and rparts[0]])
        ky = cat([lparts and lparts[1], ky, rparts and rparts[1]])
        kd = cat([lparts and lparts[2], kd, rparts and rparts[2]])

    # Pass 2: reflections of the (possibly linear-augmented) arrays.
    def reflect(mode, is_left):
        anti = mode in ("anti", "anti-periodic")
        if not (anti or mode == "periodic"):
            return None
        if not anti:
            _check_periodic_edge(kd[..., :1] if is_left else kd[..., -1:])
        flip = lambda a: torch.flip(a, dims=(-1,))  # noqa: E731
        if is_left:
            xs, ys, ds = flip(kx[..., 1:]), flip(ky[..., 1:]), flip(kd[..., 1:])
            x_edge, y_edge = kx[..., :1], ky[..., :1]
        else:
            xs, ys, ds = (flip(kx[..., :-1]), flip(ky[..., :-1]),
                          flip(kd[..., :-1]))
            x_edge, y_edge = kx[..., -1:], ky[..., -1:]
        if anti:
            return 2 * x_edge - xs, 2 * y_edge - ys, ds
        return 2 * x_edge - xs, ys, -ds

    lref = reflect(left, True)
    rref = reflect(right, False)
    if lref is not None or rref is not None:
        kx = cat([lref and lref[0], kx, rref and rref[0]])
        ky = cat([lref and lref[1], ky, rref and rref[1]])
        kd = cat([lref and lref[2], kd, rref and rref[2]])
    return kx, ky, kd
