"""The port's backward kernels on the card, against their plain versions.

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``,
skip without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_grad.py

They cover every knot count the backward kernel is built for, one-sided
extrapolation, a ragged number of sites, both backward variants (the
tiled kernel with a ragged last tile, B = 1, and the per-site kernel for
S % 4 != 0 or an input off 16 bytes) bit for bit against each other, the
force kernel's lattice ranks and both of its variants (the tiled kernel
at the training shape and at B = 3, bit for bit against the general
kernel),
the wrappers' refusals, autograd through the CUDA wrappers, and one
training step of an 8x8 flagship on the card against a CPU copy.
Tolerances: element by element, ``|d| <= 2e-4 + 2e-4 |plain|`` for the
spline's VJP (the JAX gradient tests' ``atol``, and a relative term for
the steep sites), which must refuse a planted wrong adjoint; ``rtol 2e-4,
atol 2e-5`` for the force (``tests/test_kernels.py:36-37``).
"""

import copy
import math

import numpy as np
import pytest
import torch

from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.nets import CircularConv
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.utils.transplant import jax_leaf_order
from normflow__tpu_torch.zoo import build_phi4_model

pytestmark = pytest.mark.gpu

LIM = (-2.0, 2.0)
VJP_ATOL, VJP_RTOL = 2e-4, 2e-4  # as chip_smoke.py holds the same kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@pytest.fixture
def np_rng():
    return np.random.default_rng(20261017)


def _f32(a, device):
    return torch.tensor(a, dtype=torch.float32, device=device)


def _excess(got, want):
    """The largest ``|got - want| / (VJP_ATOL + VJP_RTOL |want|)`` over the
    elements of the tensor pairs: at most 1 passes."""
    return max(float(((g - w).abs() / (VJP_ATOL + VJP_RTOL * w.abs())).max())
               for g, w in zip(got, want))


def _planted(got, want):
    """A wrong adjoint that the check must refuse: ``got`` plus 1% of each
    tensor's median ``|want|`` on every element."""
    return tuple(g + 0.01 * w.abs().median() for g, w in zip(got, want))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", sc.SUPPORTED_KNOTS)
def test_rqs_coupling_bwd_kernel_matches_plain(cuda, np_rng, m, inverse):
    b, lat = 3, (5, 7)  # 105 sites: the last block is ragged
    out = _f32(np_rng.standard_normal((b, 3 * m - 2, *lat)), cuda)
    for left, right in ((None, None), ("linear", None), (None, "linear"),
                        ("linear", "linear")):
        x = np_rng.uniform(-1.9, 1.9, (b, *lat))
        x = np.where((x < 0) & bool(left) | (x > 0) & bool(right), 1.6 * x, x)
        x = _f32(x, cuda)
        ybar, loggbar = (_f32(np_rng.standard_normal((b, *lat)), cuda)
                         for _ in range(2))
        kw = dict(xlim=LIM, ylim=LIM, left=left, right=right,
                  inverse=inverse)
        before = sc.rqs_coupling_bwd.launches
        got = sc.rqs_coupling_bwd(x, out, ybar, loggbar, **kw)
        assert sc.rqs_coupling_bwd.launches == before + 1
        want = sc.rqs_coupling_vjp_plain(x, out, ybar, loggbar, **kw)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(g).all()) for g in got)
        assert got[1].shape == out.shape and got[1].is_contiguous()
        assert _excess(got, want) <= 1.0
        assert _excess(_planted(got, want), want) > 1.0


def _offset(t, floats=1):
    """A contiguous copy of ``t`` whose data starts ``floats`` floats into
    its storage, so off 16 bytes for ``floats`` = 1."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = buf[floats:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * floats
    return view


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", sc.SUPPORTED_KNOTS)
def test_rqs_coupling_bwd_variants_agree_bit_for_bit(cuda, np_rng, m,
                                                      inverse):
    """The tiled kernel (16-byte aligned, S % 4 == 0) on 12x20 = 240 sites,
    two tiles of which the last is ragged, at B = 3 and B = 1, against the
    per-site kernel on the same values 4 bytes off alignment: the same
    bits, and both within the bar of the plain VJP."""
    lat = (12, 20)
    s = lat[0] * lat[1]
    for b, (left, right) in zip((3, 1, 3, 1), ((None, None), ("linear", None),
                                               (None, "linear"),
                                               ("linear", "linear"))):
        out = _f32(np_rng.standard_normal((b, 3 * m - 2, *lat)), cuda)
        x = np_rng.uniform(-1.9, 1.9, (b, *lat))
        x = np.where((x < 0) & bool(left) | (x > 0) & bool(right), 1.6 * x, x)
        x = _f32(x, cuda)
        ybar, loggbar = (_f32(np_rng.standard_normal((b, *lat)), cuda)
                         for _ in range(2))
        kw = dict(xlim=LIM, ylim=LIM, left=left, right=right,
                  inverse=inverse)
        args = (x, out, ybar, loggbar)
        shifted = tuple(_offset(t) for t in args)
        assert sc.coupling_variant(s, [t.data_ptr() for t in args]) \
            == "tiled"
        assert sc.coupling_variant(s, [t.data_ptr() for t in shifted]) \
            == "sites"
        before = (sc.rqs_coupling_bwd.launches,
                  sc.rqs_coupling_bwd.tiled_launches)
        tiled = sc.rqs_coupling_bwd(*args, **kw)
        assert sc.rqs_coupling_bwd.tiled_launches == before[1] + 1
        sites = sc.rqs_coupling_bwd(*shifted, **kw)
        assert (sc.rqs_coupling_bwd.launches,
                sc.rqs_coupling_bwd.tiled_launches) \
            == (before[0] + 2, before[1] + 1)
        want = sc.rqs_coupling_vjp_plain(*args, **kw)
        torch.cuda.synchronize()
        for p, q in zip(tiled, sites):
            assert torch.equal(p.view(torch.int32), q.view(torch.int32))
        assert all(bool(torch.isfinite(g).all()) for g in tiled)
        assert _excess(tiled, want) <= 1.0
        assert _excess(_planted(tiled, want), want) > 1.0


@pytest.mark.parametrize("lat,hopping", [
    ((64,), True), ((8, 8), True), ((5, 7), True), ((4, 4, 4), True),
    ((1,), False), ((32, 32), False),
])
def test_phi4_action_grad_kernel_matches_plain(cuda, np_rng, lat, hopping):
    cfgs = _f32(np_rng.standard_normal((33, *lat)), cuda)
    g = _f32(np_rng.standard_normal(33), cuda)
    w0, w2, w4 = ScalarPhi4Action(kappa=0.6 if hopping else 0.0, m_sq=-2.4,
                                  lambd=0.5).get_coef(len(lat))
    before = phi4.phi4_action_grad.launches
    got = phi4.phi4_action_grad(cfgs, g, w0, w2, w4)
    assert phi4.phi4_action_grad.launches == before + 1
    want = phi4.phi4_action_grad_plain(cfgs, g, w0, w2, w4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("b", [512, 3])
def test_phi4_action_grad_variants_agree_bit_for_bit(cuda, np_rng, b):
    """The tiled force at (b, 32, 32) (the training shape at b = 512)
    against the general kernel on the same field 4 bytes off alignment,
    with and without the hopping term: the same bits, within the plain
    version's bar, and each tiled launch counted."""
    cfgs = _f32(np_rng.standard_normal((b, 32, 32)), cuda)
    g = _f32(np_rng.standard_normal(b), cuda)
    shifted = _offset(cfgs)
    assert phi4.action_variant((32, 32), cfgs.data_ptr()) == "tiled"
    assert phi4.action_variant((32, 32), shifted.data_ptr()) == "general"
    w0, w2, w4 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4,
                                  lambd=0.5).get_coef(2)
    for w in ((w0, w2, w4), (0.0, w2, w4)):
        before = (phi4.phi4_action_grad.launches,
                  phi4.phi4_action_grad.tiled_launches)
        tiled = phi4.phi4_action_grad(cfgs, g, *w)
        assert phi4.phi4_action_grad.tiled_launches == before[1] + 1
        general = phi4.phi4_action_grad(shifted, g, *w)
        assert (phi4.phi4_action_grad.launches,
                phi4.phi4_action_grad.tiled_launches) \
            == (before[0] + 2, before[1] + 1)
        want = phi4.phi4_action_grad_plain(cfgs, g, *w)
        torch.cuda.synchronize()
        assert torch.equal(tiled.view(torch.int32), general.view(torch.int32))
        torch.testing.assert_close(tiled, want, rtol=2e-4, atol=2e-5)


def test_autograd_goes_through_the_backward_kernels(cuda, np_rng):
    m, b, lat = 8, 4, (8, 8)
    x = _f32(np_rng.standard_normal((b, *lat)), cuda).requires_grad_()
    out = _f32(np_rng.standard_normal((b, 3 * m - 2, *lat)),
               cuda).requires_grad_()
    kw = dict(xlim=LIM, ylim=LIM, left="linear", right="linear")
    before = (sc.rqs_coupling_bwd.launches, phi4.phi4_action_grad.launches)
    y, logg = sc.rqs_coupling(x, out, **kw)
    loss = (phi4.phi4_action(y, 0.6, 0.4, 0.5) + logg.sum((1, 2))).sum()
    gx, gout = torch.autograd.grad(loss, (x, out))
    assert (sc.rqs_coupling_bwd.launches, phi4.phi4_action_grad.launches) \
        == (before[0] + 1, before[1] + 1)
    x64 = x.detach().double().requires_grad_()
    out64 = out.detach().double().requires_grad_()
    y, logg = sc.rqs_coupling_plain(x64, out64, **kw)
    loss = (phi4.phi4_action_plain(y, 0.6, 0.4, 0.5)
            + logg.sum((1, 2))).sum()
    want = torch.autograd.grad(loss, (x64, out64))
    got = (gx.double(), gout.double())
    assert _excess(got, want) <= 1.0
    assert _excess(_planted(got, want), want) > 1.0


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 4, 4), device=cuda)
    out = torch.zeros((2, 22, 4, 4), device=cuda)
    kw = dict(xlim=LIM, ylim=LIM)
    with pytest.raises(TypeError):
        sc.rqs_coupling_bwd(x.double(), out.double(), x.double(),
                            x.double(), **kw)
    with pytest.raises(ValueError, match="knots"):  # m = 5 has no instance
        sc.rqs_coupling_bwd(x, torch.zeros((2, 13, 4, 4), device=cuda), x, x,
                            **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sc.rqs_coupling_bwd(x, out, x.transpose(1, 2), x, **kw)
    with pytest.raises(ValueError, match="no kernel"):  # CPU cotangent
        sc.rqs_coupling_bwd(x, out, x.cpu(), x, **kw)
    with pytest.raises(TypeError):
        phi4.phi4_action_grad(x.double(), torch.zeros(2, device=cuda),
                              0.6, 0.0, 0.5)
    with pytest.raises(ValueError, match="cotangent"):
        phi4.phi4_action_grad(x, torch.zeros(2, device=cuda,
                                             dtype=torch.float64),
                              0.6, 0.0, 0.5)
    with pytest.raises(ValueError, match="1-4 lattice dims"):
        phi4.phi4_action_grad(torch.zeros((2, 2, 2, 2, 2, 2), device=cuda),
                              torch.zeros(2, device=cuda), 0.6, 0.0, 0.5)


@pytest.mark.parametrize("estimator", ["rep", "path"])
def test_small_flagship_step_gpu_matches_cpu(cuda, np_rng, estimator):
    """One training step's loss and gradients at 8x8, the card (float32,
    TF32 off) against a float64 CPU copy on the same draw: loss to 1e-5
    relative, every gradient leaf to 1e-3 of its norm.  The weights get
    seeded noise of 0.3 times the init bound (conv) or N(0, 0.3^2) (the
    rest), as ``chip_smoke.py`` perturbs them, and the test first checks
    that the float32 flow inverts on the card.  With N(0, 0.1^2) noise on
    every leaf it does not: ``f^-1(f(x))`` misses ``x`` by up to 3.8 on an
    H100 and 5.2 on the CPU in float32 (4e-7 in float64), so the path
    estimator's ``log q`` is float32 noise on both devices alike."""
    model = build_phi4_model((8, 8), device=cuda)
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(model.net_):
            s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                if isinstance(owner, CircularConv) else 0.3
            p.add_(_f32(np_rng.standard_normal(tuple(p.shape)) * s, cuda))
    cpu = build_phi4_model((8, 8), device="cpu", dtype=torch.float64)
    cpu.net_.load_state_dict({k: v.double() for k, v in copy.deepcopy(
        model.net_).cpu().state_dict().items()})
    x = np_rng.standard_normal((64, 8, 8))
    with torch.no_grad():
        xd = _f32(x, cuda)
        back, _ = model.net_.backward(model.net_.forward(xd)[0])
        assert float((back - xd).abs().max()) <= 1e-4
    grads = []
    for m, xd in ((model, _f32(x, cuda)),
                  (cpu, torch.tensor(x, dtype=torch.float64))):
        m.fit.grad_estimator = estimator
        loss, _, _ = m.fit.loss_of(xd, m.prior.log_prob(xd))
        params = list(m.net_.parameters())
        grads.append((float(loss.detach()),
                      [g.cpu().double()
                       for g in torch.autograd.grad(loss, params)]))
    (lg, gg), (lc, gc) = grads
    assert abs(lg - lc) <= 1e-5 * max(1.0, abs(lc))
    for a, b in zip(gg, gc):
        assert float((a - b).norm()) <= 1e-3 * max(float(b.norm()), 1e-6)
