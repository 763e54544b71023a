"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and ``nvcc``; without a card they skip.  They
import nothing of JAX, so they run on a machine without it, from the repo
root (``--noconftest`` leaves out the JAX test configuration)::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py

Beyond ``chip_smoke.py`` (the flagship's shapes only) they cover every
knot count the coupling kernel is built for, one-sided extrapolation, a
ragged number of sites, both coupling variants (the tiled kernel with a
ragged last tile and B = 1, bit for bit against the per-site kernel, which
takes S % 4 != 0 and an ``out`` off 16 bytes), the action's lattice ranks
and both of its variants (the tiled kernel for 2-D lattices that suit its
float4 tile, the flagship's included, with a ragged last block and B = 1;
the general kernel for 1-D, V = 1, L1 % 4 != 0 and a field off 16
bytes), the tiled nd kernels at 3-D and 4-D (the 8^4 flagship's shapes,
its force bit for bit against the general entry, a graphed 8^4 batch) and
the general ones on the lattices outside their tile, the tiled nd slab
kernels on the slabs of 3-D and 4-D fields (the force bit for bit against
the general slab entry) and the general slab kernels off their tile, and
the wrappers' and C entries' refusals (the backward kernels:
``tests/test_torch_cuda_grad.py``).
Tolerances are those of ``chip_smoke.py``: 1e-4 absolute for
the spline (the JAX Pallas tests' own), 2e-5 relative for the action.
"""

import copy

import numpy as np
import pytest
import torch

from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.tools.kernel_times import device_launches, perturb_
from normflow__tpu_torch.zoo import build_phi4_model

pytestmark = pytest.mark.gpu

LIM = (-2.0, 2.0)


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
    return np.random.default_rng(20261016)


def _f32(a, device):
    return torch.tensor(a, dtype=torch.float32, device=device)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", sc.SUPPORTED_KNOTS)
def test_rqs_coupling_kernel_matches_plain(cuda, np_rng, m, inverse):
    b, lat = 3, (5, 7)  # 105 sites: the last block is ragged
    out = _f32(np_rng.standard_normal((b, 3 * m - 2, *lat)), cuda)
    for left, right in ((None, None), ("linear", None), (None, "linear"),
                        ("linear", "linear")):
        x = np_rng.uniform(-1.9, 1.9, (b, *lat))
        # reach past the box on the extrapolated sides only
        x = np.where((x < 0) & bool(left) | (x > 0) & bool(right), 1.6 * x, x)
        x = _f32(x, cuda)
        kw = dict(xlim=LIM, ylim=LIM, left=left, right=right,
                  inverse=inverse)
        before = sc.rqs_coupling.launches
        y, g = sc.rqs_coupling(x, out, **kw)
        assert sc.rqs_coupling.launches == before + 1
        yp, gp = sc.rqs_coupling_plain(x, out, **kw)
        torch.cuda.synchronize()
        for got, want in ((y, yp), (g, gp)):
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _offset(t):
    """A contiguous copy of ``t`` whose data starts one float into its
    storage, so 4 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", sc.SUPPORTED_KNOTS)
def test_rqs_coupling_variants_agree_bit_for_bit(cuda, np_rng, m, inverse):
    """The tiled kernel (16-byte aligned, S % 4 == 0) on 12x11 = 132 sites
    (one tile, ragged) and 12x22 = 264 (two tiles, the last of 8 sites),
    at B = 3 and B = 1, for each extrapolation flag, against the per-site
    kernel on the same values with ``out`` 4 bytes off alignment: the same
    bits, and within 1e-4 of the plain version."""
    for (b, lat), (left, right) in zip(
            ((3, (12, 11)), (1, (12, 22)), (3, (12, 22)), (1, (12, 11))),
            ((None, None), ("linear", None), (None, "linear"),
             ("linear", "linear"))):
        s = lat[0] * lat[1]
        out = _f32(np_rng.standard_normal((b, 3 * m - 2, *lat)), cuda)
        x = np_rng.uniform(-1.9, 1.9, (b, *lat))
        x = np.where((x < 0) & bool(left) | (x > 0) & bool(right), 1.6 * x, x)
        x = _f32(x, cuda)
        shifted = _offset(out)
        kw = dict(xlim=LIM, ylim=LIM, left=left, right=right,
                  inverse=inverse)
        assert sc.coupling_variant(s, [x.data_ptr(), out.data_ptr()]) \
            == "tiled"
        assert sc.coupling_variant(s, [x.data_ptr(), shifted.data_ptr()]) \
            == "sites"
        before = (sc.rqs_coupling.launches, sc.rqs_coupling.tiled_launches)
        tiled = sc.rqs_coupling(x, out, **kw)
        assert sc.rqs_coupling.tiled_launches == before[1] + 1
        sites = sc.rqs_coupling(x, shifted, **kw)
        assert (sc.rqs_coupling.launches, sc.rqs_coupling.tiled_launches) \
            == (before[0] + 2, before[1] + 1)
        want = sc.rqs_coupling_plain(x, out, **kw)
        torch.cuda.synchronize()
        for p, q, w in zip(tiled, sites, want):
            assert torch.equal(p.view(torch.int32), q.view(torch.int32))
            assert bool(torch.isfinite(p).all())
            torch.testing.assert_close(p, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_flagship_coupling_launches_the_tiled_kernel(cuda, np_rng, inverse):
    """At the flagship's (1024, 22, 32, 16) the wrapper launches the tiled
    coupling kernel in both directions, as its count and the profiler name
    it (``device_launches``: 3 launches by name, all of the tiled kernel,
    none of the per-site one)."""
    out = _f32(np_rng.standard_normal((1024, 22, 32, 16)), cuda)
    x = _f32(np_rng.standard_normal((1024, 32, 16)), cuda)
    kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
              right="linear", inverse=inverse)
    sc.rqs_coupling(x, out, **kw)
    torch.cuda.synchronize()
    before = sc.rqs_coupling.tiled_launches
    launches = device_launches(
        lambda: [sc.rqs_coupling(x, out, **kw) for _ in range(3)])[0]
    assert sc.rqs_coupling.tiled_launches == before + 3
    assert launches == {"rqs_coupling": (3, 3)}, launches


@pytest.mark.parametrize("lat,hopping", [
    ((64,), True), ((8, 8), True), ((5, 7), True), ((4, 4, 4), True),
    ((32, 32), False),
])
def test_phi4_action_kernel_matches_plain(cuda, np_rng, lat, hopping):
    cfgs = _f32(np_rng.standard_normal((33, *lat)), cuda)
    w0, w2, w4 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4,
                                  lambd=0.5).get_coef(len(lat))
    w = (w0 if hopping else 0.0, w2, w4)
    before = phi4.phi4_action.launches
    got = phi4.phi4_action(cfgs, *w)
    assert phi4.phi4_action.launches == before + 1
    want = phi4.phi4_action_plain(cfgs, *w)
    torch.cuda.synchronize()
    rel = (got - want).abs() / want.abs().clamp(min=1.0)
    assert float(rel.max()) <= 2e-5


@pytest.mark.parametrize("b,lat,variant", [
    (1, (32, 32), "tiled"), (33, (32, 32), "tiled"), (9, (16, 16), "tiled"),
    (5, (8, 16), "tiled"), (7, (1, 128), "tiled"), (3, (1,), "general"),
    (4, (6, 30), "general"), (4, (6, 6, 6), "general"),
    (4, (8, 8), "general"),
])
def test_phi4_action_variants_match_plain(cuda, np_rng, b, lat, variant):
    """Each lattice takes the variant :func:`phi4.action_variant` names
    and agrees with the plain version, with and without the hopping term;
    the tiled lattices, 4 bytes off alignment, take the general kernel and
    agree too."""
    cfgs = _f32(np_rng.standard_normal((b, *lat)), cuda)
    fields = [(cfgs, variant)]
    if variant == "tiled":
        buf = torch.empty(cfgs.numel() + 1, device=cuda)
        shifted = buf[1:].view(cfgs.shape)
        shifted.copy_(cfgs)
        fields.append((shifted, "general"))
    for field, want_variant in fields:
        assert phi4.action_variant(lat, field.data_ptr()) == want_variant
        w0, w2, w4 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4,
                                      lambd=0.5).get_coef(len(lat))
        for w in ((w0, w2, w4), (0.0, w2, w4)):
            before = phi4.phi4_action.tiled_launches
            got = phi4.phi4_action(field, *w)
            assert phi4.phi4_action.tiled_launches \
                == before + (want_variant == "tiled")
            want = phi4.phi4_action_plain(field.double(), *w)
            torch.cuda.synchronize()
            rel = (got.double() - want).abs() / want.abs().clamp(min=1.0)
            assert float(rel.max()) <= 2e-5


def test_flagship_action_launches_the_tiled_kernel(cuda, np_rng):
    """At the flagship's (1024, 32, 32) the wrapper launches the tiled
    kernel, as its count and the profiler name it (3 launches by name, all
    tiled)."""
    cfgs = _f32(np_rng.standard_normal((1024, 32, 32)), cuda)
    assert phi4.action_variant((32, 32), cfgs.data_ptr()) == "tiled"
    assert phi4.action_plan((32, 32)) == (256, 1)
    phi4.phi4_action(cfgs, 0.6, 0.4, 0.5)
    torch.cuda.synchronize()
    before = phi4.phi4_action.tiled_launches
    launches = device_launches(
        lambda: [phi4.phi4_action(cfgs, 0.6, 0.4, 0.5) for _ in range(3)])[0]
    assert phi4.phi4_action.tiled_launches == before + 3
    assert launches == {"phi4_action": (3, 3)}, launches


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        sc.rqs_coupling(x.double(), torch.zeros((2, 22, 4, 4), device=cuda,
                                                dtype=torch.float64),
                        xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="knots"):  # m = 5 has no instance
        sc.rqs_coupling(x, torch.zeros((2, 13, 4, 4), device=cuda),
                        xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="contiguous"):
        sc.rqs_coupling(x.transpose(1, 2), torch.zeros((2, 22, 4, 4),
                                                       device=cuda),
                        xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="no kernel"):  # CPU x, CUDA out
        sc.rqs_coupling(x.cpu(), torch.zeros((2, 22, 4, 4), device=cuda),
                        xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="knots"):  # with a gradient too
        sc.rqs_coupling(x.clone().requires_grad_(),
                        torch.zeros((2, 13, 4, 4), device=cuda),
                        xlim=LIM, ylim=LIM)
    with pytest.raises(TypeError):
        phi4.phi4_action(torch.zeros((2, 4, 4), device=cuda,
                                     dtype=torch.float64), 0.6, 0.0, 0.5)
    with pytest.raises(ValueError, match="1-4 lattice dims"):
        phi4.phi4_action(torch.zeros((2, 2, 2, 2, 2, 2), device=cuda),
                         0.6, 0.0, 0.5)
    with pytest.raises(ValueError, match="1-4 lattice dims"):
        phi4.phi4_action_grad(torch.zeros((2, 2, 2, 2, 2, 2), device=cuda),
                              torch.zeros(2, device=cuda), 0.6, 0.0, 0.5)
    with pytest.raises(ValueError, match="1-4 lattice dims"):
        phi4.phi4_action_slab(torch.zeros((2, 1, 2, 2, 2, 2), device=cuda),
                              torch.zeros((2, 2, 2, 2, 2, 2), device=cuda),
                              0.6, 0.0, 0.5)
    # the tiled nd entries: a field or force off 16 bytes, or a lattice
    # outside the tile, is cudaErrorInvalidValue (1), which the wrapper's
    # check raises; nothing is launched
    from normflow__tpu_torch.ops.kernels import _lib

    lib = _lib.library()
    buf = torch.zeros(2 * 4096 + 4, device=cuda)
    g, act = torch.zeros(2, device=cuda), torch.zeros(2, device=cuda)
    out = torch.zeros_like(buf)
    stream = torch.cuda.current_stream().cuda_stream
    w = (0.6, 0.4, 0.5)
    # (nd and extents, field offset, force offset, action's and force's
    # return codes)
    for lat, off, force_off, want in (
            ((4, 8, 8, 8, 8), 0, 0, [0, 0]),      # the 8^4 tile
            ((3, 16, 16, 16, 1), 0, 0, [0, 0]),   # 1024 float4s at 3-D
            ((4, 8, 8, 8, 8), 1, 0, [1, 1]),      # the field off 16 bytes
            ((4, 8, 8, 8, 8), 0, 1, [0, 1]),      # the force off 16 bytes
            ((3, 8, 8, 6, 1), 0, 0, [1, 1]),      # the last extent 6
            ((3, 4, 4, 4, 1), 0, 0, [1, 1]),      # 16 float4s: no warp
            ((4, 16, 16, 16, 1), 0, 0, [1, 1]),   # 4-D, the last extent 1
            ((2, 32, 32, 1, 1), 0, 0, [1, 1]),    # 2-D: the tiled kernel's
            ((4, 16, 16, 16, 16), 0, 0, [1, 1])):  # 16384 float4s
        c = buf[off:off + 2 * 4096]
        errs = [lib.phi4_action_tiled_nd_f32(c.data_ptr(), act.data_ptr(),
                                             2, *lat, *w, stream),
                lib.phi4_action_grad_tiled_nd_f32(
                    c.data_ptr(), g.data_ptr(), out[force_off:].data_ptr(),
                    2, *lat, *w, stream)]
        assert errs == want, (lat, off, force_off, errs)
        for err in errs:
            if err:
                with pytest.raises(RuntimeError, match="launch failed"):
                    _lib.check(err, "phi4_action_grad")
    torch.cuda.synchronize()


# 4-D lattices: the flagship's 8^4, odd extents, and trailing extents of 1
LAT4 = [(8, 8, 8, 8), (3, 5, 4, 6), (4, 4, 4, 1), (2, 3, 1, 1)]


@pytest.mark.parametrize("lat", LAT4)
@pytest.mark.parametrize("hopping", [True, False])
def test_phi4_kernels_at_four_dims_match_plain(cuda, np_rng, lat, hopping):
    """The action and its force on 4-D fields launch the tiled nd kernels
    at 8^4 and the general kernels on the lattices outside that tile (a
    wrapper launch each, tiled at 8^4 only) and agree with their plain
    versions: the action to 2e-5 relative, the force element by element
    within the smoke's ``FORCE_*`` bars (2e-5 + 2e-4 |plain|)."""
    cfgs = _f32(np_rng.standard_normal((65, *lat)), cuda)
    g = _f32(np_rng.standard_normal(65), cuda)
    w0, w2, w4 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4,
                                  lambd=0.5).get_coef(4)
    w = (w0 if hopping else 0.0, w2, w4)
    tiled = lat == (8, 8, 8, 8)
    assert phi4.action_variant(lat, cfgs.data_ptr()) == (
        "tiled_nd" if tiled else "general")
    before = [(f.launches, f.tiled_launches)
              for f in (phi4.phi4_action, phi4.phi4_action_grad)]
    got = phi4.phi4_action(cfgs, *w)
    force = phi4.phi4_action_grad(cfgs, g, *w)
    assert [(f.launches, f.tiled_launches) for f in (
        phi4.phi4_action, phi4.phi4_action_grad)] == [
        (n + 1, t + tiled) for n, t in before]
    want = phi4.phi4_action_plain(cfgs.double(), *w)
    want_force = phi4.phi4_action_grad_plain(cfgs, g, *w)
    torch.cuda.synchronize()
    rel = (got.double() - want).abs() / want.abs().clamp(min=1.0)
    assert float(rel.max()) <= 2e-5
    assert bool(((force - want_force).abs()
                 <= 2e-5 + 2e-4 * want_force.abs()).all())


def _general(cfgs, w, g=None, halo=None):
    """The general kernels' action (or, given ``g``, force) of ``cfgs``
    through their C entries; with ``halo``, the general slab kernels'."""
    from normflow__tpu_torch.ops.kernels import _lib

    lib = _lib.library()
    lat = list(cfgs.shape[1:]) + [1] * (5 - cfgs.dim())
    stream = torch.cuda.current_stream().cuda_stream
    rows = () if halo is None else (halo.data_ptr(),)
    shape = (cfgs.shape[0], cfgs.dim() - 1, *lat, *w, stream)
    if g is None:
        out = torch.empty(cfgs.shape[0], device=cfgs.device)
        entry = (lib.phi4_action_f32 if halo is None
                 else lib.phi4_action_slab_f32)
        err = entry(cfgs.data_ptr(), *rows, out.data_ptr(), *shape)
    else:
        out = torch.empty_like(cfgs)
        entry = (lib.phi4_action_grad_f32 if halo is None
                 else lib.phi4_action_grad_slab_f32)
        err = entry(cfgs.data_ptr(), *rows, g.data_ptr(), out.data_ptr(),
                    *shape)
    _lib.check(err, "general phi4 entry")
    return out


@pytest.mark.parametrize("b,lat", [(1024, (8, 8, 8, 8)),
                                   (512, (8, 8, 8, 8)), (64, (8, 8, 8)),
                                   (3, (4, 4, 4, 4)), (5, (8, 8, 16)),
                                   (1, (8, 8, 8, 8))])
@pytest.mark.parametrize("hopping", [True, False])
def test_tiled_nd_kernels_match_plain_and_the_general_ones(cuda, np_rng, b,
                                                           lat, hopping):
    """The tiled nd kernels at the 8^4 flagship's batch and step and at
    3-D (a launch each, tiled): the action within 2e-5 relative of its
    plain version (float64) and of the general kernel, the force within
    the ``FORCE_*`` bars of its plain version and bit for bit with the
    general kernel's (``phi4_action_grad_f32`` through ``_lib``)."""
    cfgs = _f32(np_rng.standard_normal((b, *lat)), cuda)
    g = _f32(np_rng.standard_normal(b), cuda)
    w0, w2, w4 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4,
                                  lambd=0.5).get_coef(len(lat))
    w = (w0 if hopping else 0.0, w2, w4)
    assert phi4.action_variant(lat, cfgs.data_ptr()) == "tiled_nd"
    before = [f.tiled_launches for f in (phi4.phi4_action,
                                         phi4.phi4_action_grad)]
    got = phi4.phi4_action(cfgs, *w)
    force = phi4.phi4_action_grad(cfgs, g, *w)
    assert [f.tiled_launches for f in (phi4.phi4_action,
                                       phi4.phi4_action_grad)] == [
        n + 1 for n in before]
    general, general_force = _general(cfgs, w), _general(cfgs, w, g)
    want = phi4.phi4_action_plain(cfgs.double(), *w)
    want_force = phi4.phi4_action_grad_plain(cfgs, g, *w)
    torch.cuda.synchronize()
    for ref in (want, general.double()):
        rel = (got.double() - ref).abs() / ref.abs().clamp(min=1.0)
        assert float(rel.max()) <= 2e-5
    assert bool(((force - want_force).abs()
                 <= 2e-5 + 2e-4 * want_force.abs()).all())
    assert torch.equal(force.view(torch.int32),
                       general_force.view(torch.int32))


def test_graphed_four_dim_batch_launches_the_tiled_nd_action(cuda, np_rng):
    """A replayed batch of the 8^4 flagship (small widths) launches the
    tiled nd action once, as the profiler names it."""
    model = build_phi4_model((8, 8, 8, 8), packed=False, knots=4,
                             hidden=(4,), n_layers=2, device=cuda)
    perturb_(model.net_, np_rng)
    post = model.posterior
    post.logqp_stream(1, 64)  # captured outside the profiled window
    torch.cuda.synchronize()
    before = phi4.phi4_action.launches
    launches = device_launches(lambda: post.logqp_stream(1, 64))[0]
    assert phi4.phi4_action.launches == before  # a replay: no wrapper call
    assert launches["phi4_action"] == (1, 1), launches


@pytest.mark.parametrize("shape", [(64, 8, 8, 8, 8), (33, 4, 5, 3, 6),
                                   (16, 4, 4, 4, 1)])
@pytest.mark.parametrize("n", [2, 4])
def test_slab_kernels_at_four_dims_match_the_whole(cuda, np_rng, shape, n):
    """The slab action and force on ``n`` slabs of a 4-D field, halos
    ``(B, 2, L1, L2, L3)`` cut by hand, summed and stacked, against the
    whole-lattice kernels and the slab plain versions."""
    cfgs = _f32(np_rng.standard_normal(shape), cuda)
    g = _f32(np_rng.standard_normal(shape[0]), cuda)
    w = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(4)
    l0, rows = shape[1], shape[1] // n
    before = phi4.phi4_action_slab.launches
    act, plain_act, force, plain_force = 0, 0, [], []
    for r in range(n):
        slab = cfgs[:, r * rows:(r + 1) * rows].contiguous()
        halo = torch.stack([cfgs[:, (r * rows - 1) % l0],
                            cfgs[:, ((r + 1) * rows) % l0]], 1).contiguous()
        act = act + phi4.phi4_action_slab(slab, halo, *w)
        plain_act = plain_act + phi4.phi4_action_slab_plain(slab, halo, *w)
        force.append(phi4.phi4_action_slab_grad(slab, halo, g, *w))
        plain_force.append(phi4.phi4_action_slab_grad_plain(slab, halo, g,
                                                            *w))
    assert phi4.phi4_action_slab.launches == before + n
    force, plain_force = torch.cat(force, 1), torch.cat(plain_force, 1)
    torch.cuda.synchronize()
    for want in (phi4.phi4_action(cfgs, *w), plain_act):
        rel = (act - want).abs() / want.abs().clamp(min=1.0)
        assert float(rel.max()) <= 2e-5
    for want in (phi4.phi4_action_grad(cfgs, g, *w), plain_force):
        assert bool(((force - want).abs()
                     <= 2e-5 + 2e-4 * want.abs()).all())


def _slabs(cfgs, n):
    """The ``n`` slabs of ``cfgs`` as ``parallel/space.slab_of`` splits
    its rows, each with its halo rows cut by hand."""
    from normflow__tpu_torch.parallel.space import slab_of

    l0, out = cfgs.shape[1], []
    for r in range(n):
        s = slab_of(None, r, n, l0)
        out.append((cfgs[:, s.row0:s.row0 + s.rows].contiguous(),
                    torch.stack([cfgs[:, (s.row0 - 1) % l0],
                                 cfgs[:, (s.row0 + s.rows) % l0]],
                                1).contiguous()))
    return out


@pytest.mark.parametrize("shape,n", [((1024, 8, 8, 8, 8), 2),
                                     ((1024, 8, 8, 8, 8), 3),
                                     ((64, 8, 8, 8), 2), ((5, 8, 8, 16), 2),
                                     ((3, 4, 4, 4, 4), 2)])
@pytest.mark.parametrize("hopping", [True, False])
def test_tiled_nd_slab_kernels_match_plain_and_the_general_ones(
        cuda, np_rng, shape, n, hopping):
    """The tiled nd slab kernels on the ``n`` slabs of a 3-D or 4-D field
    (8 rows over three ranks: 3, 3 and 2): each slab takes them (a tiled
    launch each); the action within 2e-5 relative of the plain slab
    version and of the general slab entry, the summed actions of the whole
    lattice's kernel; the force within the ``FORCE_*`` bars of its plain
    version and bit for bit with the general slab entry's."""
    cfgs = _f32(np_rng.standard_normal(shape), cuda)
    g = _f32(np_rng.standard_normal(shape[0]), cuda)
    w0, w2, w4 = ScalarPhi4Action(kappa=0.6, m_sq=-2.4,
                                  lambd=0.5).get_coef(len(shape) - 1)
    w = (w0 if hopping else 0.0, w2, w4)
    total = 0
    for slab, halo in _slabs(cfgs, n):
        assert phi4.slab_variant(slab.shape[1:], slab.data_ptr(),
                                 halo.data_ptr()) == "tiled_nd"
        before = [f.tiled_launches for f in (phi4.phi4_action_slab,
                                             phi4.phi4_action_slab_grad)]
        act = phi4.phi4_action_slab(slab, halo, *w)
        force = phi4.phi4_action_slab_grad(slab, halo, g, *w)
        assert [f.tiled_launches for f in (
            phi4.phi4_action_slab, phi4.phi4_action_slab_grad)] == [
            k + 1 for k in before]
        want = phi4.phi4_action_slab_plain(slab.double(), halo.double(), *w)
        want_force = phi4.phi4_action_slab_grad_plain(slab, halo, g, *w)
        general = _general(slab, w, halo=halo)
        general_force = _general(slab, w, g, halo)
        torch.cuda.synchronize()
        for ref in (want, general.double()):
            rel = (act.double() - ref).abs() / ref.abs().clamp(min=1.0)
            assert float(rel.max()) <= 2e-5
        assert bool(((force - want_force).abs()
                     <= 2e-5 + 2e-4 * want_force.abs()).all())
        assert torch.equal(force.view(torch.int32),
                           general_force.view(torch.int32))
        total = total + act.double()
    whole = phi4.phi4_action(cfgs, *w).double()
    rel = (total - whole).abs() / whole.abs().clamp(min=1.0)
    assert float(rel.max()) <= 2e-5


def test_slab_kernels_off_the_tile_stay_general(cuda, np_rng):
    """A 4-D slab whose field, halo or force lies off 16 bytes, and an odd
    slab, take the general slab kernels (no tiled launch) and agree with
    the tiled nd ones."""
    cfgs = _f32(np_rng.standard_normal((64, 8, 8, 8, 8)), cuda)
    g = _f32(np_rng.standard_normal(64), cuda)
    w = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(4)
    slab, halo = _slabs(cfgs, 2)[0]

    def offset(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    tiled = phi4.phi4_action_slab_grad(slab, halo, g, *w)
    counters = (phi4.phi4_action_slab, phi4.phi4_action_slab_grad)
    before = [c.tiled_launches for c in counters]
    for s, h in ((offset(slab), halo), (slab, offset(halo))):
        act = phi4.phi4_action_slab(s, h, *w)
        force = phi4.phi4_action_slab_grad(s, h, g, *w)
        torch.cuda.synchronize()
        assert torch.equal(force.view(torch.int32), tiled.view(torch.int32))
        want = phi4.phi4_action_slab_plain(slab.double(), halo.double(), *w)
        assert float(((act.double() - want).abs()
                      / want.abs().clamp(min=1.0)).max()) <= 2e-5
    odd = _f32(np_rng.standard_normal((8, 3, 5, 4, 6)), cuda)
    odd_halo = _f32(np_rng.standard_normal((8, 2, 5, 4, 6)), cuda)
    assert phi4.slab_variant(odd.shape[1:], odd.data_ptr(),
                             odd_halo.data_ptr()) == "general"
    phi4.phi4_action_slab(odd, odd_halo, *w)
    phi4.phi4_action_slab_grad(odd, odd_halo, g[:8], *w)
    assert [c.tiled_launches for c in counters] == before


def test_tiled_nd_slab_entries_refuse_shapes_off_the_tile(cuda):
    """The tiled nd slab entries return cudaErrorInvalidValue (1), which
    the wrapper's check raises, for a slab, halo or force off 16 bytes and
    for extents outside the tile; nothing is launched."""
    from normflow__tpu_torch.ops.kernels import _lib

    lib = _lib.library()
    buf = torch.zeros(2 * 4096 + 4, device=cuda)
    hbuf = torch.zeros(2 * 2 * 1024 + 4, device=cuda)
    g, act = torch.zeros(2, device=cuda), torch.zeros(2, device=cuda)
    out = torch.zeros_like(buf)
    stream = torch.cuda.current_stream().cuda_stream
    w = (0.6, 0.4, 0.5)
    # (nd and extents, slab, halo and force offsets, the action's and the
    # force's return codes)
    for lat, offs, want in (
            ((4, 4, 8, 8, 8), (0, 0, 0), [0, 0]),    # half the 8^4 lattice
            ((4, 3, 8, 8, 8), (0, 0, 0), [0, 0]),    # 8 rows over 3 ranks
            ((3, 4, 8, 8, 1), (0, 0, 0), [0, 0]),    # half of 8^3
            ((4, 4, 8, 8, 8), (1, 0, 0), [1, 1]),    # the slab off 16 bytes
            ((4, 4, 8, 8, 8), (0, 1, 0), [1, 1]),    # the halo off
            ((4, 4, 8, 8, 8), (0, 0, 1), [0, 1]),    # the force off
            ((4, 3, 5, 4, 6), (0, 0, 0), [1, 1]),    # the last extent 6
            ((3, 2, 4, 4, 1), (0, 0, 0), [1, 1]),    # 8 float4s: no warp
            ((4, 12, 8, 8, 8), (0, 0, 0), [1, 1]),   # 1536 float4s
            ((2, 16, 32, 1, 1), (0, 0, 0), [1, 1])):  # 2-D: the 2-D tile's
        c, h = buf[offs[0]:], hbuf[offs[1]:]
        errs = [lib.phi4_action_slab_tiled_nd_f32(
                    c.data_ptr(), h.data_ptr(), act.data_ptr(), 2, *lat, *w,
                    stream),
                lib.phi4_action_grad_slab_tiled_nd_f32(
                    c.data_ptr(), h.data_ptr(), g.data_ptr(),
                    out[offs[2]:].data_ptr(), 2, *lat, *w, stream)]
        assert errs == want, (lat, offs, errs)
        for err in errs:
            if err:
                with pytest.raises(RuntimeError, match="launch failed"):
                    _lib.check(err, "phi4_action_slab_grad")
    torch.cuda.synchronize()


def test_small_four_dim_flagship_gpu_matches_cpu(cuda, np_rng):
    """The unpacked flagship at 4^4 (3^4 convs by roll-and-sum, the 4-D
    FFT flow) on the card against float32 and float64 CPU copies: per
    sample logq against float64 within max(1e-5, twice the float32 CPU
    copy's own relative error: logq is a difference of terms ~100 times
    its size here, 3e-4 off in float32 on the CPU), ``y`` to 1e-4 of the
    float32 copy, the action against its plain version, the round trip.
    The weights take the smoke's perturbation (``perturb_``: the conv
    noise scaled by the init bound): N(0, 0.01) on every 3^4 conv weight
    steepens the map until float32 loses the round trip on the CPU too
    (mean |dx| 5.6e-3 there, 1e-11 in float64)."""
    lat = (4, 4, 4, 4)
    model = build_phi4_model(lat, packed=False, knots=4, hidden=(4,),
                             n_layers=2, device=cuda)
    perturb_(model.net_, np_rng)
    x = _f32(np_rng.standard_normal((16, *lat)), "cpu")
    before = phi4.phi4_action.launches
    with torch.no_grad():
        y, logj = model.net_.forward(x.to(cuda))
        logq = (model.prior.log_prob(x.to(cuda)) - logj).cpu().double()
        logp = model.action.log_prob(y).cpu()
        x_back, log0 = model.net_.backward(y, log0=logj)
        cpu = {}
        for dtype in (torch.float32, torch.float64):
            net = copy.deepcopy(model.net_).cpu().to(dtype)
            prior = copy.deepcopy(model.prior).cpu()
            xd = x.to(dtype)
            yd, logjd = net.forward(xd)
            cpu[dtype] = (yd, (prior.log_prob(xd).to(dtype) - logjd).double())
    assert phi4.phi4_action.launches == before + 1
    want = cpu[torch.float64][1]

    def rel(a):
        return float(((a - want).abs() / want.abs().clamp(min=1.0)).max())

    assert rel(logq) <= max(1e-5, 2 * rel(cpu[torch.float32][1]))
    torch.testing.assert_close(y.cpu(), cpu[torch.float32][0], rtol=0,
                               atol=1e-4)
    want_logp = -phi4.phi4_action_plain(y.cpu().double(),
                                        *model.action.get_coef(4))
    rel_logp = (logp - want_logp).abs() / want_logp.abs().clamp(min=1.0)
    assert float(rel_logp.max()) <= 2e-5
    assert float((x_back.cpu() - x).abs().mean()) <= 1e-5
    assert float(log0.abs().max()) <= 1e-3


def test_small_flagship_gpu_matches_cpu(cuda, np_rng):
    """The slice at 8x8 on the card against a CPU copy: per-sample logq to
    1e-5 relative, the same bound as the full-width check."""
    model = build_phi4_model((8, 8), knots=4, hidden=(4,), n_layers=2,
                             device=cuda)
    with torch.no_grad():
        for p in model.net_.parameters():
            p.add_(_f32(np_rng.standard_normal(tuple(p.shape)) * 0.1, cuda))
    net_cpu = copy.deepcopy(model.net_).cpu()
    prior_cpu = copy.deepcopy(model.prior).cpu()
    x = _f32(np_rng.standard_normal((16, 8, 8)), "cpu")
    with torch.no_grad():
        y, logj = model.net_.forward(x.to(cuda))
        logq = (model.prior.log_prob(x.to(cuda)) - logj).cpu()
        y_cpu, logj_cpu = net_cpu.forward(x)
        logq_cpu = prior_cpu.log_prob(x) - logj_cpu
        x_back, log0 = model.net_.backward(y, log0=logj)
    rel = (logq - logq_cpu).abs() / logq_cpu.abs().clamp(min=1.0)
    assert float(rel.max()) <= 1e-5
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=0, atol=1e-4)
    assert float((x_back.cpu() - x).abs().mean()) <= 1e-5
    assert float(log0.abs().max()) <= 1e-3
