"""The channels-last route (``coupling_backend="pallas_reg"``) on the card.

These tests need a CUDA card and ``nvcc``; without a card they skip.  They
import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_channels_last.py

The channels-last coupling kernels and their VJPs, tiled
(``rqs_coupling_cl_tiled_f32``, ``rqs_coupling_bwd_cl_tiled_f32``) and per
site (``rqs_coupling_cl_f32``, ``rqs_coupling_bwd_cl_f32``), at every knot
count and tail flag, on a ragged number of sites and on tile-sized ones,
bit for bit against the NCHW kernels on the same values
(``out.contiguous()``; the per-site and the tiled one) and against each
other, and within ``chip_smoke.py``'s bars of their plain versions; which
shapes and addresses reach which variant, by the counters; a persistent
run at the flagship's shape, where a block takes many tiles; the
wrappers' refusal of other strides; and the route on a
small flagship: the conditioners' output channels-last at every coupling
(float32 and bf16), the launches by profiler name (channels-last
couplings only), logq and one path-gradient step against a float64 CPU
copy.  At 1-, 3- and 4-D: every conv and conditioner output
channels-last (float32 and bf16, on an 8^4 lattice too), the
route's launches by the wrappers (channels-last, tiled where B S % 4 ==
0), and a 4^4 route model against a float64 CPU copy.
"""

import numpy as np
import pytest
import torch

from normflow__tpu_torch.ops.kernels import spline_coupling as sc
from normflow__tpu_torch.tools.kernel_times import device_launches
from normflow__tpu_torch.zoo import build_phi4_model, with_conv_compute_dtype

pytestmark = pytest.mark.gpu

LIM = (-2.0, 2.0)
RQS_TOL = 1e-4
VJP_ATOL, VJP_RTOL = 2e-4, 2e-4  # as chip_smoke.py holds the same kernels
SMALL = dict(knots=4, hidden=(4,), n_layers=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.fixture
def np_rng():
    return np.random.default_rng(20261022)


def _f32(a, device):
    return torch.tensor(a, dtype=torch.float32, device=device)


def _cl(a, device):
    """``a``, ``(B, *lat, 3m-2)``, on the card as ``(B, 3m-2, *lat)``
    channels-last."""
    return _f32(a, device).movedim(-1, 1)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _off(t):
    """A copy of ``t`` in its own strides (contiguous or channels-last), 4
    bytes past a 16-byte aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].as_strided(t.shape, t.stride())
    view.copy_(t)
    return view


def _counts():
    return tuple((c.launches, c.tiled_launches, c.cl_launches)
                 for c in (sc.rqs_coupling, sc.rqs_coupling_bwd))


def _launched(before):
    """``(launches, tiled, channels-last)`` of each wrapper since
    ``before`` (:func:`_counts`)."""
    return tuple(tuple(a - b for a, b in zip(now, was))
                 for now, was in zip(_counts(), before))


TAILS = ((None, None), ("linear", None), (None, "linear"),
         ("linear", "linear"))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", sc.SUPPORTED_KNOTS)
def test_channels_last_kernels_match_nchw_bit_for_bit(cuda, np_rng, m,
                                                      inverse):
    """On 5x7 sites (B S = 105: the per-site kernels of both layouts) and
    12x22 (B S = 792: the tiled ones, a ragged last tile of 24 sites),
    B = 3, every tail flag: forward and VJP bit for bit against the NCHW
    kernels and, at 12x22, against the per-site channels-last kernels on a
    copy 4 bytes off alignment; within the plain versions' bars,
    ``outbar`` channels-last, one channels-last launch per call, tiled
    where B S % 4 == 0."""
    for lat in ((5, 7), (12, 22)):
        for left, right in TAILS:
            out = _cl(np_rng.standard_normal((3, *lat, 3 * m - 2)), cuda)
            x = np_rng.uniform(-1.9, 1.9, (3, *lat))
            x = _f32(np.where((x < 0) & bool(left) | (x > 0) & bool(right),
                              1.6 * x, x), cuda)
            cot = [_f32(np_rng.standard_normal((3, *lat)), cuda)
                   for _ in range(2)]
            kw = dict(xlim=LIM, ylim=LIM, left=left, right=right,
                      inverse=inverse)
            assert sc.coupling_layout(out) == "channels_last"
            tiled = int(lat == (12, 22))
            before = _counts()
            got = sc.rqs_coupling(x, out, **kw)
            gbar = sc.rqs_coupling_bwd(x, out, *cot, **kw)
            assert _launched(before) == ((1, tiled, 1),) * 2
            ref = sc.rqs_coupling(x, out.contiguous(), **kw)
            rbar = sc.rqs_coupling_bwd(x, out.contiguous(), *cot, **kw)
            if tiled:
                off = _off(out)
                before = _counts()
                sites = sc.rqs_coupling(x, off, **kw)
                sbar = sc.rqs_coupling_bwd(x, off, *cot, **kw)
                assert _launched(before) == ((1, 0, 1),) * 2
                for g, r in zip((*got, *gbar), (*sites, *sbar)):
                    assert torch.equal(_bits(g), _bits(r))
            plain = sc.rqs_coupling_plain(x, out, **kw)
            pbar = sc.rqs_coupling_vjp_plain(x, out, *cot, **kw)
            torch.cuda.synchronize()
            assert gbar[1].stride() == out.stride()
            for g, r in zip((*got, *gbar), (*ref, *rbar)):
                assert torch.equal(_bits(g), _bits(r))
            for g, p in zip(got, plain):
                torch.testing.assert_close(g, p, rtol=0, atol=RQS_TOL)
            for g, p in zip(gbar, pbar):
                assert bool(((g - p).abs()
                             <= VJP_ATOL + VJP_RTOL * p.abs()).all())


def test_flagship_shape_launches_the_channels_last_kernels(cuda, np_rng):
    """At the flagship's (1024, 22, 32, 16) channels-last the wrappers
    launch the channels-last kernels, by profiler name, and no NCHW
    one."""
    out = _cl(np_rng.standard_normal((1024, 32, 16, 22)), cuda)
    x = _f32(np_rng.standard_normal((1024, 32, 16)), cuda)
    cot = [_f32(np_rng.standard_normal((1024, 32, 16)), cuda)
           for _ in range(2)]
    kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
              right="linear")
    sc.rqs_coupling(x, out, **kw)
    torch.cuda.synchronize()
    launches = device_launches(lambda: [
        sc.rqs_coupling(x, out, **kw), sc.rqs_coupling(x, out, inverse=True,
                                                       **kw),
        sc.rqs_coupling_bwd(x, out, *cot, **kw)])[0]
    assert launches == {"rqs_coupling_cl": (2, 2),
                        "rqs_coupling_bwd_cl": (1, 1)}, launches


@pytest.mark.parametrize("inverse", [False, True])
def test_persistent_run_at_the_flagship_shape(cuda, np_rng, inverse):
    """At (1024, 22, 32, 16) forward and (512, 22, 32, 16) backward the
    tiles outnumber the persistent grid (2048 tiles of 256 sites and 4096
    of 128, against at most 132 SMs x 4 and x 7 blocks), so each block
    refills its ring many times: the tiled kernels bit for bit against
    the NCHW tiled kernels and the per-site channels-last kernels."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert 1024 * 512 // 256 > 4 * n_sm and 512 * 512 // 128 > 7 * n_sm
    out = _cl(np_rng.standard_normal((1024, 32, 16, 22)), cuda)
    x = _f32(np_rng.standard_normal((1024, 32, 16)), cuda)
    cot = [_f32(np_rng.standard_normal((512, 32, 16)), cuda)
           for _ in range(2)]
    kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
              right="linear", inverse=inverse)
    off = _off(out)
    for b, call in ((1024, lambda o, xx: sc.rqs_coupling(xx, o, **kw)),
                    (512, lambda o, xx: sc.rqs_coupling_bwd(xx, o, *cot,
                                                            **kw))):
        before = _counts()
        got = call(out[:b], x[:b])
        tiled = _launched(before)
        ref = call(out[:b].contiguous(), x[:b])
        sites = call(off[:b], x[:b])
        torch.cuda.synchronize()
        assert sum(t[1] for t in tiled) == 1
        for g, r, p in zip(got, ref, sites):
            assert torch.equal(_bits(g), _bits(r))
            assert torch.equal(_bits(g), _bits(p))


@pytest.mark.parametrize("b,lat,moved,tiled", [
    (4, (4, 4), None, (1, 1)),         # B S = 64
    (1, (5, 4), None, (1, 1)),         # B S = 20, S % 4 == 0
    (4, (5, 7), None, (1, 1)),         # B S = 140, S % 4 != 0: NCHW per site
    (3, (5, 5), None, (0, 0)),         # B S % 4 == 1
    (2, (5, 7), None, (0, 0)),         # B S % 4 == 2
    (1, (5, 7), None, (0, 0)),         # B S % 4 == 3
    (4, (8, 8), "out", (0, 0)),        # out 4 bytes off
    (4, (8, 8), "x", (0, 0)),          # x 4 bytes off
    (4, (8, 8), "ybar", (1, 0)),       # a cotangent 4 bytes off: the VJP per site
    (4, (8, 8), "loggbar", (1, 0)),
])
def test_variant_by_shape_and_alignment_on_the_card(cuda, np_rng, b, lat,
                                                    moved, tiled):
    """Ragged shapes and offset tensors reach the per-site channels-last
    kernels, the rest the tiled ones, by the wrappers' counters (``tiled``:
    the forward's and the VJP's flag); every variant gives the NCHW
    kernels' bits."""
    t = {"out": _cl(np_rng.standard_normal((b, *lat, 10)), cuda),
         **{k: _f32(np_rng.standard_normal((b, *lat)), cuda)
            for k in ("x", "ybar", "loggbar")}}
    if moved is not None:
        t[moved] = _off(t[moved])
    kw = dict(xlim=LIM, ylim=LIM, left="linear", right="linear")
    before = _counts()
    got = (*sc.rqs_coupling(t["x"], t["out"], **kw),
           *sc.rqs_coupling_bwd(t["x"], t["out"], t["ybar"], t["loggbar"],
                                **kw))
    assert _launched(before) == tuple((1, f, 1) for f in tiled)
    nchw = t["out"].contiguous()
    ref = (*sc.rqs_coupling(t["x"], nchw, **kw),
           *sc.rqs_coupling_bwd(t["x"], nchw, t["ybar"], t["loggbar"], **kw))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(_bits(g), _bits(r))


def test_other_strides_raise_on_the_card(cuda):
    x = torch.zeros((2, 4, 4), device=cuda)
    wide = torch.zeros((2, 22, 4, 8), device=cuda).contiguous(
        memory_format=torch.channels_last)[..., ::2]
    with pytest.raises(ValueError, match="channels-last"):
        sc.rqs_coupling(x, wide, xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="channels-last"):
        sc.rqs_coupling_bwd(x, wide, x, x, xlim=LIM, ylim=LIM)


def _route(np_rng):
    """The small flagship on the route, its weights plus seeded noise."""
    model = build_phi4_model((8, 8), coupling_backend="pallas_reg",
                             device="cuda", **SMALL)
    with torch.no_grad():
        for p in model.net_.parameters():
            p.add_(_f32(np_rng.standard_normal(tuple(p.shape)) * 0.1,
                        "cuda"))
    return model


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_conditioner_output_is_channels_last(cuda, np_rng, dtype):
    model = _route(np_rng)
    net_ = model.net_ if dtype is None else \
        with_conv_compute_dtype(model.net_, dtype)
    seen = []
    for net in net_[2].nets:
        net.register_forward_hook(
            lambda mod, inp, out: seen.append(sc.coupling_layout(out)))
    with torch.no_grad():
        net_.forward(_f32(np_rng.standard_normal((16, 8, 8)), cuda))
    assert seen == ["channels_last"] * 2


def test_route_matches_a_float64_cpu_copy(cuda, np_rng):
    """logq per sample to 1e-5 relative, one path-gradient step's loss to
    1e-5 and each leaf's gradient to 1e-3 (chip_smoke.py's bars)."""
    model = _route(np_rng)
    cpu = build_phi4_model((8, 8), coupling_backend="pallas_reg",
                           device="cpu", dtype=torch.float64, **SMALL)
    cpu.net_.load_state_dict({k: v.double().cpu() for k, v in
                              model.net_.state_dict().items()})
    x = np_rng.standard_normal((64, 8, 8))
    res = {}
    for key, m, dtype in (("gpu", model, torch.float32),
                          ("cpu", cpu, torch.float64)):
        xd = torch.tensor(x, dtype=dtype, device=m.device)
        with torch.no_grad():
            logq = m.prior.log_prob(xd) - m.net_.forward(xd)[1]
        m.fit.grad_estimator = "path"
        loss = m.fit.loss_of(xd, m.prior.log_prob(xd))[0]
        grads = torch.autograd.grad(loss, list(m.net_.parameters()))
        res[key] = (logq.cpu().double(), float(loss),
                    [g.cpu().double() for g in grads])
    (lq, loss, g), (lq64, loss64, g64) = res["gpu"], res["cpu"]
    assert float(((lq - lq64).abs() / lq64.abs().clamp(min=1.0)).max()) \
        <= 1e-5
    assert abs(loss - loss64) / max(1.0, abs(loss64)) <= 1e-5
    for a, b in zip(g, g64):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm())


def test_replays_launch_channels_last_couplings_only(cuda, np_rng):
    """The full-width flagship on the route: one replayed batch and one
    replayed step by profiler name, the couplings all channels-last and
    tiled."""
    model = build_phi4_model((32, 32), coupling_backend="pallas_reg")
    model.fit(n_epochs=1, batch_size=512, grad_estimator="path",
              checkpoint_dict=dict(print_stride=None))
    post, fit = model.posterior, model.fit
    post.logqp_stream(1, 1024)
    fit.step()  # both captured
    before = (sc.rqs_coupling.launches, sc.rqs_coupling_bwd.launches)
    assert device_launches(lambda: post.logqp_stream(1, 1024))[0] == {
        "rqs_coupling_cl": (4, 4), "phi4_action": (1, 1)}
    assert device_launches(fit.step)[0] == {
        "rqs_coupling_cl": (8, 8), "rqs_coupling_bwd_cl": (8, 8),
        "phi4_action": (1, 1), "phi4_action_grad": (1, 1)}
    assert (sc.rqs_coupling.launches, sc.rqs_coupling_bwd.launches) == before


# --------------------------------------------------------------------- #
# the route at 1-, 3- and 4-D
# --------------------------------------------------------------------- #
LATS_ND = [(16,), (4, 4, 4), (4, 4, 4, 4)]
RAGGED_ND = [(5,), (3, 3, 3), (3, 3, 3, 3)]  # S odd: B S % 4 != 0 at B = 3


def _route_nd(np_rng, lat, device="cuda"):
    """The small unpacked flagship on the route at ``lat``, its weights
    plus seeded noise."""
    model = build_phi4_model(lat, packed=False, coupling_backend="pallas_reg",
                             device=device, **SMALL)
    with torch.no_grad():
        for p in model.net_.parameters():
            p.add_(_f32(np_rng.standard_normal(tuple(p.shape)) * 0.1,
                        device))
    return model


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("lat", LATS_ND + [(8, 8, 8, 8)],
                         ids=lambda lat: "x".join(map(str, lat)))
def test_conditioner_output_is_channels_last_at_every_rank(cuda, np_rng,
                                                           lat, dtype):
    """Every conv layer's output and every coupling's conditioner output
    channels-last on the card, in float32 and through bf16
    conditioners."""
    from normflow__tpu_torch.models.nets import CircularConv
    from normflow__tpu_torch.ops.lattice import channels_last

    model = _route_nd(np_rng, lat)
    net_ = model.net_ if dtype is None else \
        with_conv_compute_dtype(model.net_, dtype)
    convs, outs = [], []
    for m in net_.modules():
        if isinstance(m, CircularConv):
            m.register_forward_hook(
                lambda mod, inp, out: convs.append(channels_last(out)))
    for net in net_[2].nets:
        net.register_forward_hook(lambda mod, inp, out: outs.append(
            (sc.coupling_layout(out), out.dtype)))
    with torch.no_grad():
        y, _ = net_.forward(_f32(np_rng.standard_normal((8, *lat)), cuda))
        net_.backward(y)
    assert convs and all(convs)
    assert outs == [("channels_last", torch.float32)] * 4


@pytest.mark.parametrize("lat", LATS_ND + RAGGED_ND,
                         ids=lambda lat: "x".join(map(str, lat)))
def test_route_launches_at_every_rank(cuda, np_rng, lat):
    """A path-gradient loss and its gradients on the route: 4 coupling
    launches (2 forward, 2 inverse) and 4 VJPs, every one channels-last,
    tiled where B S % 4 == 0 (B = 3: the ragged lattices take the
    per-site kernels)."""
    model = _route_nd(np_rng, lat)
    model.fit.grad_estimator = "path"
    x = _f32(np_rng.standard_normal((3, *lat)), cuda)
    before = _counts()
    loss = model.fit.loss_of(x, model.prior.log_prob(x))[0]
    torch.autograd.grad(loss, list(model.net_.parameters()))
    tiled = 4 * int(3 * int(np.prod(lat)) % 4 == 0)
    assert _launched(before) == ((4, tiled, 4), (4, tiled, 4))


def test_four_dim_route_matches_a_float64_cpu_copy(cuda, np_rng):
    """The 4^4 route model with the smoke's weights (``perturb_``) on the
    card against float32 and float64 CPU copies: per-sample logq, one
    path-gradient step's loss and each leaf's gradient against float64
    within max(bar, twice the float32 CPU copy's own error), as
    ``tests/test_torch_cuda.py`` holds the 4^4 flagship (logq is a
    difference of terms ~100 times its size there); the bars are
    ``chip_smoke.py``'s, 1e-5 relative for logq and the loss, 1e-3 per
    leaf."""
    from normflow__tpu_torch.tools.kernel_times import perturb_

    lat = (4, 4, 4, 4)
    model = build_phi4_model(lat, packed=False, coupling_backend="pallas_reg",
                             device="cuda", **SMALL)
    perturb_(model.net_, np_rng)
    x = np_rng.standard_normal((64, *lat))
    res = {}
    for key, dtype in (("gpu", torch.float32), ("cpu", torch.float32),
                       ("cpu64", torch.float64)):
        m = model
        if key != "gpu":
            m = build_phi4_model(lat, packed=False, device="cpu", dtype=dtype,
                                 coupling_backend="pallas_reg", **SMALL)
            m.net_.load_state_dict({k: v.to(dtype).cpu() for k, v in
                                    model.net_.state_dict().items()})
        xd = torch.tensor(x, dtype=dtype, device=m.device)
        with torch.no_grad():
            logq = m.prior.log_prob(xd) - m.net_.forward(xd)[1]
        m.fit.grad_estimator = "path"
        loss = m.fit.loss_of(xd, m.prior.log_prob(xd))[0]
        grads = torch.autograd.grad(loss, list(m.net_.parameters()))
        res[key] = (logq.cpu().double(), float(loss.detach()),
                    [g.cpu().double() for g in grads])
    lq64, loss64, g64 = res["cpu64"]

    def errors(key):
        lq, loss, g = res[key]
        return (float(((lq - lq64).abs() / lq64.abs().clamp(min=1.0)).max()),
                abs(loss - loss64) / max(1.0, abs(loss64)),
                [float((a - b).norm()) / float(b.norm())
                 for a, b in zip(g, g64)])

    (lq, loss, leaves), (lq32, loss32, leaves32) = errors("gpu"), \
        errors("cpu")
    assert lq <= max(1e-5, 2 * lq32)
    assert loss <= max(1e-5, 2 * loss32)
    for a, f in zip(leaves, leaves32):
        assert a <= max(1e-3, 2 * f)
