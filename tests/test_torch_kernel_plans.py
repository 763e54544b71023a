"""Host-side plans of the port's tiled kernels, and the kernel tools.

The tiled CUDA kernels run only on the card (``tests/test_torch_cuda*.py``,
marker ``gpu``), but the wrappers choose between variants, and plan the
tiled action's and force's blocks, on the host by shape and alignment
alone: these tests hold that logic on the CPU, and with it the bytes,
bounds, profiler names, SASS counts and output comparison of
``normflow__tpu_torch/tools/kernel_times.py`` and the source edits of
``normflow__tpu_torch/tools/const_sweep.py``.
"""

import numpy as np
import pytest
import torch

from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.tools import kernel_times as kt


def _variant(s, ptrs):
    """:func:`coupling_variant` as a wrapper calls it: ``s`` sites per
    sample of an NCHW ``out``, or ``(b, s)``, an ``out`` of ``b`` samples
    of ``s`` sites laid out channels-last, whose layout the wrapper reads
    from its strides (NCHW where there is one site per sample)."""
    if isinstance(s, int):
        return sc.coupling_variant(s, ptrs)
    b, s = s
    out = torch.empty((b, s, 22), device="meta").movedim(-1, 1)
    return sc.coupling_variant(s, ptrs, sc.coupling_layout(out), b)


@pytest.mark.parametrize("s,offsets,variant", [
    (512, (0, 0, 0, 0, 0, 0), "tiled"),     # the flagship's 32x16 sites
    (240, (0, 0, 0, 0, 0, 0), "tiled"),     # a ragged last tile
    (4, (0, 0, 0, 0, 0, 0), "tiled"),
    (35, (0, 0, 0, 0, 0, 0), "sites"),      # S % 4 != 0: rows off 16 bytes
    (512, (0, 4, 0, 0, 0, 0), "sites"),     # out at a storage offset
    (512, (0, 0, 0, 0, 8, 0), "sites"),     # an output off 16 bytes
    (512, (0, 0, 0, 0, 0, 12), "sites"),    # outbar off 16 bytes
    (512, (16, 32, 48, 64, 80, 96), "tiled"),  # offsets of whole 16 bytes
    (1, (0, 0, 0, 0, 0, 0), "sites"),       # one site per sample
    (2, (0, 0, 0, 0, 0, 0), "sites"),
    (6, (0, 0, 0, 0, 0, 0), "sites"),
    (8, (0, 0, 0, 0, 0, 0), "tiled"),
    (128, (0, 0, 0, 0, 0, 0), "tiled"),     # one whole tile
    (132, (0, 0, 0, 0, 0, 0), "tiled"),     # a last tile of 4 sites
    (1024, (0, 0, 4, 4, 0, 0), "sites"),    # the cotangents off 16 bytes
    # channels-last, (B, S): the tiles cut the batch's one run of B S sites
    ((512, 1024), (0, 0, 0, 0, 0, 0), "tiled"),  # the flagship unpacked
    ((512, 512), (0, 0, 0, 0, 0, 0), "tiled"),   # and packed
    ((2, 66), (0, 0, 0, 0, 0, 0), "tiled"),  # a last tile of 4, S % 4 != 0
    ((3, 7), (0, 0, 0, 0, 0, 0), "sites"),   # B S % 4 == 1
    ((2, 7), (0, 0, 0, 0, 0, 0), "sites"),   # B S % 4 == 2
    ((5, 7), (0, 0, 0, 0, 0, 0), "sites"),   # B S % 4 == 3
    ((4, 35), (0, 0, 0, 0, 0, 0), "tiled"),  # B S % 4 == 0, S % 4 != 0
    ((512, 512), (0, 4, 0, 0, 0, 0), "sites"),   # out off 16 bytes
    ((512, 512), (0, 0, 0, 0, 0, 12), "sites"),  # outbar off 16 bytes
    ((512, 512), (0, 0, 8, 0, 0, 0), "sites"),   # ybar off 16 bytes
    ((512, 512), (0, 0, 0, 4, 0, 0), "sites"),   # loggbar off 16 bytes
    ((512, 512), (0, 0, 0, 0, 8, 0), "sites"),   # xbar off 16 bytes
    ((512, 512), (4, 0, 0, 0, 0, 0), "sites"),   # x off 16 bytes
    ((512, 512), (16, 32, 48, 64, 80, 96), "tiled"),
    ((512, 1), (0, 0, 0, 0, 0, 0), "sites"),  # one site: NCHW, S % 4 != 0
])
def test_bwd_variant_by_shape_and_alignment(s, offsets, variant):
    ptrs = [(1 << 20) + 512 * k + o for k, o in enumerate(offsets)]
    assert _variant(s, ptrs) == variant


@pytest.mark.parametrize("s,offsets,variant", [
    (512, (0, 0, 0, 0), "tiled"),        # the flagship's 32x16 sites
    (132, (0, 0, 0, 0), "tiled"),        # a last tile of 4 sites
    (4, (0, 0, 0, 0), "tiled"),
    (35, (0, 0, 0, 0), "sites"),         # S % 4 != 0
    (510, (0, 0, 0, 0), "sites"),
    (1, (0, 0, 0, 0), "sites"),
    (512, (4, 0, 0, 0), "sites"),        # x off 16 bytes
    (512, (0, 8, 0, 0), "sites"),        # out off 16 bytes
    (512, (0, 0, 12, 0), "sites"),       # y off 16 bytes
    (512, (0, 0, 0, 4), "sites"),        # logg off 16 bytes
    (512, (16, 32, 48, 64), "tiled"),    # offsets of whole 16 bytes
    # channels-last, (B, S)
    ((1024, 512), (0, 0, 0, 0), "tiled"),   # the flagship's sampling batch
    ((512, 1024), (0, 0, 0, 0), "tiled"),
    ((2, 130), (0, 0, 0, 0), "tiled"),      # a last tile of 4, S % 4 != 0
    ((3, 7), (0, 0, 0, 0), "sites"),        # B S % 4 == 1
    ((2, 7), (0, 0, 0, 0), "sites"),        # B S % 4 == 2
    ((5, 7), (0, 0, 0, 0), "sites"),        # B S % 4 == 3
    ((1024, 512), (4, 0, 0, 0), "sites"),   # x off 16 bytes
    ((1024, 512), (0, 8, 0, 0), "sites"),   # out off 16 bytes
    ((1024, 512), (0, 0, 12, 0), "sites"),  # y off 16 bytes
    ((1024, 512), (0, 0, 0, 4), "sites"),   # logg off 16 bytes
    ((1024, 1), (0, 0, 0, 0), "sites"),     # one site: NCHW, S % 4 != 0
])
def test_forward_variant_by_shape_and_alignment(s, offsets, variant):
    """The forward takes the backward's rule over its four tensors (x,
    out, y, logg)."""
    ptrs = [(1 << 20) + 512 * k + o for k, o in enumerate(offsets)]
    assert _variant(s, ptrs) == variant


@pytest.mark.parametrize("lat,plan", [
    ((32, 32), (256, 1)), ((16, 16), (64, 4)), ((1, 128), (32, 8)),
    ((64, 64), (1024, 1)), ((8, 16), (32, 8)), ((128, 64), None),
    ((8, 8), None), ((5, 7), None), ((6, 30), None), ((64,), None),
    ((4, 4, 4), None), ((1,), None),
])
def test_action_plan(lat, plan):
    assert phi4.action_plan(lat) == plan
    if plan is not None:
        groups, samples = plan
        assert groups * 4 == lat[0] * lat[1] and groups % 32 == 0
        assert groups * samples <= 1024


@pytest.mark.parametrize("lat,ptr,variant", [
    ((32, 32), 1 << 20, "tiled"), ((32, 32), (1 << 20) + 4, "general"),
    ((32, 32), (1 << 20) + 16, "tiled"), ((5, 7), 1 << 20, "general"),
    ((1,), 1 << 20, "general"), ((4, 4, 4), 1 << 20, "general"),
    ((16, 16), (1 << 20) + 8, "general"), ((16, 16), (1 << 20) + 32, "tiled"),
    ((64,), 1 << 20, "general"), ((6, 30), 1 << 20, "general"),
])
def test_action_variant(lat, ptr, variant):
    assert phi4.action_variant(lat, ptr) == variant


@pytest.mark.parametrize("lat,offsets,variant", [
    ((32, 32), (0, 0), "tiled"),          # the flagship's training field
    ((128, 1), (0, 0), "general"),        # the zero-dim fit's one site
    ((1,), (0, 0), "general"),
    ((64,), (0, 0), "general"),           # 1-D
    ((8, 8, 8), (0, 0), "tiled_nd"),      # 3-D: the tiled nd kernels
    ((6, 30), (0, 0), "general"),         # L1 % 4 != 0
    ((8, 8), (0, 0), "general"),          # 16 float4s: not a warp
    ((32, 32), (4, 0), "general"),        # the field off 16 bytes
    ((32, 32), (0, 8), "general"),        # the force off 16 bytes
    ((16, 16), (32, 64), "tiled"),
])
def test_grad_variant(lat, offsets, variant):
    """The gradient takes the action's rule over the field and the
    force."""
    ptrs = [(1 << 20) + 4096 * k + o for k, o in enumerate(offsets)]
    assert phi4.action_variant(lat, *ptrs) == variant


@pytest.mark.parametrize("lat,plan", [
    ((8, 8, 8, 8), (1024, 256, (128, 16, 2))),  # the 8^4 flagship: 4 a thread
    ((4, 4, 4, 4), (64, 64, (16, 4, 1))),       # the free field's 4^4
    ((8, 8, 8), (128, 128, (16, 2))),           # the 3-D route flagship
    ((8, 8, 16), (256, 256, (32, 4))),
    ((16, 16, 16), (1024, 256, (64, 4))),
    ((1, 64, 64), (1024, 1024, (1024, 16))),    # one row on axis 0
    ((3, 8, 16), (96, 96, (32, 4))),            # 3 rows of a warp
    ((6, 4, 4, 8), (192, 192, (32, 8, 2))),     # no 256 divides 192
    ((12, 8, 8, 8), None),                      # 1536 float4s
    ((3, 5, 4, 6), None),                       # the last extent 6
    ((8, 8, 6), None),
    ((4, 4, 4), None),                          # 16 float4s: no whole warp
    ((16, 16, 16, 16), None),                   # 16384 float4s: no block
    ((8, 8, 8, 0), None), ((32, 32), None), ((64,), None),
    ((2, 2, 2, 2, 8), None),                    # 5-D
])
def test_action_plan_nd(lat, plan):
    """The tile of the tiled nd kernels: a block's threads are a whole
    number of warps, divide the groups, and are a multiple of axis 0's
    float4 stride, so a thread's groups differ in their first coordinate
    alone."""
    assert phi4.action_plan_nd(lat) == plan
    if plan is not None:
        groups, threads, strides = plan
        assert threads % 32 == 0 and groups % threads == 0
        assert threads % strides[0] == 0 and threads <= 1024


def _tile_neighbours(lat, slab=False):
    """Per site of ``lat``, the flat indices of its backward and forward
    neighbours along each axis, as the tiled nd kernels reach them
    (``nd_site`` and the kernels' loops in ``csrc/phi4_action.cu``): each
    thread's first group's coordinates from its index by a division and a
    modulo per axis, the offsets of its neighbour groups along axes 1 ..
    nd-2 (float4 strides of :func:`phi4.action_plan_nd`, with the wrap) and
    of the sites left of a group's first site and right of its last, the
    same for all the thread's groups, ``threads`` apart; along axis 0 a
    group's neighbours one stride away, the wrap tested on its first
    coordinate, ``threads // stride`` more for each later group; along the
    last axis the group's own sites between.  On a ``slab``
    (:func:`phi4.slab_plan_nd`), indices into the ring stage, halo row 0,
    the slab's rows, halo row 1: the sites one stride in, axis 0's
    neighbours one stride away with no wrap."""
    groups, threads, strides = phi4.action_plan_nd(lat)
    nd, q, big = len(lat), lat[-1] // 4, lat[-1]
    s0, j = strides[0], threads // strides[0]
    t = np.arange(threads)
    rest, cq = t // q, t % q
    dn, up, stride = [None] * nd, [None] * nd, q
    for mu in range(nd - 2, 0, -1):
        c, rest = rest % lat[mu], rest // lat[mu]
        assert stride == strides[mu]
        wrap = (lat[mu] - 1) * stride
        dn[mu] = np.where(c == 0, wrap, -stride)
        up[mu] = np.where(c == lat[mu] - 1, -wrap, stride)
        stride *= lat[mu]
    assert stride == s0
    c0 = rest
    left = np.where(cq == 0, big - 1, -1)
    right = np.where(cq == q - 1, 4 - big, 4)
    back = [np.zeros(groups * 4, int) for _ in range(nd)]
    fore = [np.zeros(groups * 4, int) for _ in range(nd)]
    k = np.arange(4)
    for m in range(groups // threads):
        g, c0m = t + m * threads, c0 + m * j
        wrap0 = (lat[0] - 1) * s0
        axis0 = ((g - s0, g + s0) if slab else
                 (np.where(c0m == 0, g + wrap0, g - s0),
                  np.where(c0m == lat[0] - 1, g - wrap0, g + s0)))
        sites = (4 * g[:, None] + k).ravel()
        for mu in range(nd - 1):
            d, u = axis0 if mu == 0 else (g + dn[mu], g + up[mu])
            back[mu][sites] = (4 * d[:, None] + k).ravel()
            fore[mu][sites] = (4 * u[:, None] + k).ravel()
        own = 4 * g[:, None] + k
        back[nd - 1][sites] = np.where(k == 0, (4 * g + left)[:, None],
                                       own - 1).ravel()
        fore[nd - 1][sites] = np.where(k == 3, (4 * g + right)[:, None],
                                       own + 1).ravel()
    if slab:  # the stage's first s0 float4s are halo row 0
        return [b + 4 * s0 for b in back], [f + 4 * s0 for f in fore]
    return back, fore


@pytest.mark.parametrize("lat", [(8, 8, 8, 8), (4, 4, 4, 4), (8, 8, 8),
                                 (8, 8, 16), (16, 16, 16), (4, 8, 2, 12),
                                 (2, 4, 16), (1, 64, 64), (3, 8, 16),
                                 (6, 4, 4, 8)])
def test_tile_nd_neighbours_are_the_rolls(lat):
    """For every site, the neighbours the tiled nd kernels read are
    ``np.roll``'s: ``roll(phi, 1, mu)`` backward, ``roll(phi, -1, mu)``
    forward, on each axis."""
    idx = np.arange(int(np.prod(lat))).reshape(lat)
    back, fore = _tile_neighbours(lat)
    for mu in range(len(lat)):
        np.testing.assert_array_equal(back[mu],
                                      np.roll(idx, 1, mu).ravel())
        np.testing.assert_array_equal(fore[mu],
                                      np.roll(idx, -1, mu).ravel())


@pytest.mark.parametrize("lat,offsets,force,action", [
    ((8, 8, 8, 8), (0, 0), "tiled_nd", "tiled_nd"),  # the 8^4 flagship's
    ((8, 8, 8, 8), (4, 0), "general", "general"),    # field off 16 bytes
    ((8, 8, 8, 8), (0, 8), "general", "tiled_nd"),   # force off 16 bytes
    ((8, 8, 8, 8), (16, 48), "tiled_nd", "tiled_nd"),  # whole 16 bytes off
    ((8, 8, 8), (0, 0), "tiled_nd", "tiled_nd"),
    ((8, 8, 8), (12, 0), "general", "general"),
    ((4, 4, 4, 4), (0, 0), "tiled_nd", "tiled_nd"),
    ((3, 5, 4, 6), (0, 0), "general", "general"),    # the odd check's
    ((16, 16, 16, 16), (0, 0), "general", "general"),
    ((32, 32), (0, 0), "tiled", "tiled"),            # 2-D keeps its tile
])
def test_action_variant_nd(lat, offsets, force, action):
    """The force's variant on the field and the force, the action's on
    the field alone."""
    ptrs = [(1 << 20) + 4096 * k + o for k, o in enumerate(offsets)]
    assert phi4.action_variant(lat, *ptrs) == force
    assert phi4.action_variant(lat, ptrs[0]) == action


@pytest.mark.parametrize("lat,offsets,variant", [
    ((4, 8, 8, 8), (0, 0, 0), "tiled_nd"),   # half the 8^4 lattice
    ((3, 8, 8, 8), (0, 0, 0), "tiled_nd"),   # 8 rows over three ranks
    ((4, 8, 8, 8), (0, 4, 0), "general"),    # its halo off 16 bytes
    ((4, 8, 8, 8), (0, 0, 8), "general"),    # the force off 16 bytes
    ((4, 8, 8, 8), (4, 0, 0), "general"),    # the slab off 16 bytes
    ((2, 8, 8), (0, 0, 0), "tiled_nd"),      # a 3-D slab
    ((4, 4, 4, 4), (0, 0, 0), "tiled_nd"),
    ((3, 5, 4, 6), (0, 0, 0), "general"),    # the odd check's slab
    ((2, 4, 4, 4), (0, 0, 0), "tiled_nd"),   # 32 float4s: one warp
    ((2, 4, 4, 2), (0, 0, 0), "general"),    # the last extent 2
    ((16, 32), (0, 0, 0), "tiled"),          # the 2-D flagship's slab
    ((16, 32), (0, 4, 0), "general"),        # its halo off 16 bytes
    ((11, 32), (0, 0, 0), "general"),        # 88 float4s: no whole warp
])
def test_slab_variant_stays_two_dimensional(lat, offsets, variant):
    """The slab wrappers take the whole lattice's rules on the slab's
    extents: the 2-D tile for 2-D slabs, the tiled nd kernels at 3-D and
    4-D (:func:`phi4.slab_plan_nd`), the general slab kernels for other
    extents and for any address off 16 bytes."""
    ptrs = [(1 << 20) + 4096 * k + o for k, o in enumerate(offsets)]
    assert phi4.slab_variant(lat, *ptrs) == variant


@pytest.mark.parametrize("lat,plan", [
    ((4, 8, 8, 8), (512, 256, (128, 16, 2), 768)),   # half of 8^4: 2 each
    ((3, 8, 8, 8), (384, 384, (128, 16, 2), 640)),   # 8 rows over 3 ranks
    ((2, 8, 8, 8), (256, 256, (128, 16, 2), 512)),   # their last slab
    ((1, 8, 8, 8), (128, 128, (128, 16, 2), 384)),   # 8 rows over 8 ranks
    ((4, 8, 8), (64, 64, (16, 2), 96)),              # half of 8^3
    ((8, 8, 16), (256, 256, (32, 4), 320)),
    ((3, 5, 4, 6), None),                            # the last extent 6
    ((4, 4, 4), None),                               # 16 float4s
    ((12, 8, 8, 8), None),                           # 1536 float4s
    ((0, 8, 8, 8), None),                            # an empty slab
    ((16, 32), None), ((64,), None),                 # 2-D and 1-D slabs
])
def test_slab_plan_nd(lat, plan):
    """The tiled nd slab kernels' tile is the whole lattice's on the
    slab's extents, with a ring stage of the halo row before, the slab's
    rows and the halo row after."""
    assert phi4.slab_plan_nd(lat) == plan
    if plan is not None:
        assert plan[:3] == phi4.action_plan_nd(lat)
        assert plan[3] == plan[0] + 2 * plan[2][0]


@pytest.mark.parametrize("lat", [(4, 8, 8, 8), (3, 8, 8, 8), (1, 8, 8, 8),
                                 (4, 8, 8), (2, 8, 16), (3, 4, 4, 8),
                                 (2, 4, 16)])
def test_slab_tile_neighbours_are_the_rolls_and_the_halo(lat):
    """For every site of a slab, the neighbours the tiled nd slab kernels
    read from the ring stage (halo row 0, the slab, halo row 1) are the
    slab's ``np.roll`` on the periodic axes and, along axis 0, the row
    before and after, which across the slab's edges are the halo rows."""
    ext = np.arange(4 * phi4.slab_plan_nd(lat)[3]).reshape(
        (lat[0] + 2, *lat[1:]))
    back, fore = _tile_neighbours(lat, slab=True)
    np.testing.assert_array_equal(back[0], ext[:-2].ravel())
    np.testing.assert_array_equal(fore[0], ext[2:].ravel())
    for mu in range(1, len(lat)):
        np.testing.assert_array_equal(
            back[mu], np.roll(ext, 1, mu)[1:-1].ravel())
        np.testing.assert_array_equal(
            fore[mu], np.roll(ext, -1, mu)[1:-1].ravel())


@pytest.mark.parametrize("name,shape,nbytes", [
    ("rqs_coupling", (1024, 22, 32, 16), 1024 * 512 * 4 * 25),
    ("rqs_coupling_bwd", (512, 22, 32, 16), 512 * 512 * 4 * 48),
    ("phi4_action", (1024, 32, 32), 1024 * 1024 * 4 + 1024 * 4),
    ("phi4_action_grad", (512, 32, 32), 512 * 1024 * 8 + 512 * 4),
    # a chain round: lrand, logqp, a bool and an int64 index a proposal,
    # and the reference
    ("accept_scan", (1024,), 1024 * 17 + 4),
    ("accept_scan", (10000,), 10000 * 17 + 4),
    # the tiled nd kernels at the 8^4 flagship's batch and step and at 3-D:
    # their wrappers' work
    ("phi4_action_tiled_nd", (1024, 8, 8, 8, 8), 1024 * 4096 * 4 + 1024 * 4),
    ("phi4_action_grad_tiled_nd", (512, 8, 8, 8, 8),
     512 * 4096 * 8 + 512 * 4),
    ("phi4_action_tiled_nd", (1024, 8, 8, 8), 1024 * 512 * 4 + 1024 * 4),
    ("phi4_action", (512, 8, 8, 8, 8), 512 * 4096 * 4 + 512 * 4),
    ("phi4_action_grad_tiled_nd", (1024, 8, 8, 8),
     1024 * 512 * 8 + 1024 * 4),
    # the tiled nd slab kernels on half the 8^4 lattice: the action reads
    # the slab and halo row 0, the force the slab and both halo rows
    ("phi4_action_slab_tiled_nd", (1024, 4, 8, 8, 8),
     1024 * 5 * 512 * 4 + 1024 * 4),
    ("phi4_action_slab_grad_tiled_nd", (1024, 4, 8, 8, 8),
     1024 * (2 * 4 + 2) * 512 * 4 + 1024 * 4),
    ("phi4_action_slab_tiled_nd", (1024, 3, 8, 8, 8),
     1024 * 4 * 512 * 4 + 1024 * 4),
])
def test_kernel_bytes_and_bound(name, shape, nbytes):
    got, nops = kt.work(name, shape)
    assert got == nbytes and nops > 0
    peaks = kt.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == (3.35e12, 67e12)
    ms, by = kt.bound_ms(got, nops, peaks)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def test_card_peaks_refuses_an_unknown_card():
    assert kt.card_peaks("NVIDIA H100 PCIe")[0] == 2.0e12
    with pytest.raises(RuntimeError, match="no published peaks"):
        kt.card_peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("kernel,name,hit", [
    ("rqs_coupling", "void (anonymous namespace)::rqs_coupling_kernel<8, "
     "true, true, false>(float const*)", True),
    ("rqs_coupling", "void (anonymous namespace)::rqs_coupling_bwd_kernel"
     "<8, true, true, false>(float const*)", False),
    ("rqs_coupling_bwd", "void (anonymous namespace)::"
     "rqs_coupling_bwd_tiled_kernel<8, true, true, true>(float const*)",
     True),
    ("rqs_coupling_bwd", "rqs_coupling_bwd_kernel<4, false, false, false>",
     True),
    ("phi4_action", "(anonymous namespace)::phi4_action_tiled_kernel(float "
     "const*, float*, long long, int, int, float, float, float)", True),
    ("phi4_action", "phi4_action_kernel(float const*)", True),
    ("phi4_action", "phi4_action_grad_kernel(float const*)", False),
    ("phi4_action_grad", "phi4_action_grad_kernel(float const*)", True),
    ("rqs_coupling", "void (anonymous namespace)::rqs_coupling_tiled_kernel"
     "<8, true, true, true>(float const*)", True),
    ("rqs_coupling", "void (anonymous namespace)::"
     "rqs_coupling_bwd_tiled_kernel<8, true, true, false>(float const*)",
     False),
    ("rqs_coupling_bwd", "void (anonymous namespace)::"
     "rqs_coupling_tiled_kernel<8, true, true, false>(float const*)", False),
    ("rqs_coupling_bwd", "rqs_coupling_kernel<8, true, true, false>", False),
    ("phi4_action_grad", "(anonymous namespace)::"
     "phi4_action_grad_tiled_kernel(float const*, float const*, float*, "
     "long long, int, int, float, float, float)", True),
    ("phi4_action", "(anonymous namespace)::phi4_action_grad_tiled_kernel("
     "float const*)", False),
    ("accept_scan", "(anonymous namespace)::accept_scan_kernel(float "
     "const*, float const*, float const*, unsigned char*, long long*, long "
     "long)", True),
    ("accept_scan", "accept_scan_plain_kernel(float const*)", False),
    ("phi4_action", "(anonymous namespace)::accept_scan_kernel(float "
     "const*)", False),
    ("phi4_action_grad", "(anonymous namespace)::phi4_action_tiled_kernel("
     "float const*)", False),
    # the tiled nd kernels, each for its own wrapper
    ("phi4_action", "void (anonymous namespace)::phi4_action_tiled_nd_kernel"
     "<4>(float const*, float*, long long, (anonymous namespace)::Extents, "
     "float, float, float)", True),
    ("phi4_action", "void (anonymous namespace)::"
     "phi4_action_grad_tiled_nd_kernel<4>(float const*)", False),
    ("phi4_action_grad", "void (anonymous namespace)::"
     "phi4_action_grad_tiled_nd_kernel<3>(float const*, float const*, "
     "float*, long long, (anonymous namespace)::Extents, float, float, "
     "float)", True),
    ("phi4_action_grad", "void (anonymous namespace)::"
     "phi4_action_tiled_nd_kernel<3>(float const*)", False),
    ("phi4_action", "phi4_action_slab_kernel(float const*)", False),
    # the slab kernels, each for its own wrapper, every variant
    ("phi4_action_slab", "void (anonymous namespace)::"
     "phi4_action_slab_tiled_nd_kernel<4>(float const*, float const*, "
     "float*, long long, (anonymous namespace)::NdTile, float, float, "
     "float)", True),
    ("phi4_action_slab", "(anonymous namespace)::phi4_action_slab_kernel("
     "float const*)", True),
    ("phi4_action_slab", "(anonymous namespace)::"
     "phi4_action_slab_tiled_kernel(float const*)", True),
    ("phi4_action_slab", "void (anonymous namespace)::"
     "phi4_action_grad_slab_tiled_nd_kernel<4>(float const*)", False),
    ("phi4_action_slab_grad", "void (anonymous namespace)::"
     "phi4_action_grad_slab_tiled_nd_kernel<3>(float const*)", True),
    ("phi4_action_slab_grad", "(anonymous namespace)::"
     "phi4_action_grad_slab_kernel(float const*)", True),
    ("phi4_action_slab_grad", "void (anonymous namespace)::"
     "phi4_action_slab_tiled_nd_kernel<4>(float const*)", False),
    ("phi4_action_grad", "void (anonymous namespace)::"
     "phi4_action_grad_slab_tiled_nd_kernel<4>(float const*)", False),
    ("phi4_action", "void (anonymous namespace)::"
     "phi4_action_slab_tiled_nd_kernel<4>(float const*)", False),
])
def test_profiler_names_pick_each_kernel(kernel, name, hit):
    import re

    assert bool(re.search(kt.KERNEL_RE[kernel], name)) is hit


@pytest.mark.parametrize("name,tiled", [
    ("void (anonymous namespace)::phi4_action_tiled_nd_kernel<4>(float "
     "const*)", True),
    ("(anonymous namespace)::phi4_action_tiled_kernel(float const*)", True),
    ("phi4_action_kernel(float const*)", False),
])
def test_profiler_counts_the_tiled_nd_action_as_tiled(name, tiled):
    """:func:`kt.device_launches` counts a launch as tiled where the
    pattern's group matched: the tiled nd kernels count as tiled."""
    import re

    m = re.search(kt.KERNEL_RE["phi4_action"], name)
    assert (m.group(1) is not None) is tiled


def _saved(tmp_path, label, bwd_bits=0, action_rel=0.0):
    gen = torch.Generator().manual_seed(3)
    out = {"card": "cpu"}
    for case in ("rqs_coupling", "rqs_coupling_bwd forward",
                 "rqs_coupling_bwd inverse", "phi4_action_grad"):
        out[case] = [torch.randn(4, 8, generator=gen),
                     torch.randn(4, generator=gen)]
    out["phi4_action"] = [torch.randn(16, generator=gen) * 100]
    out["rqs_coupling_bwd inverse"][0].view(torch.int32)[0, 0] += bwd_bits
    out["phi4_action"][0] *= 1 + action_rel
    path = tmp_path / f"{label}.pt"
    torch.save(out, path)
    return str(path)


@pytest.mark.parametrize("bwd_bits,action_rel,rc", [
    (0, 0.0, 0), (0, 1e-6, 0), (1, 0.0, 1), (0, 3e-5, 1),
])
def test_compare_holds_bits_and_the_action_bar(tmp_path, capsys, bwd_bits,
                                               action_rel, rc):
    """One ulp in a backward output fails; the action passes within 2e-5
    relative and fails beyond."""
    a = _saved(tmp_path, "a")
    b = _saved(tmp_path, "b", bwd_bits, action_rel)
    assert kt.compare(a, b) == rc
    assert ("FAILED" in capsys.readouterr().out) is bool(rc)


@pytest.mark.parametrize("action_rel,force_bits,rc", [
    (0.0, 0, 0), (1e-6, 0, 0), (3e-5, 0, 1), (0.0, 1, 1)])
def test_compare_holds_the_slab_action_to_the_bar(tmp_path, action_rel,
                                                  force_bits, rc):
    """The slab action, whose tiled nd kernel sums in another order than
    the general one, is held to the action's bar; the slab force bit for
    bit."""
    gen = torch.Generator().manual_seed(5)
    paths = []
    for label in ("a", "b"):
        act = torch.randn(16, generator=gen.manual_seed(5)) * 100
        force = torch.randn(4, 8, generator=gen)
        if label == "b":
            act *= 1 + action_rel
            force.view(torch.int32)[0, 0] += force_bits
        paths.append(str(tmp_path / f"{label}.pt"))
        torch.save({"card": "cpu",
                    "phi4_action_slab (1024, 4, 8, 8, 8)": [act],
                    "phi4_action_slab_grad (1024, 4, 8, 8, 8)": [force]},
                   paths[-1])
    assert kt.compare(*paths) == rc


@pytest.mark.parametrize("flip,rc", [(None, 0), ("accept", 1),
                                      ("indices", 1)])
def test_compare_holds_scan_outputs_bit_for_bit(tmp_path, flip, rc):
    """``accept_scan``'s bool accepts and int64 indices compare exactly."""
    paths = []
    for label in ("a", "b"):
        acc = torch.arange(64) % 3 == 0
        idx = torch.cummax(torch.where(acc, torch.arange(1, 65), 0), 0)[0]
        if label == "b" and flip == "accept":
            acc[5] = ~acc[5]
        if label == "b" and flip == "indices":
            idx[7] += 1
        out = {"card": "cpu", "accept_scan n=64": [acc, idx]}
        paths.append(str(tmp_path / f"{label}.pt"))
        torch.save(out, paths[-1])
    assert kt.compare(*paths) == rc


_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119rqs_coupling_kernelILi8ELb1ELb1ELb0EEEvPKf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/                   LDG.E.CONSTANT R2, desc[UR6][R4.64] ;   /* 0x0000000604027981 */
        /*0030*/              @!P0 BRA 0x50 ;                              /* 0x0000000000008947 */
        /*0040*/                   FADD R2, R2, R2 ;                       /* 0x0000000202027221 */
        /*0050*/                   STG.E desc[UR6][R6.64], R2 ;            /* 0x0000000206007986 */
        /*0060*/                   EXIT ;                                  /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                               /* 0xfffffffc00fc7947 */
        /*0080*/                   NOP;                                    /* 0x0000000000007918 */
		..........

		Function : _ZN12_GLOBAL__N_129phi4_action_grad_tiled_kernelEPKfS1_Pf
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                                  /* 0x000000000000794d */
        /*0020*/                   BRA 0x20;                               /* 0xfffffffc00fc7947 */
"""


def test_parse_sass_counts_each_function():
    """Instructions per device function, and those from the first load to
    the last store; the encoding lines, the padding NOPs and the closing
    branch to itself do not count, a predicated branch elsewhere does."""
    counts = kt.parse_sass(_SASS)
    assert counts == {
        "_ZN12_GLOBAL__N_119rqs_coupling_kernelILi8ELb1ELb1ELb0EEEvPKf":
            (7, 4),
        "_ZN12_GLOBAL__N_129phi4_action_grad_tiled_kernelEPKfS1_Pf": (2, 0)}


@pytest.mark.parametrize("threads,instructions,ms", [
    (1024 * 512, 1000, 1024 * 512 / 32 * 1000 / (132 * 4 * 1980e3)),
    (32, 1, 1 / (132 * 4 * 1980e3)),
])
def test_issue_ms(threads, instructions, ms):
    """One warp instruction per clock per scheduler, 4 schedulers per SM."""
    assert kt.issue_ms(threads, instructions, 132, 1980) == pytest.approx(ms)


_SOURCE = """constexpr int kTileSites = 256;  // sites per tile
constexpr int kStages = 2;
constexpr bool kFlag = false;
"""


@pytest.mark.parametrize("spec,want", [
    ("base", _SOURCE),
    ("kStages=3", _SOURCE.replace("kStages = 2", "kStages = 3")),
    ("kTileSites=128,kFlag=true",
     _SOURCE.replace("256;", "128;").replace("false", "true")),
])
def test_const_sweep_sets_constants(spec, want):
    from normflow__tpu_torch.tools import const_sweep

    assert const_sweep.edit(_SOURCE, spec) == want


def test_const_sweep_refuses_an_unknown_constant():
    from normflow__tpu_torch.tools import const_sweep

    with pytest.raises(ValueError, match="kRing"):
        const_sweep.edit(_SOURCE, "kRing=3")


def test_const_sweep_reads_registers_of_the_flagship_instances():
    """The registers and spill bytes ptxas reports for the m = 8, linear
    instances compiled from the swept source, and for no other."""
    from normflow__tpu_torch.tools import const_sweep

    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1_15_"
        f"{unit}_cu_2{name}ILi{m}ELb1ELb1ELb{inv}EEEvPKf' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes "
        f"spill loads\nptxas info    : Used {regs} registers"
        for unit, name, m, inv, spill, regs in (
            ("rqs_coupling", "5rqs_coupling_tiled_kernel", 8, 0, 0, 50),
            ("rqs_coupling", "5rqs_coupling_tiled_kernel", 8, 1, 8, 54),
            ("rqs_coupling", "5rqs_coupling_tiled_kernel", 4, 0, 0, 40),
            ("rqs_coupling_bwd", "9rqs_coupling_bwd_kernel", 8, 0, 0, 80)))
    rows = const_sweep.registers(log, "rqs_coupling.cu")
    assert [(r, s) for _, r, s in rows] == [(50, 0), (54, 8)]


def test_window_body_reads_past_a_tail():
    """A window closes with ``tail`` one-element kernels after its closing
    marker: the body lies between the markers and what the tail lost is
    kept; a window that lost its closing marker counts all but the last
    ``tail`` activities after its opening one, so a tail lost in part
    leaves the body short rather than long; one marker followed by no more
    than ``tail`` activities raises."""
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    head = [(t, "add", 1.0) for t in range(3)]
    body = [(5, "rqs_coupling_tiled_kernel", 2.0), (6, "add", 3.0)]
    tail = [(t, "add", 1.0) for t in range(8, 12)]
    want = [(n, us) for _, n, us in body]
    full = head + [(4, mark, 1.0)] + body + [(7, mark, 1.0)] + tail
    assert kt.window_body(full, len(tail)) == want
    assert kt.TAIL_LOSSES[-1] == 0
    assert kt.window_body(full[:-3], len(tail)) == want
    assert kt.TAIL_LOSSES[-1] == 3
    closes = len(kt.CLOSE_LOSSES)
    lost = head + [(4, mark, 1.0)] + body + tail
    assert kt.window_body(lost, len(tail)) == want
    assert kt.window_body(lost[:-1], len(tail)) == want[:1]
    assert len(kt.CLOSE_LOSSES) == closes + 2
    for opening_lost in (head + body + [(7, mark, 1.0)] + tail, lost[:-2]):
        with pytest.raises(RuntimeError, match="marker kernels"):
            kt.window_body(opening_lost, len(tail))
