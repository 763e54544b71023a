"""Port parity of the scalar flow zoo, module by module, on the CPU.

Masks, couplings, the core containers, the lattice ops and the rest of the
phi^4 action here; the elementwise flows, spline ops and spectral flows in
``test_torch_flow_zoo_elementwise.py``, the nets in
``test_torch_flow_zoo_nets.py``, which use this file's helpers.  Each JAX
module is built, its leaves are perturbed with seeded numpy noise
(a fresh flow has zero spline weights) and go into the JAX module and,
through ``load_jax_leaves``, into its port.  Forward and inverse, the
log-Jacobian summed and as a density, and the parameter gradients of a
seeded scalar of both outputs agree to 1e-10 in float64; the masks'
``split``, ``cat`` and ``purify`` agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models import actions as ja
from normflow__tpu.models import core as jco
from normflow__tpu.models import couplings as jc
from normflow__tpu.models import elementwise as je
from normflow__tpu.models import masks as jm
from normflow__tpu.models import nets as jn
from normflow__tpu.ops import lattice as jl
from normflow__tpu.utils.serialization import leaves_of
from normflow__tpu_torch.models import actions as ta
from normflow__tpu_torch.models import core as tco
from normflow__tpu_torch.models import couplings as tc
from normflow__tpu_torch.models import elementwise as te
from normflow__tpu_torch.models import masks as tm
from normflow__tpu_torch.models import nets as tn
from normflow__tpu_torch.ops import lattice as tl
from normflow__tpu_torch.ops.kernels.spline_coupling import SUPPORTED_KNOTS
from normflow__tpu_torch.utils.transplant import jax_leaf_grads
from test_torch_modules import transplant

TOL = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")
KEY = jax.random.key(7)
LAT = (6, 4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


DIRECTIONS = ("forward", "backward")


def _jax_both_ways(flow, x, cys, cls):
    """Both directions of a JAX flow in one program, compiled at XLA's
    lowest backend optimisation level, which compiles several times faster
    (each case runs once): for each direction ``(y, logJ)``, ``(y, logJ
    density)`` and the gradients of ``sum(y cy) + sum(logJ cl)``."""
    args = (flow, x, cys, cls)
    return jax.jit(_both_ways).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _both_ways(flow, x, cys, cls):
    out = []
    for direction, cy, cl in zip(DIRECTIONS, cys, cls):
        def run(f, density=False, direction=direction):
            return getattr(f, direction)(x, density=density)

        def scalar(f, cy=cy, cl=cl, run=run):
            y, logj = run(f)
            return jnp.sum(y * cy) + jnp.sum(logj * cl)

        out.append((run(flow), run(flow, True), jax.grad(scalar)(flow)))
    return out


def check_flow(jflow, tflow, x, rng, tol=TOL, directions=DIRECTIONS):
    """Forward and backward (or ``directions``), summed and density
    log-Jacobians, and the gradients of ``sum(y c) + sum(logJ c')`` in
    each direction."""
    has_params = any(p.requires_grad for p in tflow.parameters())
    with torch.no_grad():
        shapes = [getattr(tflow, d)(_t(x))[0].shape for d in DIRECTIONS]
    cys = [rng.standard_normal(s) for s in shapes]
    cls = [rng.standard_normal(x.shape[:1]) for _ in DIRECTIONS]
    results = _jax_both_ways(jflow, jnp.asarray(x), cys, cls)
    for direction, cy, cl, (*want, jgrads) in zip(DIRECTIONS, cys, cls,
                                                  results):
        if direction not in directions:
            continue
        tflow.zero_grad(set_to_none=True)
        for density, (jy, jlogj) in zip((False, True), want):
            ty, tlogj = getattr(tflow, direction)(_t(x), density=density)
            assert ty.shape == jy.shape and tlogj.shape == jlogj.shape
            np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                       rtol=0, atol=tol, err_msg=direction)
            np.testing.assert_allclose(tlogj.detach().numpy(),
                                       np.asarray(jlogj), rtol=0, atol=tol,
                                       err_msg=direction)
            if has_params and not density:
                (torch.sum(ty * _t(cy))
                 + torch.sum(tlogj * _t(cl))).backward()
        if has_params:
            got, want_g = jax_leaf_grads(tflow), leaves_of(jgrads)
            assert got.keys() == want_g.keys()
            for k in want_g:
                np.testing.assert_allclose(got[k], want_g[k], rtol=0,
                                           atol=tol,
                                           err_msg=f"{direction} leaf {k}")


# ----------------------------------------------------------------- masks
MASKS = {
    "even-odd": lambda m: m.EvenOddMask(shape=LAT),
    "even-odd parity 1": lambda m: m.EvenOddMask(shape=LAT, parity=1),
    "even-odd exclude_mu": lambda m: m.EvenOddMask(shape=LAT, exclude_mu=1),
    "along axes": lambda m: m.AlongAxesEvenOddMask(shape=LAT, mu=1,
                                                   parity=1),
    "dummy": lambda m: m.DummyMask(parity=1),
    "double": lambda m: m.GaugeLinksDoubleMask(shape=LAT, parity=1, mu=0),
    "zebra": lambda m: m.ZebraPlanarMask(mu=0, nu=1, parity=1, shape=LAT),
    "chunk-cat": lambda m: m.ChunkCatPartitioner(axis=2),
    "along-axis partitioner": lambda m: m.AlongAxisEvenOddPartitioner(
        axis=1),
}


@pytest.mark.parametrize("channels", [0, 2])
@pytest.mark.parametrize("name", list(MASKS))
def test_mask_split_cat_purify_bit_for_bit(rng, name, channels):
    """Also with two trailing channel axes, which the multiplicative masks
    broadcast over."""
    jmask, tmask = MASKS[name](jm), MASKS[name](tm)
    x = rng.standard_normal((3, *LAT) + (2,) * channels)
    jparts = jmask.split(jnp.asarray(x))
    tparts = tmask.split(_t(x))
    assert len(tparts) == len(jparts)
    for g, w in zip(tparts, jparts):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tmask.cat(*tparts).numpy(),
                                  np.asarray(jmask.cat(*jparts)))
    for channel in (0, 1):
        np.testing.assert_array_equal(
            tmask.purify(_t(x), channel=channel).numpy(),
            np.asarray(jmask.purify(jnp.asarray(x), channel=channel)))


def test_matrix_and_list_masks_bit_for_bit(rng):
    x = rng.standard_normal((2, *LAT, 2, 2))
    for kw in (dict(), dict(parity=1, anisotropic_dir=0)):
        jmask = jm.MatrixMask(lat_shape=LAT, **kw)
        tmask = tm.MatrixMask(lat_shape=LAT, **kw)
        jparts, tparts = jmask.split(jnp.asarray(x)), tmask.split(_t(x))
        for g, w in zip(tparts, jparts):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(tmask.cat(*tparts).numpy(),
                                      np.asarray(jmask.cat(*jparts)))
        for c in (0, 1):
            np.testing.assert_array_equal(
                tmask.purify(_t(x), c).numpy(),
                np.asarray(jmask.purify(jnp.asarray(x), c)))
    a, b = rng.standard_normal((2, 3)), rng.standard_normal((2, 5))
    parts = tm.ListPartitioner.split([_t(a), _t(b)])
    assert [p.numpy().tolist() for p in parts] == [a.tolist(), b.tolist()]
    assert tm.ListPartitioner.cat(*parts) == list(parts)
    assert tm.ZebraPlanarMask(mu=0, nu=0, parity=1, shape=(5, 4)).subshape \
        == jm.ZebraPlanarMask(mu=0, nu=0, parity=1, shape=(5, 4)).subshape


def test_mask_tensor_is_built_once_per_device_and_dtype(rng):
    mask = tm.EvenOddMask(shape=LAT)
    x = _t(rng.standard_normal((2, *LAT)))
    m1 = mask.split(x)[0]
    pair = mask._pair(x)
    mask.purify(x, channel=1)
    assert mask._pair(x) is pair and len(mask._cache) == 1
    mask.split(x.float())
    assert len(mask._cache) == 2
    np.testing.assert_array_equal(m1.numpy(), mask.split(x)[0].numpy())


# ------------------------------------------------------------- couplings
def _conv_pair(k, cin, cout, **kw):
    kw = dict(dict(conv_dim=2, hidden_sizes=(2,), acts=("tanh", None),
                   bias=True), **kw)
    return jn.ConvNet.build(k, cin, cout, 3, **kw), tn.ConvNet(cin, cout, 3,
                                                               **kw, **F64)


def _coupling_pair(jcls, tcls, n_out, mask_name, n_nets=2, jkw=None,
                   tkw=None, cin=1):
    pairs = [_conv_pair(k, cin, n_out)
             for k in jax.random.split(KEY, n_nets)]
    jflow = jcls([p[0] for p in pairs], mask=MASKS[mask_name](jm),
                 **(jkw or {}))
    tflow = tcls([p[1] for p in pairs], mask=MASKS[mask_name](tm),
                 **(tkw or {}))
    return jflow, tflow


@pytest.mark.parametrize("mask", ["even-odd", "double"])
@pytest.mark.parametrize("kind", ["shift", "affine"])
def test_shift_affine_couplings(rng, kind, mask):
    """``DoubleMask``'s invisible third partition goes through the
    coupling to ``cat``."""
    jcls, tcls = {"shift": (jc.ShiftCoupling, tc.ShiftCoupling),
                  "affine": (jc.AffineCoupling, tc.AffineCoupling)}[kind]
    jflow, tflow = _coupling_pair(
        lambda nets, mask: jcls(nets=tuple(nets), mask=mask), tcls, 2, mask)
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((4, *LAT)), rng)


def _fixed(m, lim):
    return np.sort(np.concatenate([[lim[0], lim[1]], np.linspace(
        lim[0], lim[1], m)[1:-1] + 0.1]))


BRANCHES = {  # fixed knots_x, knots_y -> channels of an m-knot net
    "free": (False, False, lambda m: 3 * m - 2),
    "fixed x": (True, False, lambda m: 2 * m - 1),
    "fixed y": (False, True, lambda m: 2 * m - 1),
    "fixed x and y": (True, True, lambda m: m),
}
EXTRAPS = {
    "none": ({}, lambda r, s: r.uniform(-1.9, 1.9, s)),
    "linear": ({"left": "linear", "right": "linear"},
               lambda r, s: r.standard_normal(s) * 2.0),
    "anti left": ({"left": "anti", "right": "linear"},
                  lambda r, s: r.uniform(-5.0, 3.0, s)),
    "anti-periodic": ({"left": "linear", "right": "anti-periodic"},
                      lambda r, s: r.uniform(-3.0, 5.0, s)),
    "anti both": ({"left": "anti", "right": "anti"},
                  lambda r, s: r.uniform(-5.0, 5.0, s)),
}
LIM = (-2.0, 2.0)


@pytest.mark.parametrize("branch,extrap", [
    ("free", "none"), ("free", "linear"), ("free", "anti-periodic"),
    ("fixed x", "linear"), ("fixed y", "anti left"),
    ("fixed x and y", "anti both")])
def test_rq_spline_coupling(rng, branch, extrap):
    """Each ``_knots_from_net_out`` branch and each extrapolation, on the
    multiplicative checkerboard (``EvenOddMask``): the fusable cases take
    the coupling kernel's wrapper, the others the plain spline."""
    m = 4
    fx, fy, n_out = BRANCHES[branch]
    e, draw = EXTRAPS[extrap]
    kw = dict(xlim=LIM, ylim=LIM, extrap=e,
              knots_x=_fixed(m, LIM) if fx else None,
              knots_y=_fixed(m, LIM) if fy else None)
    jflow, tflow = _coupling_pair(
        lambda nets, mask: jc.RQSplineCoupling.build(nets, mask=mask, **kw),
        tc.RQSplineCoupling, n_out(m), "even-odd", tkw=kw)
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, draw(rng, (3, *LAT)), rng)


def test_rq_spline_coupling_through_double_mask(rng):
    e = {"left": "linear", "right": "linear"}
    kw = dict(xlim=LIM, ylim=LIM, extrap=e)
    jflow, tflow = _coupling_pair(
        lambda nets, mask: jc.RQSplineCoupling.build(nets, mask=mask, **kw),
        tc.RQSplineCoupling, 3 * 4 - 2, "double", tkw=kw)
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((3, *LAT)) * 2, rng)


@pytest.mark.parametrize("extrap", [None, "linear", "anti", "periodic"])
@pytest.mark.parametrize("fixed", [False, True])
def test_rq_spline_coupling_takes_the_kernel_wrapper_where_it_fuses(
        rng, monkeypatch, fixed, extrap):
    """The route is the JAX package's ``_can_fuse`` (at a Pallas backend):
    free knots and ``None`` / ``'linear'`` sides.  A fusable coupling with
    a knot count the CUDA kernel was not built for still goes to the
    wrapper, which raises for it on the card; the plain spline never takes
    a fusable one quietly."""
    m = 5
    assert m not in SUPPORTED_KNOTS
    e = {} if extrap is None else {"left": extrap, "right": "linear"}
    if extrap == "periodic":
        e = {"left": "linear", "right": "anti-periodic"}
    kw = dict(xlim=LIM, ylim=LIM, extrap=e,
              knots_x=_fixed(m, LIM) if fixed else None)
    jflow = jc.RQSplineCoupling.build((), mask=None, backend="pallas", **kw)
    flow = tc.RQSplineCoupling(
        [tn.ConvNet(1, 2 * m - 1 if fixed else 3 * m - 2, 3, **F64)],
        mask=tm.EvenOddMask(shape=LAT), **kw)
    assert flow._can_fuse() == jflow._can_fuse()
    calls = []
    real = tc.rqs_coupling

    def spy(x, out, **k):
        calls.append(out.shape[1])
        return real(x, out, **k)

    monkeypatch.setattr(tc, "rqs_coupling", spy)
    with torch.no_grad():
        flow.forward(_t(rng.uniform(-1.5, 1.5, (2, *LAT))))
    assert calls == ([3 * m - 2] if jflow._can_fuse() else [])


@pytest.mark.parametrize("fixed", [False, True])
def test_multi_rq_spline_coupling(rng, fixed):
    """Two splines, one per trailing channel, on ``EvenOddMask``; free
    knots, or fixed x knots (``2m - 1`` channels per spline)."""
    m = 4
    kw = dict(xlims=(LIM, (-3.0, 3.0)), ylims=(LIM, (-3.0, 3.0)),
              extraps=({"left": "linear", "right": "linear"},
                       {"left": "anti"}),
              knots_x=((_fixed(m, LIM), _fixed(m, (-3.0, 3.0))) if fixed
                       else None))
    n_out = 2 * ((2 * m - 1) if fixed else (3 * m - 2))
    jnets, tnets = zip(*[_conv_pair(k, 2, n_out)
                         for k in jax.random.split(KEY, 2)])
    jflow = jc.MultiRQSplineCoupling.build(jnets, mask=MASKS["even-odd"](jm),
                                           **kw)
    tflow = tc.MultiRQSplineCoupling(tnets, mask=MASKS["even-odd"](tm), **kw)
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.uniform(-1.9, 1.9, (3, *LAT, 2)), rng)


# -------------------------------------------------------------------- core
def test_frozen_flow_takes_no_gradient_and_no_update(rng):
    jflow = jco.FlowList(flows=(
        jco.Frozen(flow=je.DistConvertor.build(5, symmetric=True)),
        je.DistConvertor.build(4, symmetric=True)))
    tflow = tco.FlowList([tco.Frozen(te.DistConvertor(5, **F64)),
                          te.DistConvertor(4, **F64)])
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((4, 3)), rng)
    mask = tco.trainable_mask(tflow)
    jmask = [bool(v) for v in leaves_of(jco.trainable_mask(jflow)).values()]
    assert list(mask.values()) == jmask == [False] * 3 + [True] * 3

    from normflow__tpu_torch import Model
    from normflow__tpu_torch.models.actions import ScalarPhi4Action
    from normflow__tpu_torch.models.priors import NormalPrior

    model = Model(net_=tflow, prior=NormalPrior(shape=(3,), **F64),
                  action=ScalarPhi4Action(kappa=0.2, m_sq=-1.0, lambd=0.5))
    before = [p.detach().clone() for p in tflow.parameters()]
    model.fit(n_epochs=3, batch_size=16, hyperparam=dict(weight_decay=0.1),
              checkpoint_dict=dict(print_stride=None))
    moved = [not torch.equal(a, p) for a, p in zip(before,
                                                   tflow.parameters())]
    assert moved == [False] * 3 + [True] * 3
    assert tco.unfreeze(tflow.flows[0]) is not None
    assert all(p.requires_grad for p in tflow.flows[0].parameters())
    assert tco.freeze(tco.freeze(tflow.flows[1])).flow is tflow.flows[1]


def test_modules_move_and_cast_with_torch():
    """No module hides ``nn.Module``'s own methods: ``.to`` / ``.double``
    reach every parameter of the containers, the mean-field flow and the
    masked wrappers, and the casted flows still run."""
    from normflow__tpu_torch.examples.scalar_affine import assemble_net

    flows = [
        assemble_net(lat_shape=(4, 4), device="cpu", n_layers=2,
                     hidden_sizes=(2,), knots2_len=4, knots4_len=4),
        tco.InvisibilityMaskWrapper(te.DistConvertor(4),
                                    tm.EvenOddMask(shape=(4, 4))),
        tco.FlowList([tco.Frozen(te.DistConvertor(4)),
                      tco.MultiChannelFlow([te.Tanh(), te.Scale()])]),
    ]
    x = torch.rand((2, 4, 4), dtype=torch.float64) * 0.5
    for flow in flows:
        flow = flow.to("cpu").double()
        assert all(p.dtype == torch.float64 for p in flow.parameters())
        if isinstance(flow, tco.FlowList) and len(flow.flows) == 2:
            y, logj = flow.forward(x[..., :2])
        else:
            y, logj = flow.forward(x)
        assert y.dtype == logj.dtype == torch.float64


@pytest.mark.parametrize("keep", [True, False])
def test_multi_channel_flows(rng, keep):
    jsub = tuple(je.DistConvertor.build(k, symmetric=True) for k in (4, 5))
    tsub = [te.DistConvertor(k, **F64) for k in (4, 5)]
    jflow = jco.MultiChannelFlow(flows=jsub, keep_channels_axis=keep)
    tflow = tco.MultiChannelFlow(tsub, keep_channels_axis=keep)
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((3, 4, 2)), rng)
    jout = jco.MultiOutChannelFlow(flows=jsub)
    tout = tco.MultiOutChannelFlow(tsub)
    jout = transplant(jout, tout, rng)
    check_flow(jout, tout, rng.standard_normal((3, 4, 1)), rng)


def test_invisibility_mask_wrapper(rng):
    jflow = jco.InvisibilityMaskWrapper(
        flow=je.DistConvertor.build(5, symmetric=True),
        mask=jm.EvenOddMask(shape=LAT))
    tflow = tco.InvisibilityMaskWrapper(te.DistConvertor(5, **F64),
                                        mask=tm.EvenOddMask(shape=LAT))
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((3, *LAT)), rng)


# ----------------------------------------------- lattice ops and the action
def test_lattice_ops(rng):
    x, y = rng.standard_normal(3), rng.standard_normal((2, 4))
    for name in ("outer", "outer_sum"):
        np.testing.assert_allclose(
            getattr(tl, name)(_t(x), _t(y)).numpy(),
            np.asarray(getattr(jl, name)(x, y)), rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        tl.outer_arange(((3,), (1, 5))).numpy(),
        np.asarray(jl.outer_arange(((3,), (1, 5)))))
    np.testing.assert_allclose(
        tl.outer_linspace(((0.0, 1.0, 3), (1.0, 2.0, 4)),
                          rule=lambda a, b: a + b).double().numpy(),
        np.asarray(jl.outer_linspace(((0.0, 1.0, 3), (1.0, 2.0, 4)),
                                     rule=lambda a, b: a + b)),
        rtol=0, atol=1e-6)
    z = rng.standard_normal((2, 5, 1, 4))
    for axis in (-1, 1):
        np.testing.assert_array_equal(tl.arange_like(_t(z), axis).numpy(),
                                      np.asarray(jl.arange_like(z, axis)))
    for axes in (None, (1, 3), (2, 3)):
        np.testing.assert_allclose(
            tl.neighbor_mean(_t(z), axes).numpy(),
            np.asarray(jl.neighbor_mean(jnp.asarray(z), axes)), rtol=0,
            atol=TOL)


def test_action_density_and_potential(rng):
    kw = dict(kappa=0.6, m_sq=-2.4, lambd=0.5)
    for shape in ((3, 8), (3, 6, 4), (2, 4, 3, 5)):
        x = rng.standard_normal(shape)
        want = ja.ScalarPhi4Action(**kw).action_density(jnp.asarray(x))
        got = ta.ScalarPhi4Action(**kw).action_density(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(  # it sums to the action
            got.sum(dim=tuple(range(1, x.ndim))).numpy(),
            ta.ScalarPhi4Action(**kw).action(_t(x)).numpy(), rtol=1e-12)
    x = rng.standard_normal(7)
    np.testing.assert_allclose(
        ta.ScalarPhi4Action(**kw).potential(_t(x)).numpy(),
        np.asarray(ja.ScalarPhi4Action(**kw).potential(jnp.asarray(x))),
        rtol=0, atol=TOL)
