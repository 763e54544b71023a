"""Port parity of the elementwise flows, the spline ops and the spectral
flows, on the CPU, with ``test_torch_flow_zoo.py``'s helpers: forward and
inverse, the log-Jacobian summed and as a density, and the parameter
gradients agree with the JAX package to 1e-10 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models import elementwise as je
from normflow__tpu.models import spectral as js
from normflow__tpu.ops import spline as jsp
from normflow__tpu.utils.serialization import leaves_of
from normflow__tpu_torch.models import elementwise as te
from normflow__tpu_torch.models import spectral as ts
from normflow__tpu_torch.ops import spline as tsp
from test_torch_flow_zoo import DIRECTIONS, F64, TOL, _fixed, _t, check_flow
from test_torch_modules import transplant


# -------------------------------------------------------------- elementwise
def _unit(r, s):
    return r.uniform(0.05, 0.95, s)


def _fixed_d(m):
    d = np.linspace(0.5, 1.5, m)
    d[0] = d[-1] = 0.0
    return d


ELEMENTWISE = {
    "identity": (lambda: je.Identity(), lambda: te.Identity(), None),
    "clone": (lambda: je.Clone(), lambda: te.Clone(), None),
    "tanh": (lambda: je.Tanh(), lambda: te.Tanh(),
             lambda r, s: r.uniform(-0.9, 0.9, s)),
    "arctanh": (lambda: je.ArcTanh(), lambda: te.ArcTanh(),
                lambda r, s: r.uniform(-0.9, 0.9, s)),
    "expit": (lambda: je.Expit(), lambda: te.Expit(), _unit),
    "logit": (lambda: je.Logit(), lambda: te.Logit(), _unit),
    "scale": (lambda: je.Scale.build(), lambda: te.Scale(**F64), None),
    "pade11": (lambda: je.Pade11.build(3), lambda: te.Pade11(3, **F64),
               _unit),
    "pade22": (lambda: je.Pade22.build(3), lambda: te.Pade22(3, **F64),
               _unit),
    "pade22 symmetric": (lambda: je.Pade22.build(3, symmetric=True),
                         lambda: te.Pade22(3, symmetric=True, **F64), _unit),
    "pade32": (lambda: je.Pade32.build(3), lambda: te.Pade32(3, **F64),
               None),
    "sgnbias": (lambda: je.SgnBias.build(size=(3,)),
                lambda: te.SgnBias((3,), **F64), None),
    "spline shape": (
        lambda: je.SplineFlow.build(5, spline_shape=(3,)),
        lambda: te.SplineFlow(5, spline_shape=(3,), **F64), _unit),
    "spline rls": (lambda: je.SplineFlow.build(5, kind="rls"),
                   lambda: te.SplineFlow(5, kind="rls", **F64), _unit),
    "spline rls smooth": (
        lambda: je.SplineFlow.build(5, kind="rls", smooth=True),
        lambda: te.SplineFlow(5, kind="rls", smooth=True, **F64), _unit),
    "spline fixed x": (
        lambda: je.SplineFlow.build(5, knots_x=_fixed(5, (0, 1)),
                                    smooth=True),
        lambda: te.SplineFlow(5, knots_x=_fixed(5, (0, 1)), smooth=True,
                              **F64), _unit),
    "spline fixed y, linear": (
        lambda: je.SplineFlow.build(5, knots_y=_fixed(5, (0, 1)),
                                    extrap={"left": "linear",
                                            "right": "linear"}),
        lambda: te.SplineFlow(5, knots_y=_fixed(5, (0, 1)),
                              extrap={"left": "linear", "right": "linear"},
                              **F64), lambda r, s: r.uniform(-1, 2, s)),
    "spline fixed d, periodic": (
        lambda: je.SplineFlow.build(5, knots_d=_fixed_d(5),
                                    extrap={"left": "periodic",
                                            "right": "periodic"}),
        lambda: te.SplineFlow(5, knots_d=_fixed_d(5),
                              extrap={"left": "periodic",
                                      "right": "periodic"}, **F64),
        _unit),
    "spline anti-periodic": (
        lambda: je.SplineFlow.build(5, extrap={"left": "anti-periodic"}),
        lambda: te.SplineFlow(5, extrap={"left": "anti-periodic"}, **F64),
        lambda r, s: r.uniform(-0.9, 0.95, s)),
    "unity": (lambda: je.UnityDistConvertor.build(5),
              lambda: te.UnityDistConvertor(5, **F64), _unit),
    "unity symmetric": (
        lambda: je.UnityDistConvertor.build(5, symmetric=True),
        lambda: te.UnityDistConvertor(5, symmetric=True, **F64), _unit),
    "phase": (lambda: je.PhaseDistConvertor.build(5),
              lambda: te.PhaseDistConvertor(5, **F64),
              lambda r, s: r.uniform(-3.1, 3.1, s)),
    "phase symmetric": (
        lambda: je.PhaseDistConvertor.build(5, symmetric=True),
        lambda: te.PhaseDistConvertor(5, symmetric=True, **F64),
        lambda r, s: r.uniform(-3.1, 3.1, s)),
    "dc asymmetric": (
        lambda: je.DistConvertor.build(6),
        lambda: te.DistConvertor(6, symmetric=False, **F64), None),
    "dc sgnbias, initial scale": (
        lambda: je.DistConvertor.build(6, symmetric=True, sgnbias=True,
                                       initial_scale=True),
        lambda: te.DistConvertor(6, sgnbias=True, initial_scale=True,
                                 **F64), None),
    "dc one knot, final scale": (
        lambda: je.DistConvertor.build(1, final_scale=True),
        lambda: te.DistConvertor(1, symmetric=False, final_scale=True,
                                 **F64), None),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_elementwise_flow(rng, name):
    """The even ('periodic') reflection makes the y knots fall again, so
    that spline has no inverse: it is held forward only."""
    jbuild, tbuild, draw = ELEMENTWISE[name]
    jflow, tflow = jbuild(), tbuild()
    if leaves_of(jflow):
        jflow = transplant(jflow, tflow, rng)
    draw = draw or (lambda r, s: r.standard_normal(s) * 1.5)
    check_flow(jflow, tflow, draw(rng, (4, 5, 3)), rng,
               directions=("forward",) if name == "spline fixed d, periodic"
               else DIRECTIONS)


def test_convertor_layers_and_sgnbias_draw():
    dc = te.DistConvertor(6, sgnbias=True, final_scale=True,
                          generator=torch.Generator().manual_seed(3), **F64)
    assert [type(f).__name__ for f in dc.flows] == [
        "SgnBias", "Expit", "SplineFlow", "Logit", "Scale"]
    assert 0.0 <= float(dc.flows[0].w.detach()) < 0.1
    assert float(te.SgnBias(**F64).w.detach()) == 0.05
    with pytest.raises(ValueError, match="periodic"):
        te.SplineFlow(4, extrap={"left": "periodic"}, **F64)
    with pytest.raises(ValueError, match="zero derivative"):
        tsp.augment_knots(*(_t(_fixed(4, (0, 1))),) * 2, _t(np.ones(4)),
                          left="periodic")
    net = te.SplineNet(5, **F64)
    x = _t(np.linspace(0.1, 0.9, 7))
    torch.testing.assert_close(net.invert(net(x)), x, rtol=0, atol=1e-14)


@pytest.mark.parametrize("left,right", [
    ("periodic", "periodic"), ("anti-periodic", "linear"),
    ("linear", "periodic"), ("anti", "anti-periodic")])
def test_augment_knots_reflections(rng, left, right):
    """The even ('periodic') and odd reflections, after the linear
    patches; 'periodic' needs zero boundary derivatives."""
    kx, ky = (np.sort(rng.random((2, 5)), axis=-1) for _ in range(2))
    kd = rng.random((2, 5)) + 0.5
    kd[:, 0] = kd[:, -1] = 0.0
    got = tsp.augment_knots(_t(kx), _t(ky), _t(kd), left=left, right=right)
    want = jsp.augment_knots(jnp.asarray(kx), jnp.asarray(ky),
                             jnp.asarray(kd), left=left, right=right)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("inverse", [False, True])
def test_rls_and_its_derivatives(rng, inverse):
    """The rational-linear spline with its parameter-free derivatives, on
    knots per trailing index that broadcast against the input."""
    def knots():
        inner = np.sort(rng.random((3, 4)), axis=-1)
        return np.concatenate([np.zeros((3, 1)), inner, np.ones((3, 1))], -1)

    kx, ky = knots(), knots()
    want_d = jsp.smooth_derivatives_rl(jnp.asarray(kx), jnp.asarray(ky))
    got_d = tsp.smooth_derivatives_rl(_t(kx), _t(ky))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=TOL)
    x = rng.uniform(0.02, 0.98, (5, 3))
    want = jsp.rls(jnp.asarray(x), jnp.asarray(kx), jnp.asarray(ky), want_d,
                   inverse=inverse)
    got = tsp.rls(_t(x), _t(kx), _t(ky), got_d, inverse=inverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


# ---------------------------------------------------------------- spectral
@pytest.mark.parametrize("knots,lat,kw", [
    (10, (8, 8), dict()), (1, (6, 5), dict()),
    (5, (4, 6), dict(eff_mass2=2.0, eff_kappa=0.5, a=0.5))])
def test_fft_flow_builds(rng, knots, lat, kw):
    """Any knot count (fewer than 2: a smooth 2-knot spline), the
    effective-mass initialisation and its spacing scale."""
    jflow = js.FFTFlow.build(lat, knots_len=knots, **kw)
    tflow = ts.FFTFlow(lat, knots_len=knots, **kw, **F64)
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((3, *lat)), rng)
    np.testing.assert_allclose(float(tflow.infrared_mass.detach()),
                               float(jflow.infrared_mass), rtol=1e-12)


def test_ipsd_no_zero_mode_and_free_scalar(rng):
    jflow = js.FFTFlow(ipsd_net=js.IPSDNoZeroMode.build(5, logy=[0.3],
                                                        smooth=True),
                       lat_shape=(4, 6))
    tflow = ts.FFTFlow((4, 6), ipsd_net=ts.IPSDNoZeroMode(
        5, logy=[0.3], smooth=True, **F64))
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((3, 4, 6)), rng)
    np.testing.assert_allclose(float(tflow.infrared_mass.detach()),
                               float(jflow.infrared_mass), rtol=1e-9)
    assert ts.IPSDNoZeroMode.apply_scale([0.3], a=0.5, ndim=3) == \
        pytest.approx(np.asarray(js.IPSDNoZeroMode.apply_scale(
            jnp.asarray([0.3]), a=0.5, ndim=3)).tolist(), abs=1e-15)
    np.testing.assert_allclose(
        ts.FreeScalar((4, 6)).calc_lattice_k2().numpy(),
        np.asarray(js.FreeScalar((4, 6)).calc_lattice_k2()), rtol=0,
        atol=1e-15)


class _IdentityTakingRvol(je.Identity):
    """The JAX package's ``Identity`` takes no ``rvol``, so its
    ``PSDBlock`` cannot hold one (the affine example's ``knots0_len <= 1``
    branch raises there); this one ignores it, as the port's does."""

    def forward(self, x, log0=0.0, *, density=False, rvol=None):
        return je.Identity.forward(self, x, log0, density=density)

    backward = forward


@pytest.mark.parametrize("mf", ["identity", "knots 10", "standalone"])
def test_mean_field_and_psd_block(rng, mf):
    """The affine example's PSD block (10 knots each), with ``Identity``
    standing for the mean-field flow, and the mean-field flow alone on a
    whole field."""
    lat = (6, 6)
    jmf = (_IdentityTakingRvol() if mf == "identity" else js.MeanFieldFlow.build(
        10, symmetric=True, smooth=True, final_scale=True))
    tmf = (te.Identity() if mf == "identity" else ts.MeanFieldFlow(
        10, smooth=True, final_scale=True, **F64))
    if mf == "standalone":
        jflow, tflow = jmf, tmf
    else:
        jflow = js.PSDBlock(mfnet=jmf, fftnet=js.FFTFlow.build(
            lat, knots_len=10, ignore_zeromode=True))
        tflow = ts.PSDBlock(mfnet=tmf, fftnet=ts.FFTFlow(
            lat, knots_len=10, ignore_zeromode=True, **F64))
    jflow = transplant(jflow, tflow, rng)
    check_flow(jflow, tflow, rng.standard_normal((3, *lat)), rng)
