"""Port parity: ``normflow__tpu_torch.ops.spline`` vs ``normflow__tpu.ops.spline``.

The same numpy inputs go through both packages in float64; they agree to
1e-12 (the two only differ in summation and gather order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models.elementwise import softplus_log2 as jax_softplus_log2
from normflow__tpu.ops import spline as jsp
from normflow__tpu_torch.models.elementwise import softplus_log2
from normflow__tpu_torch.ops import spline as tsp

TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _knots(rng, shape, m, xlim=(-2.0, 2.0)):
    w = rng.standard_normal((*shape, 3 * m - 2))
    wx, wy, wd = w[..., :m - 1], w[..., m - 1:2 * m - 2], w[..., 2 * m - 2:]
    width = xlim[1] - xlim[0]
    return (tsp.knot_coords(_t(wx), xlim[0], width),
            tsp.knot_coords(_t(wy), xlim[0], width),
            softplus_log2(_t(wd)),
            (jsp.knot_coords(jnp.asarray(wx), xlim[0], width),
             jsp.knot_coords(jnp.asarray(wy), xlim[0], width),
             jax_softplus_log2(jnp.asarray(wd))))


def test_knot_coords(rng):
    w = rng.standard_normal((5, 7)) * 3
    _close(tsp.knot_coords(_t(w), -1.5, 3.0),
           jsp.knot_coords(jnp.asarray(w), -1.5, 3.0))


def test_softplus_log2_is_exact_at_large_weights():
    w = np.array([-60.0, -25.0, -1.0, 0.0, 1.0, 25.0, 60.0])
    _close(softplus_log2(_t(w)), jax_softplus_log2(jnp.asarray(w)))
    assert float(softplus_log2(_t([0.0]))) == 1.0


def test_searchsorted_last(rng):
    knots = np.sort(rng.standard_normal(9))
    x = np.concatenate([rng.standard_normal(50) * 2, knots])
    got = tsp.searchsorted_last(_t(knots), _t(x))
    want = jsp.searchsorted_last(jnp.asarray(knots), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smooth_derivatives_rq(rng):
    kx = np.cumsum(rng.random((3, 8)), axis=-1)
    ky = np.cumsum(rng.random((3, 8)), axis=-1)
    _close(tsp.smooth_derivatives_rq(_t(kx), _t(ky)),
           jsp.smooth_derivatives_rq(jnp.asarray(kx), jnp.asarray(ky)))


@pytest.mark.parametrize("left,right", [
    ("linear", "linear"), ("linear", None), (None, "linear"),
    ("anti", None), (None, "anti"), ("anti", "linear"), ("linear", "anti"),
])
def test_augment_knots(rng, left, right):
    kx, ky, kd, jknots = _knots(rng, (4,), 6)
    got = tsp.augment_knots(kx, ky, kd, left=left, right=right)
    want = jsp.augment_knots(*jknots, left=left, right=right)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_rqs_matches_jax(rng, inverse, shared):
    """Per-site and shared knots, with linear tails, inputs inside and
    outside the box."""
    shape = (6, 5)
    kx, ky, kd, jknots = _knots(rng, () if shared else shape, 8)
    kx, ky, kd = tsp.augment_knots(kx, ky, kd, left="linear", right="linear")
    jknots = jsp.augment_knots(*jknots, left="linear", right="linear")
    x = rng.standard_normal(shape) * 2.5
    y, g = tsp.rqs(_t(x), kx, ky, kd, inverse=inverse)
    jy, jg = jsp.rqs(jnp.asarray(x), *jknots, inverse=inverse)
    _close(y, jy)
    _close(g, jg)


def test_rqs_roundtrip(rng):
    kx, ky, kd, _ = _knots(rng, (32,), 6)
    kx, ky, kd = tsp.augment_knots(kx, ky, kd, left="linear", right="linear")
    x = _t(rng.standard_normal(32) * 3)
    y, g = tsp.rqs(x, kx, ky, kd)
    x2, g2 = tsp.rqs(y, kx, ky, kd, inverse=True)
    _close(x2, x.numpy())
    _close(g * g2, np.ones(32))
