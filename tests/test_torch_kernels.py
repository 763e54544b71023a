"""Port parity of the kernels' plain versions and the wrappers' dispatch.

``rqs_coupling`` and ``phi4_action`` on CPU tensors run their plain PyTorch
versions; these are held against the JAX package's Pallas kernels (in
interpret mode) and XLA paths on the same numpy inputs.  float64 agrees to
1e-10; float32 to the JAX kernel tests' own tolerances (1e-4 for the
spline, rtol 2e-5 for the action).  The CUDA kernels themselves run only
on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models.actions import ScalarPhi4Action as JaxPhi4Action
from normflow__tpu.models.couplings import _knots_from_net_out
from normflow__tpu.ops import spline as jsp
from normflow__tpu.ops.kernels.phi4 import phi4_action_pallas
from normflow__tpu.ops.kernels.spline_coupling import rqs_transform_fused
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling

LIM = (-2.0, 2.0)


def _rqs_inputs(rng, m, extrap, dtype, b=4, lat=(8, 8)):
    if extrap is None:  # keep strictly inside the box without extrapolation
        x = rng.random((b, *lat)) * 3.6 - 1.8
    else:
        x = rng.standard_normal((b, *lat)) * 0.8
    out = rng.standard_normal((b, *lat, 3 * m - 2))  # JAX: channels last
    return x.astype(dtype), out.astype(dtype)


def _rqs_both(x, out, extrap, inverse, torch_dtype):
    kw = dict(xlim=LIM, ylim=LIM, left=extrap, right=extrap, inverse=inverse)
    got = spline_coupling.rqs_coupling(
        torch.from_numpy(x).to(torch_dtype),
        torch.from_numpy(np.moveaxis(out, -1, 1).copy()).to(torch_dtype),
        **kw)
    fused = rqs_transform_fused(jnp.asarray(x), jnp.asarray(out),
                                interpret=True, site_tile=32, **kw)
    e = {k: v for k, v in dict(left=extrap, right=extrap).items() if v}
    knots = _knots_from_net_out(
        jnp.asarray(out), xlim=LIM, ylim=LIM, xwidth=4.0, ywidth=4.0,
        fixed_x=None, fixed_y=None, extrap=tuple(sorted(e.items())))
    y, g = jsp.rqs(jnp.asarray(x), *knots, inverse=inverse)
    return got, fused, (y, jnp.log(g))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("extrap", [None, "linear"])
def test_rqs_coupling_plain_matches_jax_f64(rng, inverse, extrap):
    x, out = _rqs_inputs(rng, 6, extrap, np.float64)
    got, fused, xla = _rqs_both(x, out, extrap, inverse, torch.float64)
    for want in (fused, xla):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-10)


def test_rqs_coupling_plain_matches_jax_f32(rng):
    x, out = _rqs_inputs(rng, 8, "linear", np.float32)
    got, fused, xla = _rqs_both(x, out, "linear", False, torch.float32)
    for want in (fused, xla):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("lat", [(16,), (8, 8), (4, 4, 4)])
def test_phi4_action_plain_matches_jax_f64(rng, lat):
    jact = JaxPhi4Action(kappa=0.7, m_sq=-2.0, lambd=0.5)
    act = ScalarPhi4Action(kappa=0.7, m_sq=-2.0, lambd=0.5)
    x = rng.standard_normal((16, *lat))
    got = act.action(torch.from_numpy(x)).numpy()
    w = jact.get_coef(len(lat))
    assert act.get_coef(len(lat)) == w
    for want in (phi4_action_pallas(jnp.asarray(x), *w, interpret=True),
                 jact.action(jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-10)


def test_phi4_action_plain_matches_jax_f32(rng):
    jact = JaxPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5)
    x = rng.standard_normal((16, 8, 8)).astype(np.float32)
    w = jact.get_coef(2)
    got = phi4.phi4_action(torch.from_numpy(x), *w).numpy()
    want = phi4_action_pallas(jnp.asarray(x), *w, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5)


def test_cpu_calls_launch_nothing(rng):
    before = (spline_coupling.rqs_coupling.launches,
              phi4.phi4_action.launches)
    x = torch.from_numpy(rng.standard_normal((2, 4, 4)))
    out = torch.from_numpy(rng.standard_normal((2, 10, 4, 4)))
    spline_coupling.rqs_coupling(x, out, xlim=LIM, ylim=LIM)
    phi4.phi4_action(x, 0.6, 0.0, 0.5)
    assert (spline_coupling.rqs_coupling.launches,
            phi4.phi4_action.launches) == before == (0, 0)


def test_meta_tensors_raise_instead_of_computing():
    x = torch.empty((2, 4, 4), device="meta")
    out = torch.empty((2, 10, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spline_coupling.rqs_coupling(x, out, xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="no kernel"):
        phi4.phi4_action(x, 0.6, 0.0, 0.5)


@pytest.mark.parametrize("out_shape,extrap", [
    ((2, 10, 4, 5), None),      # lattice mismatch
    ((2, 4, 4, 10), None),      # channels last instead of (B, K3, *lat)
    ((2, 10, 4, 4), "anti"),    # extrapolation the kernel does not do
])
def test_rqs_coupling_rejects_bad_arguments(out_shape, extrap):
    x = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError):
        spline_coupling.rqs_coupling(x, torch.zeros(out_shape), xlim=LIM,
                                     ylim=LIM, left=extrap)
