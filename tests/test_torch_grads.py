"""Port parity of the kernels' gradients: the backward kernels' plain versions.

On CPU tensors the port's differentiable wrappers (``rqs_coupling``,
``phi4_action``) take their plain backward versions: the hand-derived VJP
``rqs_coupling_vjp_plain`` (the formulas the CUDA kernel
``csrc/rqs_coupling_bwd.cu`` carries, not autograd of the plain forward)
and the analytic force ``phi4_action_grad_plain``.  They are held against
``jax.vjp`` / ``jax.grad`` of the JAX package's Pallas kernels in
interpret mode on the same numpy inputs, float64 to 1e-10, and checked
with ``torch.autograd.gradcheck``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models.actions import ScalarPhi4Action as JaxPhi4Action
from normflow__tpu.ops.kernels.phi4 import phi4_action_pallas
from normflow__tpu.ops.kernels.spline_coupling import rqs_transform_fused
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc

LIM = (-2.0, 2.0)


def _rqs_inputs(rng, m, extrap, b=4, lat=(8, 8)):
    if extrap is None:  # keep strictly inside the box without extrapolation
        x = rng.random((b, *lat)) * 3.6 - 1.8
    else:
        x = rng.standard_normal((b, *lat)) * 1.2
    out = rng.standard_normal((b, *lat, 3 * m - 2))  # JAX: channels last
    cot = rng.standard_normal((2, b, *lat))
    return x, out, cot


def _torch_out(out):
    return torch.from_numpy(np.moveaxis(out, -1, 1).copy())


@pytest.mark.parametrize("m", [6, 8])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("extrap", [None, "linear"])
def test_rqs_vjp_plain_matches_jax_vjp(rng, m, inverse, extrap):
    x, out, (ybar, loggbar) = _rqs_inputs(rng, m, extrap)
    kw = dict(xlim=LIM, ylim=LIM, left=extrap, right=extrap, inverse=inverse)
    _, vjp = jax.vjp(lambda a, o: rqs_transform_fused(
        a, o, interpret=True, site_tile=32, **kw), jnp.asarray(x),
        jnp.asarray(out))
    want_x, want_out = vjp((jnp.asarray(ybar), jnp.asarray(loggbar)))
    want_out = np.moveaxis(np.asarray(want_out), -1, 1)

    tx, to = torch.from_numpy(x), _torch_out(out)
    tyb, tgb = torch.from_numpy(ybar), torch.from_numpy(loggbar)
    got_x, got_out = sc.rqs_coupling_vjp_plain(tx, to, tyb, tgb, **kw)
    assert got_out.shape == to.shape and got_out.is_contiguous()
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=0, atol=1e-10)

    # autograd through the CPU wrapper goes through the same VJP
    tx.requires_grad_()
    to.requires_grad_()
    y, logg = sc.rqs_coupling(tx, to, **kw)
    ax, ao = torch.autograd.grad((y * tyb).sum() + (logg * tgb).sum(),
                                 (tx, to))
    torch.testing.assert_close(ax, got_x, rtol=0, atol=0)
    torch.testing.assert_close(ao, got_out, rtol=0, atol=0)


@pytest.mark.parametrize("left,right,inverse", [
    (None, None, False), (None, None, True), ("linear", None, False),
    (None, "linear", True), ("linear", "linear", False),
    ("linear", "linear", True),
])
def test_rqs_coupling_gradcheck(rng, left, right, inverse):
    m, b, lat = 4, 2, (3, 4)
    x = rng.random((b, *lat)) * 3.6 - 1.8
    if left or right:  # reach past the box on the extrapolated sides
        x = np.where((x < 0) & bool(left) | (x > 0) & bool(right), 1.5 * x, x)
    tx = torch.tensor(x, requires_grad=True)
    to = torch.tensor(rng.standard_normal((b, 3 * m - 2, *lat)),
                      requires_grad=True)
    kw = dict(xlim=LIM, ylim=LIM, left=left, right=right, inverse=inverse)
    assert torch.autograd.gradcheck(
        lambda a, o: sc.rqs_coupling(a, o, **kw), (tx, to))


def test_rqs_vjp_plain_matches_autograd_of_plain_forward(rng):
    """The hand-derived VJP against autograd through the plain forward
    (finite: every division in it is guarded on both sides)."""
    x, out, (ybar, loggbar) = _rqs_inputs(rng, 8, "linear")
    kw = dict(xlim=LIM, ylim=LIM, left="linear", right="linear")
    for inverse in (False, True):
        tx = torch.from_numpy(x).requires_grad_()
        to = _torch_out(out).requires_grad_()
        y, logg = sc.rqs_coupling_plain(tx, to, inverse=inverse, **kw)
        tyb, tgb = torch.from_numpy(ybar), torch.from_numpy(loggbar)
        ax, ao = torch.autograd.grad((y * tyb).sum() + (logg * tgb).sum(),
                                     (tx, to))
        assert bool(torch.isfinite(ax).all() and torch.isfinite(ao).all())
        got_x, got_out = sc.rqs_coupling_vjp_plain(
            tx.detach(), to.detach(), tyb, tgb, inverse=inverse, **kw)
        torch.testing.assert_close(got_x, ax, rtol=0, atol=1e-10)
        torch.testing.assert_close(got_out, ao, rtol=0, atol=1e-10)


@pytest.mark.parametrize("lat", [(16,), (8, 8), (4, 4, 4)])
def test_phi4_grad_plain_matches_jax_grad(rng, lat):
    jact = JaxPhi4Action(kappa=0.7, m_sq=-2.0, lambd=0.5)
    w = jact.get_coef(len(lat))
    x = rng.standard_normal((8, *lat))
    wts = rng.standard_normal(8)  # a different cotangent per sample
    want = jax.grad(lambda c: jnp.sum(jnp.asarray(wts) * phi4_action_pallas(
        c, *w, interpret=True)))(jnp.asarray(x))

    got = phi4.phi4_action_grad_plain(torch.from_numpy(x),
                                      torch.from_numpy(wts), *w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)
    tx = torch.from_numpy(x).requires_grad_()
    act = ScalarPhi4Action(kappa=0.7, m_sq=-2.0, lambd=0.5)
    (auto,) = torch.autograd.grad(
        (act.action(tx) * torch.from_numpy(wts)).sum(), tx)
    torch.testing.assert_close(auto, got, rtol=0, atol=0)


def test_phi4_grad_one_site_without_hopping(rng):
    """The zero-dim fit's action: one site, kappa = 0 (w0 = 0)."""
    jact = JaxPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5)
    w = jact.get_coef(1)
    assert w[0] == 0
    x, g = rng.standard_normal((128, 1)), rng.standard_normal(128)
    want = jax.grad(lambda c: jnp.sum(jnp.asarray(g) * phi4_action_pallas(
        c, *w, interpret=True)))(jnp.asarray(x))
    got = phi4.phi4_action_grad(torch.from_numpy(x), torch.from_numpy(g), *w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("lat", [(5,), (3, 4), (2, 3, 4)])
def test_phi4_action_gradcheck(rng, lat):
    tx = torch.tensor(rng.standard_normal((3, *lat)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda c: phi4.phi4_action(c, 0.6, 0.3, 0.5), (tx,))


def test_cpu_gradients_launch_nothing(rng):
    counters = (sc.rqs_coupling_bwd, phi4.phi4_action_grad)
    before = [c.launches for c in counters]
    x = torch.tensor(rng.standard_normal((2, 4, 4)), requires_grad=True)
    out = torch.tensor(rng.standard_normal((2, 10, 4, 4)), requires_grad=True)
    y, logg = sc.rqs_coupling(x, out, xlim=LIM, ylim=LIM)
    (y.sum() + logg.sum() + phi4.phi4_action(y, 0.6, 0.0, 0.5).sum()
     ).backward()
    assert x.grad is not None and out.grad is not None
    assert [c.launches for c in counters] == before == [0, 0]


def test_gradient_wrappers_reject_bad_arguments():
    x = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError, match="cotangents"):
        sc.rqs_coupling_bwd(x, torch.zeros((2, 10, 4, 4)), x, x[:1],
                            xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="cotangent"):
        phi4.phi4_action_grad(x, torch.zeros(3), 0.6, 0.0, 0.5)
    meta = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sc.rqs_coupling_bwd(meta, torch.empty((2, 10, 4, 4), device="meta"),
                            meta, meta, xlim=LIM, ylim=LIM)
    with pytest.raises(ValueError, match="no kernel"):
        phi4.phi4_action_grad(meta, torch.empty(2, device="meta"), 0.6, 0.0,
                              0.5)
