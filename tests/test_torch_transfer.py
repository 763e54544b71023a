"""Port parity of coarse-to-fine transfer and coupling growth on the CPU.

The packed flagship at 8x8 (4 knots, hidden (4,), 2 couplings) with seeded
perturbed leaves in both packages is transferred to 16x16
(``FlowList.transfer(shape=..., mask=PackedEvenOddMask(...))``, at the same
spacing and at half of it): per sample outputs, log-Jacobians and inverses
agree to 1e-10 in float64, and the source is left as it was.  A transfer to
the same shape computes the same flow bit for bit; ``grow`` is the
identity (to round-off for the spline) with nonzero gradients into the
zeroed layers (``tests/test_transfer_cntr.py:95, 121``) and agrees with the
JAX ``grow``; ``FFTFlow.transfer`` rescales the infrared mass as
``tests/test_transfer_cntr.py:22`` holds; the nets' ``zeroed``,
``zeroed_final`` and ``transfer`` agree with the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models import couplings as jc
from normflow__tpu.models import masks as jm
from normflow__tpu.models import nets as jn
from normflow__tpu.models import spectral as js
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch import backward_sanitychecker
from normflow__tpu_torch.models import couplings as tc
from normflow__tpu_torch.models import masks as tm
from normflow__tpu_torch.models import nets as tn
from normflow__tpu_torch.models import spectral as ts
from normflow__tpu_torch.zoo import build_phi4_model
from test_torch_flagship import SMALL, twin_models
from test_torch_modules import transplant

F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_flows_agree(jflow, tflow, x, tol=TOL):
    """Forward and backward of the JAX flow (one program, compiled at
    XLA's lowest backend optimisation level) and of the port on ``x``."""
    def both(flow, x):
        return flow.forward(x), flow.backward(x)

    args = (jflow, jnp.asarray(x))
    want = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    with torch.no_grad():
        got = tflow.forward(_t(x)), tflow.backward(_t(x))
    for (ty, tlogj), (jy, jlogj) in zip(got, want):
        assert ty.shape == jy.shape and tlogj.shape == jlogj.shape
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(tlogj.numpy(), np.asarray(jlogj), rtol=0,
                                   atol=tol)


def _params(module):
    return [p.detach().clone() for p in module.parameters()]


@pytest.mark.parametrize("scale_factor", [1, 2])
def test_flagship_transfer_matches_jax(rng, scale_factor):
    jmodel, model = twin_models(rng, jnp.float64, torch.float64)
    before = _params(model.net_)
    kw = dict(scale_factor=scale_factor, shape=(16, 16))
    jnet = jmodel.net_.transfer(mask=jm.PackedEvenOddMask(shape=(16, 16)),
                                **kw)
    tnet = model.net_.transfer(mask=tm.PackedEvenOddMask(shape=(16, 16)),
                               **kw)
    x = rng.standard_normal((5, 16, 16))
    assert_flows_agree(jnet, tnet, x, tol=TOL)
    # the inverse of the forward's output, and no weight shared or changed
    with torch.no_grad():
        y, logj = tnet.forward(_t(x))
        xb, log0 = tnet.backward(y, logj)
    np.testing.assert_allclose(xb.numpy(), x, rtol=0, atol=TOL)
    np.testing.assert_allclose(log0.numpy(), 0.0, rtol=0, atol=TOL)
    src = {p.data_ptr() for p in model.net_.parameters()}
    assert not src & {p.data_ptr() for p in tnet.parameters()}
    with torch.no_grad():
        for p in tnet.parameters():
            p.add_(1.0)
    for a, b in zip(before, model.net_.parameters()):
        assert torch.equal(a, b)


def test_transfer_to_the_same_shape_is_the_same_flow(rng):
    model = twin_models(rng, jnp.float64, torch.float64)[1]
    net = model.net_.transfer(shape=(8, 8),
                              mask=tm.PackedEvenOddMask(shape=(8, 8)))
    x = _t(rng.standard_normal((4, 8, 8)))
    with torch.no_grad():
        for direction in ("forward", "backward"):
            for a, b in zip(getattr(model.net_, direction)(x),
                            getattr(net, direction)(x)):
                assert torch.equal(a, b), direction
    for a, b in zip(model.net_.parameters(), net.parameters()):
        assert torch.equal(a, b)


def _nets(rng, out_channels, n=2, lat=(6, 6)):
    """``n`` JAX conv nets 1 -> 4 -> ``out_channels`` and their ports,
    with the same perturbed leaves."""
    keys = jax.random.split(jax.random.key(int(rng.integers(1 << 30))), n)
    pairs = []
    for k in keys:
        jnet = jn.ConvNet.build(k, 1, out_channels, kernel_size=3,
                                conv_dim=len(lat), hidden_sizes=(4,),
                                acts=("tanh", None))
        tnet = tn.ConvNet(1, out_channels, 3, conv_dim=len(lat),
                          hidden_sizes=(4,), acts=("tanh", None), **F64)
        pairs.append((transplant(jnet, tnet, rng), tnet))
    return [j for j, _ in pairs], [t for _, t in pairs]


COUPLINGS = {
    "affine": (2, lambda nets, m: jc.AffineCoupling(nets=tuple(nets),
                                                    mask=m),
               lambda nets, m: tc.AffineCoupling(nets, mask=m)),
    "spline": (10, lambda nets, m: jc.RQSplineCoupling.build(
        tuple(nets), mask=m, xlim=(-3.0, 3.0), ylim=(-3.0, 3.0),
        extrap={"left": "linear", "right": "linear"}),
        lambda nets, m: tc.RQSplineCoupling(
            nets, mask=m, xlim=(-3.0, 3.0), ylim=(-3.0, 3.0),
            extrap={"left": "linear", "right": "linear"})),
}


@pytest.mark.parametrize("kind", COUPLINGS)
def test_coupling_grow_is_identity_and_trainable(rng, kind):
    out_channels, jmake, tmake = COUPLINGS[kind]
    jnets, tnets = _nets(rng, out_channels)
    jnew, tnew = _nets(rng, out_channels)
    jcpl = jmake(jnets, jm.EvenOddMask(shape=(6, 6)))
    tcpl = tmake(tnets, tm.EvenOddMask(shape=(6, 6)))
    jgrown, grown = jcpl.grow(jnew), tcpl.grow(tnew)
    assert len(grown.nets) == 4 and len(tcpl.nets) == 2
    x = _t(rng.standard_normal((4, 6, 6)))
    y0, j0 = tcpl.forward(x)
    y1, j1 = grown.forward(x)
    # the affine identity is exact; the spline at uniform knots and unit
    # derivatives recomputes x through the rational-quadratic map
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(j1.detach().numpy(), j0.detach().numpy(),
                               rtol=0, atol=1e-12)
    assert_flows_agree(jgrown, grown, x.numpy(), tol=TOL)
    (torch.sum(y1 ** 2) + torch.sum(j1)).backward()
    for net in grown.nets[2:]:
        g = net.layers[-1].weight.grad
        assert g is not None and float(g.abs().max()) > 0.0
    for net in tnew:  # the new nets are copied, not zeroed in place
        assert float(net.layers[-1].weight.detach().abs().max()) > 0.0


def test_coupling_transfer_to_a_new_mask(rng):
    jnets, tnets = _nets(rng, 2)
    jcpl = jc.AffineCoupling(nets=tuple(jnets),
                             mask=jm.EvenOddMask(shape=(6, 6)))
    tcpl = tc.AffineCoupling(tnets, mask=tm.EvenOddMask(shape=(6, 6)))
    jt = jcpl.transfer(mask=jm.EvenOddMask(shape=(8, 8)))
    tt = tcpl.transfer(mask=tm.EvenOddMask(shape=(8, 8)))
    assert tt.mask.shape == (8, 8) and tcpl.mask.shape == (6, 6)
    assert_flows_agree(jt, tt, rng.standard_normal((3, 8, 8)), tol=TOL)


def test_fftflow_transfer_rescales(rng):
    """Half the spacing (``scale_factor=2``) halves the infrared mass in
    lattice units, as in the JAX package, and the flow on the new lattice
    agrees with the JAX one."""
    jflow = js.FFTFlow.build((8, 8), knots_len=4, eff_mass2=1.0)
    tflow = ts.FFTFlow((8, 8), knots_len=4, eff_mass2=1.0, **F64)
    jflow = transplant(jflow, tflow, rng)
    jt = jflow.transfer(scale_factor=2, shape=(16, 16))
    tt = tflow.transfer(scale_factor=2, shape=(16, 16))
    assert tt.lat_shape == (16, 16) and tflow.lat_shape == (8, 8)
    np.testing.assert_allclose(float(tt.infrared_mass.detach()),
                               float(tflow.infrared_mass.detach()) / 2,
                               rtol=1e-12)
    np.testing.assert_allclose(tt.ipsd_net.logy.detach().numpy(),
                               np.asarray(jt.ipsd_net.logy), rtol=0,
                               atol=1e-15)
    assert_flows_agree(jt, tt, rng.standard_normal((3, 16, 16)), tol=TOL)


@pytest.mark.parametrize("kind", ["conv", "parity", "linear"])
def test_net_zeroed_and_transfer(rng, kind):
    key = jax.random.key(3)
    if kind == "linear":
        jnet = jn.LinearNet.build(key, 5, 3, hidden_sizes=(4,),
                                  acts=("tanh", None), final_bias=True)
        tnet = tn.LinearNet(5, 3, hidden_sizes=(4,), acts=("tanh", None),
                            final_bias=True, **F64)
        x = rng.standard_normal((2, 5))
        tx = _t(x)
    else:
        jnet = jn.ConvNet.build(key, 2 if kind == "parity" else 1, 3,
                                kernel_size=3, conv_dim=2, hidden_sizes=(4,),
                                acts=("tanh", None))
        tnet = tn.ConvNet(2 if kind == "parity" else 1, 3, 3, conv_dim=2,
                          hidden_sizes=(4,), acts=("tanh", None), **F64)
        if kind == "parity":
            jnet = jn.RowParityFeature(net=jnet)
            tnet = tn.RowParityFeature(tnet)
        x = rng.standard_normal((2, 6, 4, 1))  # JAX: channels last
        tx = _t(x).movedim(-1, 1)
    jnet = transplant(jnet, tnet, rng)

    def out(net):
        with torch.no_grad():
            y = net(tx)
        return (y if kind == "linear" else y.movedim(1, -1)).numpy()

    for name in ("zeroed", "zeroed_final", "transfer"):
        got, want = getattr(tnet, name)(), getattr(jnet, name)()
        np.testing.assert_allclose(out(got), np.asarray(want(jnp.asarray(x))),
                                   rtol=0, atol=TOL, err_msg=name)
        assert float(sum(p.abs().sum() for p in tnet.parameters())) > 0
    assert not np.any(out(tnet.zeroed_final()))
    kept = tnet.zeroed_final()
    inner = kept.net if kind == "parity" else kept
    assert float(inner.layers[0].weight.abs().max()) > 0  # hidden kept


def test_flagship_coarse_to_fine_trains():
    """``tests/test_transfer_cntr.py``'s coarse-to-fine flagship, on the
    port: fit at 8x8, transfer to 16x16, sample, round trip, fit on."""
    m8 = build_phi4_model(**SMALL, **F64)
    m8.fit(n_epochs=10, batch_size=32, hyperparam=dict(lr=1e-3),
           checkpoint_dict=dict(print_stride=None), steps_per_call=10)
    m16 = build_phi4_model((16, 16), knots=4, hidden=(4,), n_layers=2,
                           **F64)
    m16.net_ = m8.net_.transfer(shape=(16, 16),
                                mask=tm.PackedEvenOddMask(shape=(16, 16)))
    y, logq, logp = m16.posterior.sample__(8)
    assert y.shape == (8, 16, 16) and bool(torch.isfinite(logq).all())
    xe, je = backward_sanitychecker(m16, n_samples=4, verbose=False)
    assert xe < 1e-10 and je < 1e-10, (xe, je)
    hist = m16.fit(n_epochs=3, batch_size=8, hyperparam=dict(lr=1e-3),
                   checkpoint_dict=dict(print_stride=None))
    assert np.isfinite(hist["loss"]).all()
