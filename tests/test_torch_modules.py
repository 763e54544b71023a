"""Port parity per module, after a transplant of perturbed JAX weights.

Each JAX module is built, every leaf is perturbed with seeded numpy noise
(a freshly built flow has zero spline weights, which would leave most of
the map untested), the leaves go into the JAX module and, through
``load_jax_leaves``, into its port; ``forward`` and ``backward`` must then
agree on ``y`` and ``logJ`` to 1e-10 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models import couplings as jc
from normflow__tpu.models import elementwise as je
from normflow__tpu.models import masks as jm
from normflow__tpu.models import nets as jn
from normflow__tpu.models import priors as jpr
from normflow__tpu.models import spectral as js
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu_torch.models import couplings as tc
from normflow__tpu_torch.models import elementwise as te
from normflow__tpu_torch.models import masks as tm
from normflow__tpu_torch.models import nets as tn
from normflow__tpu_torch.models import priors as tpr
from normflow__tpu_torch.models import spectral as ts
from normflow__tpu_torch.utils.transplant import load_jax_leaves

TOL = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def perturbed_leaves(jax_tree, rng, scale=0.3):
    """Leaves plus N(0, scale^2) noise; 4-D (conv) leaves get noise scaled
    by their init bound 1/sqrt(fan_in)."""
    leaves = leaves_of(jax_tree)
    for k, a in leaves.items():
        s = scale / np.sqrt(np.prod(a.shape[:-1])) if a.ndim == 4 else scale
        leaves[k] = a + rng.standard_normal(a.shape) * s
    return leaves


def transplant(jax_tree, port, rng):
    leaves = perturbed_leaves(jax_tree, rng)
    load_jax_leaves(port, leaves)
    return restore_into(jax_tree, leaves)


def assert_flows_agree(jflow, tflow, x, tol=TOL):
    for direction in ("forward", "backward"):
        jy, jlogj = getattr(jflow, direction)(jnp.asarray(x))
        with torch.no_grad():
            ty, tlogj = getattr(tflow, direction)(torch.from_numpy(x))
        assert ty.shape == jy.shape and tlogj.shape == jlogj.shape
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(tlogj.numpy(), np.asarray(jlogj), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("final_scale", [False, True])
def test_dist_convertor(rng, final_scale):
    jflow = je.DistConvertor.build(8, symmetric=True, smooth=True,
                                   final_scale=final_scale)
    tflow = te.DistConvertor(8, smooth=True, final_scale=final_scale, **F64)
    jflow = transplant(jflow, tflow, rng)
    assert_flows_agree(jflow, tflow, rng.standard_normal((6, 4, 4)) * 2)


@pytest.mark.parametrize("lat", [(8, 8), (6, 5)])
def test_psd_block(rng, lat):
    """Even and odd last extents: the rfft Nyquist plane enters logJ only
    for an even one."""
    jflow = js.PSDBlock(
        mfnet=js.MeanFieldFlow.build(8, symmetric=True, smooth=True,
                                     final_scale=True),
        fftnet=js.FFTFlow.build(lat, knots_len=8, ignore_zeromode=True))
    tflow = ts.PSDBlock(
        mfnet=ts.MeanFieldFlow(8, smooth=True, final_scale=True, **F64),
        fftnet=ts.FFTFlow(lat, knots_len=8, ignore_zeromode=True, **F64))
    jflow = transplant(jflow, tflow, rng)
    assert_flows_agree(jflow, tflow, rng.standard_normal((5, *lat)))


@pytest.mark.parametrize("bias", [False, True])
def test_convnet_row_parity(rng, bias):
    kw = dict(conv_dim=2, hidden_sizes=(4,), acts=("tanh", None), bias=bias)
    jnet = jn.RowParityFeature(net=jn.ConvNet.build(
        jax.random.key(3), 2, 10, 3, **kw))
    tnet = tn.RowParityFeature(tn.ConvNet(2, 10, 3, **kw, **F64))
    jnet = transplant(jnet, tnet, rng)
    x = rng.standard_normal((3, 8, 4))
    want = jnet(jnp.asarray(x)[..., None])              # (B, H, W, C)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x).unsqueeze(1))    # (B, C, H, W)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1,
                                                        1), rtol=0, atol=TOL)


@pytest.mark.parametrize("parity", [0, 1])
def test_packed_mask_split_cat(rng, parity):
    jmask = jm.PackedEvenOddMask(shape=(8, 6), parity=parity)
    tmask = tm.PackedEvenOddMask(shape=(8, 6), parity=parity)
    x = rng.standard_normal((3, 8, 6))
    jparts = jmask.split(jnp.asarray(x))
    tparts = tmask.split(torch.from_numpy(x))
    for g, w in zip(tparts, jparts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tmask.cat(*tparts).numpy(), x)
    np.testing.assert_array_equal(
        tmask.cat(*tparts).numpy(), np.asarray(jmask.cat(*jparts)))


def test_rq_spline_coupling(rng):
    m, lat = 4, (8, 8)
    kw = dict(conv_dim=2, hidden_sizes=(4,), acts=("tanh", None), bias=False)
    keys = jax.random.split(jax.random.key(5), 2)
    jflow = jc.RQSplineCoupling.build(
        tuple(jn.RowParityFeature(net=jn.ConvNet.build(k, 2, 3 * m - 2, 3,
                                                       **kw))
              for k in keys),
        mask=jm.PackedEvenOddMask(shape=lat), xlim=(-4.0, 4.0),
        ylim=(-4.0, 4.0), extrap={"left": "linear", "right": "linear"})
    tflow = tc.RQSplineCoupling(
        [tn.RowParityFeature(tn.ConvNet(2, 3 * m - 2, 3, **kw, **F64))
         for _ in keys],
        mask=tm.PackedEvenOddMask(shape=lat), xlim=(-4.0, 4.0),
        ylim=(-4.0, 4.0), extrap={"left": "linear", "right": "linear"})
    jflow = transplant(jflow, tflow, rng)
    assert_flows_agree(jflow, tflow, rng.standard_normal((4, *lat)) * 1.5)


def test_normal_prior_log_prob(rng):
    loc, scale = rng.standard_normal((4, 4)), rng.random((4, 4)) + 0.5
    jprior = jpr.NormalPrior.build(loc=loc, scale=scale)
    tprior = tpr.NormalPrior(loc, scale, **F64)
    x = rng.standard_normal((5, 4, 4))
    for density in (False, True):
        np.testing.assert_allclose(
            tprior.log_prob(torch.from_numpy(x), density=density).numpy(),
            np.asarray(jprior.log_prob(jnp.asarray(x), density=density)),
            rtol=0, atol=TOL)


def test_transplant_rejects_mismatch(rng):
    jflow = je.DistConvertor.build(8, symmetric=True, smooth=True)
    leaves = leaves_of(jflow)
    with pytest.raises(ValueError, match="architecture"):
        load_jax_leaves(te.DistConvertor(8, smooth=True, final_scale=True,
                                         **F64), leaves)
    with pytest.raises(ValueError, match="shape"):
        load_jax_leaves(te.DistConvertor(6, smooth=True, **F64), leaves)
