"""Port parity of the conditioner nets, on the CPU, with
``test_torch_flow_zoo.py``'s helpers: every activation, 1-4 spatial dims
with dilations, and the linear stacks; outputs and parameter gradients
agree with the JAX package to 1e-10 (relative above 1) in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models import nets as jn
from normflow__tpu.utils.serialization import leaves_of
from normflow__tpu_torch.models import nets as tn
from normflow__tpu_torch.utils.transplant import jax_leaf_grads
from test_torch_flow_zoo import F64, KEY, LAT, TOL, _conv_pair, _t
from test_torch_modules import transplant


# -------------------------------------------------------------------- nets
ACTS = list(jn.ACTIVATIONS)


@pytest.mark.parametrize("act", ACTS)
def test_convnet_activation(rng, act):
    """Every activation, after a first layer; ``logit`` behind an
    ``expit``, and a ``pre_act``."""
    assert set(ACTS) == set(tn.ACTIVATIONS)
    acts = ("tanh", "expit", act) if act == "logit" else ("tanh", act,
                                                            None)
    kw = dict(conv_dim=2, hidden_sizes=(3, 3), acts=acts, pre_act="tanh")
    jnet, tnet = _conv_pair(KEY, 2, 3, **kw)
    jnet = transplant(jnet, tnet, rng)
    _check_net(jnet, tnet, rng.standard_normal((2, *LAT, 2)), rng)


def _close(got, want):
    """Within 1e-10 of ``want``, relative where ``|want|`` exceeds 1 (the
    ``logit`` activation's gradients reach 1e3)."""
    np.testing.assert_array_less(np.abs(got - want),
                                 TOL * np.maximum(1.0, np.abs(want)) + 1e-300)


def _check_net(jnet, tnet, x, rng, channels_last=True):
    """Outputs and parameter gradients; conv nets take NCHW in the port."""
    def to_port(a):
        return np.moveaxis(a, -1, 1) if channels_last else a

    want = np.asarray(jnet(jnp.asarray(x)))
    c = rng.standard_normal(want.shape)
    tx = _t(to_port(x))
    got = tnet(tx)
    _close(got.detach().numpy(), to_port(want))
    gw = leaves_of(jax.grad(lambda n: jnp.sum(n(jnp.asarray(x)) * c))(jnet))
    torch.sum(got * _t(to_port(c))).backward()
    gg = jax_leaf_grads(tnet)
    for k in gw:
        _close(gg[k], gw[k])


@pytest.mark.parametrize("conv_dim,lat,ks,dil", [
    (1, (7,), 3, (1, 2)), (2, (6, 6), 4, (2, 3)), (3, (4, 5, 3), 3, 2),
    (4, (4, 3, 5, 4), 3, (1, 2))])
def test_circular_conv_dims_and_dilations(rng, conv_dim, lat, ks, dil):
    """1-4 spatial dims (4-D by roll and sum), odd and even kernels, per
    layer dilations that wrap the lattice."""
    kw = dict(conv_dim=conv_dim, hidden_sizes=(2,), acts=("tanh", None),
              dilations=dil)
    jnet = jn.ConvNet.build(KEY, 2, 3, ks, **kw)
    tnet = tn.ConvNet(2, 3, ks, **kw, **F64)
    jnet = transplant(jnet, tnet, rng)
    _check_net(jnet, tnet, rng.standard_normal((2, *lat, 2)), rng)


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("final_bias", [False, True])
def test_linear_net(rng, final_bias, axis):
    kw = dict(hidden_sizes=(4,), acts=("relu", "softplus"), pre_act="abs",
              final_bias=final_bias, features_axis=axis)
    jnet = jn.LinearNet.build(KEY, 3, 2, **kw)
    tnet = tn.LinearNet(3, 2, **kw, **F64)
    jnet = transplant(jnet, tnet, rng)
    x = rng.standard_normal((4, 3, 5) if axis == 1 else (4, 5, 3))
    _check_net(jnet, tnet, x, rng, channels_last=False)
    assert tuple(tnet.layers[0].weight.shape) == (4, 3)  # (out, in)
