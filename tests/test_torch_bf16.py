"""Port parity of the bf16 conditioners, on the CPU.

``CircularConv`` under a compute dtype, ``ConvNet.compute_dtype`` and
``fuse_out_cast``, ``zoo.with_conv_compute_dtype`` and the graph stamp.
The same numpy weights and inputs go into the JAX package and the port in
float32.  Rounding to bf16 is not the same operation in both (two conv
libraries sum in their own orders before they round), so the bars are a
bf16 grain, not 1e-10: each conv layer's bf16 output within 1 bf16 ulp of
the JAX layer's, element by element; a whole ``ConvNet`` and the 8x8
flagship with bf16 conditioners no further from the port's own float32
result than twice the JAX bf16 result is from the JAX float32 one; the
fused last layer (``fuse_out_cast``) within 1e-5 of JAX's
``preferred_element_type`` conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.models import nets as jn
from normflow__tpu.zoo import with_conv_compute_dtype as jax_with_dtype
import normflow__tpu_torch as nt
from normflow__tpu_torch.models import nets as tn
from normflow__tpu_torch.utils.graphs import GraphCache
from normflow__tpu_torch.zoo import with_conv_compute_dtype
from test_torch_flagship import twin_models
from test_torch_modules import transplant

F32 = dict(dtype=torch.float32, device="cpu")
KEY = jax.random.key(11)
LAT = (8, 4)  # a packed 8x8 partition


def _bf16_ulp(a):
    """One bf16 ulp (8 significant bits) at the magnitude of each
    element of ``a``."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _conv_pair(cin, cout, hidden=(), bias=True, **kw):
    acts = ("tanh",) * len(hidden) + (None,)
    jnet = jn.ConvNet.build(KEY, cin, cout, 3, hidden_sizes=hidden,
                            acts=acts, bias=bias, dtype=jnp.float32, **kw)
    tnet = tn.ConvNet(cin, cout, 3, hidden_sizes=hidden, acts=acts,
                      bias=bias, **kw, **F32)
    return jnet, tnet


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("cin,cout", [(2, 24), (24, 22)])
def test_conv_layer_within_one_bf16_ulp(rng, cin, cout, bias):
    """One conditioner layer in bf16, the flagship's widths: the port (the
    conv in bf16, the bias added after it in bf16) against the JAX layer
    with bf16 weights, element by element."""
    jnet, tnet = _conv_pair(cin, cout, bias=bias)
    jnet = transplant(jnet, tnet, rng)
    x = (rng.standard_normal((16, *LAT, cin)) * 2).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                    jnet.layers[0])
    want = np.asarray(jlayer(jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got_t = tnet.layers[0](_nchw(x).to(torch.bfloat16))
    assert got_t.dtype == torch.bfloat16
    got = _nhwc(got_t)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got == want) > 0.99


def test_convnet_bf16_gap_within_twice_jax(rng):
    """The whole conditioner stack (2 -> 24 -> 24 -> 22, tanh) in bf16:
    the port's distance from its float32 output at most twice JAX's.  Both
    nets are built with ``compute_dtype='bfloat16'``: a setting, not a
    leaf, so the transplant carries the weights alone."""
    jnet, tnet = _conv_pair(2, 22, hidden=(24, 24), bias=False,
                            compute_dtype="bfloat16")
    assert tnet.compute_dtype == torch.bfloat16
    jnet = transplant(jnet, tnet, rng)
    x = rng.standard_normal((16, *LAT, 2)).astype(np.float32)
    j16 = np.asarray(jnet(jnp.asarray(x)))
    j32 = np.asarray(jnet.replace(compute_dtype=None)(jnp.asarray(x)))
    with torch.no_grad():
        t16_t = tnet(_nchw(x))
        tnet.compute_dtype = None
        t32 = _nhwc(tnet(_nchw(x)))
    assert t16_t.dtype == torch.float32  # cast back to the caller's dtype
    t16 = _nhwc(t16_t)
    np.testing.assert_allclose(t32, j32, rtol=0, atol=1e-5)
    jgap, tgap = np.abs(j16 - j32).max(), np.abs(t16 - t32).max()
    assert 0 < tgap <= 2 * jgap, (tgap, jgap)


def test_flagship_bf16_conditioners(rng):
    """The 8x8 flagship, the same weights and draws: y and logJ of the
    bf16-conditioner flow no further from the float32 flow than twice
    JAX's gap, in both packages' float32; the round trip to float32
    round-off; the weights shared and still float32."""
    jmodel, model = twin_models(rng, jnp.float32, torch.float32)
    net16 = with_conv_compute_dtype(model.net_, torch.bfloat16)
    assert [p.data_ptr() for p in net16.parameters()] == \
        [p.data_ptr() for p in model.net_.parameters()]
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    convs = [m for m in net16.modules() if isinstance(m, tn.ConvNet)]
    assert len(convs) == 2 and all(
        c.compute_dtype == torch.bfloat16 for c in convs)
    assert all(m.compute_dtype is None for m in model.net_.modules()
               if isinstance(m, tn.ConvNet))
    jnet16 = jax_with_dtype(jmodel.net_, "bfloat16")
    x = rng.standard_normal((32, 8, 8)).astype(np.float32)
    with torch.no_grad():
        t32 = [a.numpy() for a in model.net_.forward(torch.from_numpy(x))]
        t16 = [a.numpy() for a in net16.forward(torch.from_numpy(x))]
    j32 = [np.asarray(a) for a in jax.jit(
        lambda n, x: n.forward(x))(jmodel.net_, jnp.asarray(x))]
    j16 = [np.asarray(a) for a in jax.jit(
        lambda n, x: n.forward(x))(jnet16, jnp.asarray(x))]
    for what, a32, a16, b32, b16 in zip(("y", "logJ"), t32, t16, j32, j16):
        np.testing.assert_allclose(a32, b32, rtol=1e-5, atol=1e-4,
                                   err_msg=what)
        tgap, jgap = np.abs(a16 - a32).max(), np.abs(b16 - b32).max()
        assert 0 < tgap <= 2 * jgap, (what, tgap, jgap)
    with torch.no_grad():
        y, logj = net16.forward(torch.from_numpy(x))
        x2, log0 = net16.backward(y, log0=logj)
    assert np.abs(x2.numpy() - x).max() < 2e-5
    assert np.abs(log0.numpy()).max() < 2e-4 * (1 + np.abs(t16[1]).max())


def test_fuse_out_cast_matches_jax(rng):
    """The fused last layer: a float32 conv of the bf16-rounded input and
    weights against JAX's ``preferred_element_type=float32`` conv, with
    and without a bias."""
    for bias in (True, False):
        jnet, tnet = _conv_pair(24, 22, bias=bias)
        jnet = transplant(jnet, tnet, rng)
        x = rng.standard_normal((16, *LAT, 24)).astype(np.float32)
        want = np.asarray(jnet.replace(compute_dtype="bfloat16",
                                       fuse_out_cast=True)(jnp.asarray(x)))
        tnet.compute_dtype, tnet.fuse_out_cast = torch.bfloat16, True
        with torch.no_grad():
            got = _nhwc(tnet(_nchw(x)))
            tnet.fuse_out_cast = False
            unfused = _nhwc(tnet(_nchw(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.abs(unfused - want).max() > 1e-4  # bf16 rounding shows


def test_compute_dtype_in_the_graph_stamp():
    """A compute dtype set in place on the same module changes the stamp,
    so a ``GraphCache`` keyed by it captures anew instead of replaying the
    float32 graph; a bf16 arm on a ``Model`` of its own keeps a cache of
    its own, so switching arms drops neither's graphs."""
    model = nt.zoo.build_phi4_model((8, 8), knots=4, hidden=(4,),
                                    n_layers=2, device="cpu")
    arm16 = nt.Model(net_=with_conv_compute_dtype(model.net_, "bfloat16"),
                     prior=model.prior, action=model.action)
    caches = {id(model): GraphCache(), id(arm16): GraphCache()}
    made = []

    def get(m):
        return caches[id(m)].get("batch", m.graph_stamp(),
                                 lambda: made.append(m) or len(made))

    assert get(model) == get(model) == 1
    assert get(arm16) == get(arm16) == 2
    for _ in range(3):  # the bench's arms in turns: no capture
        assert (get(model), get(arm16)) == (1, 2)
    convs = [m for m in model.net_.modules() if isinstance(m, tn.ConvNet)]
    for c in convs:
        c.compute_dtype = torch.bfloat16
    assert get(model) == 3  # not the float32 graph
    convs[0].fuse_out_cast = True
    assert get(model) == 4
    assert model.fit.step_graph() is None  # the CPU runs eagerly
