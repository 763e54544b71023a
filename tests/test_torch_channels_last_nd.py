"""Port parity of the channels-last route (``backend="pallas_reg"``) at 1-,
3- and 4-D, on the CPU.

The JAX package takes its ``pallas_reg`` route at every lattice rank: the
couplings hand the conv's channels-last output to the fused kernels
(``rqs_transform_fused(..., channels_last=True)``), whose wrapper flattens
any rank, and ``build_phi4_model(lat, coupling_backend=...)`` passes the
backend at every rank.  The port's route runs the conditioners
channels-last at 1 to 4 lattice dims (a 1-D conv as a 2-D conv over a unit
axis, a 4-D conv as one 3-D conv of the free ``(B L0, C, L1, L2, L3)``
view with the kernel slices stacked, its outputs rolled and summed).  Here,
at ``(8,)``, ``(4, 4, 4)`` and ``(4, 4, 4, 4)``, the small unpacked
flagship (``hidden=(4,), n_layers=2, knots=4``) on the route with the JAX
``pallas_reg`` flagship's leaves, perturbed by seeded numpy noise and
transplanted, against the JAX ``xla`` flagship (whose pytree is the
``pallas_reg`` one's: JAX's Pallas kernels run compiled, not on the CPU)
and the port's default route: ``y``, the log-Jacobian, logq, logp and the
inverse; the path-gradient loss and its gradients on one draw against
``jax.value_and_grad``; two training steps equal to the default route's;
``with_coupling_backend`` at each rank, sharing the weights; the channels-
last convs against the NCHW ones, layer by layer, with dilation, an even
kernel, a bias and a cast output.  Float64 to 1e-10.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch.models.couplings import RQSplineCoupling
from normflow__tpu_torch.models.nets import CircularConv
from normflow__tpu_torch.ops.lattice import channels_last
from normflow__tpu_torch.utils.transplant import (jax_leaf_grads,
                                                  load_jax_leaves)
from normflow__tpu_torch.zoo import build_phi4_model, with_coupling_backend
from test_torch_cntr import _jit0

LATS = [(8,), (4, 4, 4), (4, 4, 4, 4)]
SMALL = dict(packed=False, hidden=(4,), n_layers=2, knots=4)
TOL = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL)


def _perturbed(jax_tree, rng, scale=0.3):
    """Leaves plus N(0, scale^2) noise; conv leaves (``(*kernel, in,
    out)``, 3 or more axes) get it scaled by their init bound
    1/sqrt(fan_in)."""
    leaves = leaves_of(jax_tree)
    for k, a in leaves.items():
        s = scale / np.sqrt(np.prod(a.shape[:-1])) if a.ndim >= 3 else scale
        leaves[k] = a + rng.standard_normal(a.shape) * s
    return leaves


def _jax_reference(jmodel, x, y2, x2):
    """The JAX flagship's side of both parity tests in one program: ``(y,
    logJ, logq, logp)`` of ``x`` and ``log_prob(y2)``, and the
    path-gradient loss of ``x2`` with its gradients (``jax.value_and_grad``
    of the JAX fitter's loss, ``normflow__tpu/training/fitter.py:250-268``)."""

    def loss_of(net, xj):
        y, _ = net.forward(xj)
        net_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, net)
        x_inv, mlogj = net_sg.backward(y)
        logq = jmodel.prior.log_prob(x_inv) + mlogj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    def both(net, xj, yj, xj2):
        jy, jlogj = net.forward(xj)
        return ((jy, jlogj, jmodel.prior.log_prob(xj) - jlogj,
                 -jmodel.action(jy), jmodel.posterior.log_prob(yj)),
                jax.value_and_grad(loss_of)(net, xj2))

    return _jit0(both, jmodel.net_, *map(jnp.asarray, (x, y2, x2)))


@contextlib.contextmanager
def _quick_init():
    """JAX's ``unsafe_rbg`` random numbers inside the block: the JAX
    package's ``build_phi4_model`` then compiles its conv init in a
    fraction of threefry's time.  The initial weights only seed the
    perturbed leaves that replace them in both packages."""
    impl = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "unsafe_rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", impl)


@pytest.fixture(scope="module", params=LATS, ids=lambda lat: f"{len(lat)}d")
def twins(request):
    """At one lattice: the port's ``pallas_reg`` and ``xla`` flagships with
    the JAX ``pallas_reg`` flagship's perturbed leaves, the draws, and the
    JAX ``xla`` flagship's outputs on them with those leaves
    (:func:`_jax_reference`)."""
    lat = request.param
    rng = np.random.default_rng(20261024 + len(lat))
    with _quick_init():
        jreg = jax_build(lat, **SMALL, dtype=jnp.float64,
                         coupling_backend="pallas_reg")
        jxla = jax_build(lat, **SMALL, dtype=jnp.float64)
    leaves = _perturbed(jreg.net_, rng)
    assert {k: v.shape for k, v in leaves.items()} == \
        {k: v.shape for k, v in leaves_of(jxla.net_).items()}
    jxla.net_ = restore_into(jxla.net_, leaves)
    ports = {}
    for backend in ("pallas_reg", "xla"):
        ports[backend] = build_phi4_model(lat, **SMALL, **F64,
                                          coupling_backend=backend)
        load_jax_leaves(ports[backend].net_, leaves)
    assert [c.backend for c in ports["pallas_reg"].net_
            if isinstance(c, RQSplineCoupling)] == ["pallas_reg"]
    draws = [rng.standard_normal((n, *lat)) for n in (4, 3, 5)]
    return ports, draws, _jax_reference(jxla, *draws)


def test_route_matches_jax_and_the_default_route(twins):
    """Per sample ``y``, the log-Jacobian, logq, logp and the inverse's
    ``log_prob`` of fresh configurations on the route, against the JAX
    flagship and the port's default route; the route's round trip."""
    ports, (x, y2, _), (want, _) = twins
    got = {}
    for backend, model in ports.items():
        with torch.no_grad():
            tx = torch.from_numpy(x)
            y, logj = model.net_.forward(tx)
            got[backend] = (y, logj, model.prior.log_prob(tx) - logj,
                            -model.action(y),
                            model.posterior.log_prob(torch.from_numpy(y2)))
    for name, a, b, w in zip(("y", "logj", "logq", "logp", "log_prob"),
                             got["pallas_reg"], got["xla"], want):
        assert a.shape == np.shape(w), name
        _close(a.numpy(), w)
        _close(a.numpy(), b.numpy())
    y, logj = got["pallas_reg"][:2]
    with torch.no_grad():
        x_back, log0 = ports["pallas_reg"].net_.backward(y, log0=logj)
    _close(x_back.numpy(), x)
    _close(log0.numpy(), np.zeros(len(x)))


def test_route_path_gradient_matches_jax(twins):
    """The path-gradient loss and its gradients on one draw, against
    ``jax.value_and_grad`` of the JAX fitter's loss, on both routes."""
    ports, (_, _, x), (_, (want_loss, want_grads)) = twins
    want = leaves_of(want_grads)
    for model in ports.values():
        model.net_.zero_grad(set_to_none=True)
        model.fit.grad_estimator = "path"
        tx = torch.from_numpy(x)
        loss = model.fit.loss_of(tx, model.prior.log_prob(tx))[0]
        loss.backward()
        _close(float(loss.detach()), float(want_loss))
        got = jax_leaf_grads(model.net_)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                       err_msg=f"leaf {k}")


@pytest.mark.parametrize("lat", LATS, ids=lambda lat: f"{len(lat)}d")
def test_training_steps_equal_the_default_routes(lat):
    """Two steps of the bench's settings from one seed: the same losses
    and parameters on both routes."""
    res = []
    for backend in ("xla", "pallas_reg"):
        model = build_phi4_model(lat, **SMALL, **F64, seed=3,
                                 coupling_backend=backend)
        hist = model.fit(n_epochs=2, batch_size=8, grad_estimator="path",
                         hyperparam=dict(lr=3e-3, weight_decay=1e-4),
                         clip_grad_norm=25.0,
                         checkpoint_dict=dict(print_stride=None))
        res.append((np.asarray(hist["loss"]),
                    [p.detach().clone() for p in model.net_.parameters()]))
    (la, pa), (lb, pb) = res
    assert np.isfinite(la).all()
    _close(la, lb)
    for p, q in zip(pa, pb):
        torch.testing.assert_close(p, q, rtol=0, atol=TOL)


@pytest.mark.parametrize("lat", LATS, ids=lambda lat: f"{len(lat)}d")
def test_with_coupling_backend_shares_the_weights(lat):
    """``with_coupling_backend`` at each rank: every coupling of the copy
    on the route, the weights the same tensors, the route's output that of
    ``build_phi4_model(..., coupling_backend="pallas_reg")``; the
    conditioner's input a channels-last view of the frozen partition, no
    copy."""
    model = build_phi4_model(lat, **SMALL, **F64, seed=5)
    reg = with_coupling_backend(model.net_, "pallas_reg")
    built = build_phi4_model(lat, **SMALL, **F64, seed=5,
                             coupling_backend="pallas_reg")
    assert (model.net_[2].backend, reg[2].backend) == ("xla", "pallas_reg")
    assert all(p is q for p, q in zip(model.net_.parameters(),
                                      reg.parameters()))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, *lat)))
    with torch.no_grad():
        for a, b in zip(reg.forward(x), built.net_.forward(x)):
            assert torch.equal(a, b)
    frozen = x.clone()
    net_in = reg[2]._net_input(frozen)
    assert net_in.shape == (3, 1, *lat) and channels_last(net_in)
    assert net_in.data_ptr() == frozen.data_ptr()
    assert not channels_last(model.net_[2]._net_input(frozen))


def _nchw_and_channels_last(conv, x, **kw):
    """``conv`` on NCHW ``x`` and on the same values channels-last."""
    xcl = x.movedim(1, -1).contiguous().movedim(-1, 1)
    assert channels_last(xcl) and not channels_last(x)
    return conv(x, **kw), conv(xcl, **kw)


@pytest.mark.parametrize("dim,lat", [(1, (7,)), (3, (3, 4, 5)),
                                     (4, (5, 3, 4, 2)), (4, (1, 3, 2, 4))])
@pytest.mark.parametrize("kernel,dilation,bias", [(3, 1, False),
                                                  (3, 2, True),
                                                  (2, 1, True)])
def test_channels_last_conv_matches_nchw(dim, lat, kernel, dilation, bias):
    """A ``CircularConv`` on channels-last data (the route's pad, the 1-D
    conv over a unit axis, the 4-D conv's stacked slices with their
    rolled outputs) equals it on NCHW data, value and gradient, and its
    output is channels-last where the conv's is; with ``out_dtype`` too
    (the bias after the conv)."""
    gen = torch.Generator().manual_seed(dim + 10 * kernel + dilation)
    conv = CircularConv(3, 5, kernel, conv_dim=dim, bias=bias,
                        dilation=dilation, generator=gen, dtype=torch.float64)
    x = torch.randn((2, 3, *lat), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    a, b = _nchw_and_channels_last(conv, x)
    _close(b.detach().numpy(), a.detach().numpy())
    if dim == 4:  # the sum of the rolled slices is made channels-last
        assert channels_last(b)
    cot = torch.randn(a.shape, generator=gen, dtype=torch.float64)
    ga = torch.autograd.grad(a, [x, conv.weight], cot)
    gb = torch.autograd.grad(b, [x, conv.weight], cot)
    for u, v in zip(gb, ga):
        _close(u.numpy(), v.numpy())
    with torch.no_grad():
        a, b = _nchw_and_channels_last(conv, x.detach().float(),
                                       out_dtype=torch.float64)
    assert a.dtype == b.dtype == torch.float64
    _close(b.numpy(), a.numpy())
