"""Port parity of the channels-last route (``backend="pallas_reg"``).

The JAX package's ``pallas_reg`` couplings hand the conv's channels-last
output straight to the Pallas kernels (``rqs_transform_fused(...,
channels_last=True)``).  The port's route runs the conditioners
channels-last and gives their output to the channels-last kernels as it
comes.  Here, on the CPU: the kernels' plain versions on a channels-last
``out`` against the JAX kernels in that layout (interpret mode) and
``jax.vjp`` of them, the VJP's ``outbar`` in ``out``'s layout; the layout
rule (:func:`coupling_layout`); an 8x8 flagship on the route, float64,
with the JAX ``pallas_reg`` flagship's leaves transplanted, against the
JAX flagship (whose ``xla`` and ``pallas_reg`` builds share one pytree)
and the port's default route: y, logq, the inverse and the path-gradient
loss's gradients; the conditioners' output channels-last at every
coupling in float32 and bf16; training steps equal to the default
route's; the builders, the bench's arms and the kernel tools' names.
float64 agrees to 1e-10, float32 to the Pallas tests' 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.ops.kernels.spline_coupling import rqs_transform_fused
from normflow__tpu.training import losses as jlosses
from normflow__tpu.utils.serialization import leaves_of, restore_into
from normflow__tpu.zoo import build_phi4_model as jax_build
from normflow__tpu_torch import bench
from normflow__tpu_torch.models.couplings import RQSplineCoupling
from normflow__tpu_torch.models.masks import EvenOddMask
from normflow__tpu_torch.ops.kernels import spline_coupling as sc
from normflow__tpu_torch.tools import kernel_times as kt
from normflow__tpu_torch.utils.transplant import (jax_leaf_grads,
                                                  load_jax_leaves)
from normflow__tpu_torch.zoo import (build_phi4_model,
                                     with_conv_compute_dtype,
                                     with_coupling_backend)
from test_torch_flagship import SMALL, logqp_both, perturbed_leaves

LIM = (-2.0, 2.0)
TOL = 1e-10
RQS_TOL = 1e-4
F64 = dict(dtype=torch.float64, device="cpu")


def _cl(out, dtype):
    """JAX's ``(B, *lat, 3m-2)`` as the port's ``(B, 3m-2, *lat)``
    channels-last view of the same memory."""
    return torch.from_numpy(np.ascontiguousarray(out)).to(dtype).movedim(
        -1, 1)


def _jit0(fn, *args):
    """``fn(*args)`` compiled at XLA's lowest backend optimisation level,
    which compiles several times faster (each case runs once)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _jax_both_ways(m, extrap):
    """Seeded float64 inputs and, for each direction, ``((y, logg),
    (xbar, outbar))`` of the JAX kernels, channels-last, in interpret
    mode: both directions in one program."""
    rng = np.random.default_rng(m + 10 * (extrap is None))
    b, lat = 2, (4, 8)
    x = rng.random((b, *lat)) * 3.6 - 1.8 if extrap is None \
        else rng.standard_normal((b, *lat)) * 0.8
    out = rng.standard_normal((b, *lat, 3 * m - 2))
    cot = tuple(rng.standard_normal((b, *lat)) for _ in range(2))
    kw = dict(xlim=LIM, ylim=LIM, left=extrap, right=extrap)

    def both(xj, oj, cj):
        res = []
        for inverse in (False, True):
            prim, vjp = jax.vjp(lambda a, o, inv=inverse: rqs_transform_fused(
                a, o, channels_last=True, interpret=True, inverse=inv,
                **kw), xj, oj)
            res.append((prim, vjp(cj)))
        return res

    return (x, out, cot), _jit0(both, jnp.asarray(x), jnp.asarray(out),
                                tuple(map(jnp.asarray, cot)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("extrap", [None, "linear"])
@pytest.mark.parametrize("m", [4, 8])
def test_plain_versions_match_jax_channels_last_f64(m, extrap, inverse):
    (x, out, cot), ways = _jax_both_ways(m, extrap)
    prim, (jxbar, joutbar) = ways[inverse]
    kw = dict(xlim=LIM, ylim=LIM, left=extrap, right=extrap, inverse=inverse)
    tout = _cl(out, torch.float64)
    assert sc.coupling_layout(tout) == "channels_last"
    tx = torch.from_numpy(x)
    got = sc.rqs_coupling(tx, tout, **kw)
    xbar, outbar = sc.rqs_coupling_bwd(tx, tout, *map(torch.from_numpy, cot),
                                       **kw)
    assert outbar.stride() == tout.stride()
    for g, w in zip((*got, xbar, outbar.movedim(1, -1)),
                    (*prim, jxbar, joutbar)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_version_matches_jax_channels_last_f32(rng, inverse):
    b, lat, m = 2, (4, 8), 8
    x = (rng.standard_normal((b, *lat)) * 0.8).astype(np.float32)
    out = rng.standard_normal((b, *lat, 3 * m - 2)).astype(np.float32)
    kw = dict(xlim=LIM, ylim=LIM, left="linear", right="linear",
              inverse=inverse)
    got = sc.rqs_coupling(torch.from_numpy(x), _cl(out, torch.float32), **kw)
    want = rqs_transform_fused(jnp.asarray(x), jnp.asarray(out),
                               channels_last=True, interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=RQS_TOL)


def _strided(shape, strides):
    return torch.zeros(10_000).as_strided(shape, strides)


@pytest.mark.parametrize("out,layout", [
    (torch.zeros((2, 10, 4, 6)), "nchw"),
    (torch.zeros((2, 4, 6, 10)).movedim(-1, 1), "channels_last"),
    (torch.zeros((2, 16, 10)).movedim(-1, 1), "channels_last"),  # 1-D
    (torch.zeros((2, 2, 3, 4, 22)).movedim(-1, 1), "channels_last"),  # 3-D
    (torch.zeros((2, 2, 2, 2, 2, 22)).movedim(-1, 1), "channels_last"),  # 4-D
    (torch.zeros((2, 1, 1, 22)).movedim(-1, 1), "nchw"),  # one site: both
    (torch.zeros((2, 10, 1, 1)), "nchw"),
    (torch.zeros((1, 4, 6, 10)).movedim(-1, 1), "channels_last"),
])
def test_coupling_layout_reads_the_strides(out, layout):
    assert sc.coupling_layout(out) == layout


@pytest.mark.parametrize("x,want", [
    (torch.zeros((2, 3, 4, 6)), False),
    (torch.zeros((2, 4, 6, 3)).movedim(-1, 1), True),
    (torch.zeros((2, 1, 4, 6)), False),                    # one channel
    (torch.zeros((2, 4, 6, 1)).movedim(-1, 1), True),      # its stride 1
    (torch.zeros((2, 3, 1, 1)), True),                     # one site
    (torch.zeros((2, 3)), False),
    (torch.zeros((2, 3, 6, 4)).transpose(2, 3), False),
])
def test_one_channels_last_rule(x, want):
    """The conv stack and the wrappers read one rule: a channel stride of
    1 and the sites in order; the wrappers give NCHW the ties."""
    from normflow__tpu_torch.ops.lattice import channels_last

    assert channels_last(x) is want
    if x.shape[1] >= 3 and x.dim() > 2 and (want or x.is_contiguous()):
        assert sc.coupling_layout(x) == (
            "nchw" if x.is_contiguous() else "channels_last")


@pytest.mark.parametrize("out", [
    torch.zeros((2, 10, 6, 4)).transpose(2, 3),           # lattice swapped
    torch.zeros((2, 10, 4, 12)).contiguous(
        memory_format=torch.channels_last)[..., ::2],      # sites apart
    torch.zeros((2, 20, 4, 6))[:, ::2],                    # channels apart
    torch.zeros((1, 10, 1, 6)).expand(2, 10, 4, 6),        # broadcast
    _strided((2, 10, 4, 6), (240, 1, 6, 1)),               # overlapping
])
def test_coupling_layout_refuses_other_strides(out):
    with pytest.raises(ValueError, match="NCHW-contiguous or channels-last"):
        sc.coupling_layout(out)


def test_cpu_tensors_take_any_strides_and_launch_nothing(rng):
    """The device rule: the plain versions, which do not read the layout,
    for CPU tensors of any strides; no kernel count moves."""
    x = torch.from_numpy(rng.standard_normal((2, 4, 6)))
    out = torch.from_numpy(rng.standard_normal((2, 10, 6, 4)))
    before = (sc.rqs_coupling.cl_launches, sc.rqs_coupling_bwd.cl_launches,
              sc.rqs_coupling.launches)
    swapped = out.transpose(2, 3)
    want = sc.rqs_coupling(x, swapped.contiguous(), xlim=LIM, ylim=LIM)
    for o in (swapped, swapped.contiguous(memory_format=torch.channels_last)):
        for g, w in zip(sc.rqs_coupling(x, o, xlim=LIM, ylim=LIM), want):
            assert torch.equal(g, w)
        sc.rqs_coupling_bwd(x, o, x, x, xlim=LIM, ylim=LIM)
    assert (sc.rqs_coupling.cl_launches, sc.rqs_coupling_bwd.cl_launches,
            sc.rqs_coupling.launches) == before


# --------------------------------------------------------------------- #
# the route on the 8x8 flagship
# --------------------------------------------------------------------- #
@pytest.fixture
def twins(rng):
    """The JAX ``pallas_reg`` flagship's leaves, perturbed, in the port's
    ``pallas_reg`` and default flagships and the JAX ``xla`` flagship
    (the JAX ``pallas_reg`` flagship runs its Pallas kernels compiled, not
    on the CPU; its pytree is the ``xla`` one's)."""
    jreg = jax_build(**SMALL, dtype=jnp.float64,
                     coupling_backend="pallas_reg")
    jxla = jax_build(**SMALL, dtype=jnp.float64)
    leaves = perturbed_leaves(jreg.net_, rng)
    assert {k: v.shape for k, v in leaves.items()} == \
        {k: v.shape for k, v in leaves_of(jxla.net_).items()}
    jxla.net_ = restore_into(jxla.net_, leaves)
    ports = {}
    for backend in ("pallas_reg", "xla"):
        ports[backend] = build_phi4_model(**SMALL, coupling_backend=backend,
                                          **F64)
        load_jax_leaves(ports[backend].net_, leaves)
    assert ports["pallas_reg"].net_[2].backend == "pallas_reg"
    return jxla, ports


def test_route_matches_jax_and_the_default_route(rng, twins):
    jmodel, ports = twins
    x = rng.standard_normal((8, 8, 8))
    y = rng.standard_normal((8, 8, 8))
    got, want = logqp_both(jmodel, ports["pallas_reg"], x)
    nchw = logqp_both(jmodel, ports["xla"], x)[0]
    for g, w, n in zip(got, want, nchw):  # y, logJ, logq, logp
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), n.numpy(), rtol=0, atol=TOL)
    inv = ports["pallas_reg"].posterior.log_prob(torch.from_numpy(y))
    np.testing.assert_allclose(
        inv.numpy(), np.asarray(jmodel.posterior.log_prob(jnp.asarray(y))),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        inv.numpy(), ports["xla"].posterior.log_prob(
            torch.from_numpy(y)).numpy(), rtol=0, atol=TOL)


def test_route_path_gradient_matches_jax(rng, twins):
    """The path-gradient loss and its gradients on one draw, against
    ``jax.value_and_grad`` of the JAX fitter's loss and the port's default
    route."""
    jmodel, ports = twins
    x = rng.standard_normal((8, 8, 8))

    def loss_of(net):  # normflow__tpu/training/fitter.py:250-268
        y, _ = net.forward(jnp.asarray(x))
        net_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, net)
        x_inv, mlogj = net_sg.backward(y)
        logq = jmodel.prior.log_prob(x_inv) + mlogj
        return jlosses.calc_kl_mean(logq, -jmodel.action(y))

    want_loss, want_grads = _jit0(jax.value_and_grad(loss_of), jmodel.net_)
    want = leaves_of(want_grads)
    for model in ports.values():
        model.fit.grad_estimator = "path"
        tx = torch.from_numpy(x)
        loss = model.fit.loss_of(tx, model.prior.log_prob(tx))[0]
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=0, atol=TOL)
        got = jax_leaf_grads(model.net_)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                       err_msg=f"leaf {k}")


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_conditioner_output_is_channels_last_at_every_coupling(
        rng, compute_dtype):
    model = build_phi4_model(**SMALL, coupling_backend="pallas_reg",
                             device="cpu")
    net_ = model.net_ if compute_dtype is None else \
        with_conv_compute_dtype(model.net_, compute_dtype)
    seen = []
    for net in net_[2].nets:
        net.register_forward_hook(lambda mod, inp, out: seen.append(
            (sc.coupling_layout(out), out.dtype)))
    x = torch.from_numpy(rng.standard_normal((4, 8, 8))).float()
    with torch.no_grad():
        y, _ = net_.forward(x)
        net_.backward(y)
    assert seen == [("channels_last", torch.float32)] * 4


def test_training_steps_equal_the_default_routes():
    """Two steps of the bench's settings from one seed: the same losses
    and parameters on both routes (float64)."""
    res = []
    for backend in ("xla", "pallas_reg"):
        model = build_phi4_model(**SMALL, coupling_backend=backend, seed=3,
                                 **F64)
        hist = model.fit(n_epochs=2, batch_size=8, grad_estimator="path",
                         hyperparam=dict(lr=3e-3, weight_decay=1e-4),
                         clip_grad_norm=25.0,
                         checkpoint_dict=dict(print_stride=None))
        res.append((np.asarray(hist["loss"]),
                    [p.detach().clone() for p in model.net_.parameters()]))
    (la, pa), (lb, pb) = res
    np.testing.assert_allclose(la, lb, rtol=0, atol=TOL)
    for p, q in zip(pa, pb):
        torch.testing.assert_close(p, q, rtol=0, atol=TOL)


def test_route_is_fixed_and_copies_share_the_weights():
    model = build_phi4_model(**SMALL, device="cpu")
    reg = with_coupling_backend(model.net_, "pallas_reg")
    assert (model.net_[2].backend, reg[2].backend) == ("xla", "pallas_reg")
    assert all(p is q for p, q in zip(model.net_.parameters(),
                                      reg.parameters()))
    assert with_conv_compute_dtype(reg, torch.bfloat16)[2].backend == \
        "pallas_reg"
    with pytest.raises(AttributeError):
        reg[2].backend = "xla"
    with pytest.raises(ValueError, match="backend"):
        with_coupling_backend(model.net_, "mosaic")


def test_backend_copies_are_built_by_the_constructor():
    """``with_coupling_backend`` builds each coupling anew, so the copy
    holds the constructor's checks: a coupling alone is copied too, a 3-D
    lattice's coupling takes the route as a 2-D one's does, and the
    conditioners' weights are shared."""
    cpl = build_phi4_model(**SMALL, device="cpu").net_[2]
    one = with_coupling_backend(cpl, "pallas_reg")
    assert isinstance(one, RQSplineCoupling) and one.backend == "pallas_reg"
    assert all(p is q for p, q in zip(cpl.parameters(), one.parameters()))
    cube = RQSplineCoupling(list(cpl.nets), mask=EvenOddMask(shape=(4, 4, 4)))
    reg = with_coupling_backend(cube, "pallas_reg")
    assert isinstance(reg, RQSplineCoupling) and reg.backend == "pallas_reg"
    assert reg.mask.shape == (4, 4, 4)
    assert all(p is q for p, q in zip(cube.parameters(), reg.parameters()))


def test_route_refuses_other_lattice_ranks():
    """The route builds at every lattice rank (a 3-D lattice here, as the
    JAX package's does); only an unknown backend name is refused."""
    cpl = build_phi4_model(**SMALL, device="cpu").net_[2]
    cube = RQSplineCoupling(list(cpl.nets), mask=EvenOddMask(shape=(4, 4, 4)),
                            backend="pallas_reg")
    assert cube.backend == "pallas_reg"
    with pytest.raises(ValueError, match="backend"):
        RQSplineCoupling(list(cpl.nets), mask=cpl.mask, backend="cuda")
    RQSplineCoupling(list(cpl.nets), mask=EvenOddMask(shape=(4, 4, 4)))


def test_bench_arms():
    model = build_phi4_model(**SMALL, device="cpu")
    assert list(bench.sampling_arms(model, False, 0)) == ["cpu"]
    arms = bench.sampling_arms(model, True, 0)
    assert list(arms) == ["cuda", "cuda_bf16", "cuda_reg"]
    assert arms["cuda"] is model
    for name, backend, dtype in (("cuda_bf16", "xla", torch.bfloat16),
                                 ("cuda_reg", "pallas_reg", None)):
        net_ = arms[name].net_
        assert net_[2].backend == backend
        assert net_[2].nets[0].net.compute_dtype == dtype
        assert all(p is q for p, q in zip(net_.parameters(),
                                          model.net_.parameters()))


@pytest.mark.parametrize("kernel,name,hit", [
    ("rqs_coupling_cl", "void (anonymous namespace)::rqs_coupling_cl_kernel"
     "<8, true, true, false>(float const*)", True),
    ("rqs_coupling_bwd_cl", "void (anonymous namespace)::"
     "rqs_coupling_bwd_cl_kernel<8, true, true, true>(float const*)", True),
    ("rqs_coupling", "void (anonymous namespace)::rqs_coupling_cl_kernel"
     "<8, true, true, false>(float const*)", False),
    ("rqs_coupling_bwd", "rqs_coupling_bwd_cl_kernel<8, true, true, true>",
     False),
    ("rqs_coupling_cl", "rqs_coupling_bwd_cl_kernel<8, true, true, true>",
     False),
    ("rqs_coupling_cl", "rqs_coupling_kernel<8, true, true, true>", False),
    ("rqs_coupling_cl", "void (anonymous namespace)::"
     "rqs_coupling_cl_tiled_kernel<8, true, true, false>(float const*)",
     True),
    ("rqs_coupling_bwd_cl", "void (anonymous namespace)::"
     "rqs_coupling_bwd_cl_tiled_kernel<8, true, true, true>(float const*)",
     True),
    ("rqs_coupling", "rqs_coupling_cl_tiled_kernel<8, true, true, false>",
     False),
    ("rqs_coupling_bwd", "rqs_coupling_bwd_cl_tiled_kernel<8, true, true, "
     "true>", False),
    ("rqs_coupling_cl", "rqs_coupling_bwd_cl_tiled_kernel<8, true, true, "
     "true>", False),
    ("rqs_coupling_cl", "rqs_coupling_tiled_kernel<8, true, true, true>",
     False),
    ("rqs_coupling_bwd_cl", "rqs_coupling_bwd_tiled_kernel<8, true, true, "
     "true>", False),
])
def test_profiler_names_pick_the_channels_last_kernels(kernel, name, hit):
    """Each channels-last kernel's pattern takes both of its variants'
    names and no other kernel's, and counts the tiled one as tiled
    (``device_launches``)."""
    import re

    m = re.search(kt.KERNEL_RE[kernel], name)
    assert bool(m) is hit
    if m:
        assert (m.group(1) is not None) is ("_tiled_" in name)


@pytest.mark.parametrize("name,shape", [
    ("rqs_coupling", (1024, 22, 32, 16)), ("rqs_coupling_bwd",
                                           (512, 22, 32, 16)),
    ("rqs_coupling", (512, 22, 32, 16)), ("rqs_coupling_bwd",
                                          (512, 22, 32, 32))])
def test_channels_last_kernels_do_their_twins_work(name, shape):
    """Both variants of a channels-last kernel move their NCHW twin's
    bytes: at the flagship's shapes 0.0157 ms forward at B = 1024 and
    0.0150 ms backward at B = 512 on an H100 SXM."""
    assert kt.work(name + "_cl", shape) == kt.work(name, shape)
    if shape == (1024, 22, 32, 16) or shape == (512, 22, 32, 16) and \
            name == "rqs_coupling_bwd":
        ms = kt.bound_ms(*kt.work(name + "_cl", shape),
                         kt.card_peaks("NVIDIA H100 80GB HBM3"))[0]
        assert ms == pytest.approx(0.0157 if shape[0] == 1024 else 0.0150,
                                   abs=5e-5)
