"""The JAX package's ``build`` factories on the port's classes.

Each class the JAX package builds through ``X.build(...)``
(``models/priors.py:85, 129``, ``models/elementwise.py:83-482``,
``models/spectral.py:40, 81, 166, 246``, ``models/nets.py:77, 172, 280,
303, 324``, ``models/couplings.py:234, 302``, ``models/actions.py:195``)
has a ``build`` classmethod on the port that forwards to the constructor
(a ``torch.Generator`` where the JAX one takes a key first).  Each case
builds both with the same arguments, transplants the JAX object's perturbed
leaves into the port's where it has any, and holds what the two compute on
the same numpy input to 1e-10 in float64.  The JAX package's canonical
zero-dim drive (``nf.nn.DistConvertor_.build(10, symmetric=True)``, a fit,
MCMC and the round trip) runs on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflow__tpu as nf
import normflow__tpu.models as jm
import normflow__tpu_torch as nt
import normflow__tpu_torch.models as tm
from normflow__tpu.utils.serialization import restore_into
from normflow__tpu_torch.utils.transplant import load_jax_leaves
from test_torch_flagship import perturbed_leaves

F64 = dict(dtype=torch.float64)
LAT = (4, 4)
KEY = jax.random.key(2)


def gen():
    return torch.Generator().manual_seed(2)


def conv_nets(jax_side, n, c_in, c_out):
    """``n`` two-layer ``ConvAct`` conditioners."""
    kw = dict(kernel_size=3, conv_dim=2, hidden_sizes=(3,),
              acts=("tanh", None))
    if jax_side:
        return tuple(nf.nn.ConvAct.build(k, c_in, c_out, **kw)
                     for k in jax.random.split(KEY, n))
    g = gen()
    return [nt.nn.ConvAct.build(g, c_in, c_out, **kw, **F64)
            for _ in range(n)]


def flow(obj, arr):
    """A flow's ``(y, logJ)``."""
    return obj.forward(arr)


def call(obj, arr):
    return obj(arr)


def log_prob(obj, arr):
    return obj.log_prob(arr)


def nhwc(obj, arr):
    """A JAX conv net on channels-last data, the port's on NCHW."""
    if isinstance(arr, torch.Tensor):
        return obj(arr.movedim(-1, 1)).movedim(1, -1)
    return obj(arr)


def real(shape):
    return lambda rng: rng.standard_normal(shape)


def unit(shape):
    return lambda rng: rng.uniform(0.02, 0.98, shape)


def phase(shape):
    return lambda rng: rng.uniform(-3.0, 3.0, shape)


def links(rng):
    return np.exp(1j * rng.uniform(-np.pi, np.pi, (3, 2, *LAT)))


KERNEL_K2 = np.linspace(0.0, 1.0, 12).reshape(3, 4)

# id: (JAX build, port build, evaluation, input)
CASES = {
    "NormalPrior": (lambda: jm.NormalPrior.build(shape=LAT),
                    lambda: tm.NormalPrior.build(shape=LAT, **F64),
                    log_prob, real((3, *LAT))),
    "UniformPrior": (lambda: jm.UniformPrior.build(shape=LAT),
                     lambda: tm.UniformPrior.build(shape=LAT, **F64),
                     log_prob, unit((3, *LAT))),
    "Scale": (lambda: nf.nn.ScaleNet_.build(),
              lambda: nt.nn.ScaleNet_.build(**F64), flow, real((3, *LAT))),
    "Pade11": (lambda: nf.nn.Pade11_.build(n_channels=3),
               lambda: nt.nn.Pade11_.build(n_channels=3, **F64), flow,
               unit((2, 4, 3))),
    "Pade22": (lambda: nf.nn.Pade22_.build(n_channels=3, symmetric=True),
               lambda: nt.nn.Pade22_.build(n_channels=3, symmetric=True,
                                           **F64), flow, unit((2, 4, 3))),
    "Pade32": (lambda: nf.nn.Pade32_.build(n_channels=3),
               lambda: nt.nn.Pade32_.build(n_channels=3, **F64), flow,
               real((2, 4, 3))),
    "SgnBias": (lambda: nf.nn.SgnBiasNet_.build(),
                lambda: nt.nn.SgnBiasNet_.build(**F64), flow,
                real((3, *LAT))),
    "SplineFlow": (lambda: nf.nn.SplineNet_.build(6, smooth=True),
                   lambda: nt.nn.SplineNet_.build(6, smooth=True, **F64),
                   flow, unit((3, *LAT))),
    "UnityDistConvertor": (
        lambda: nf.nn.UnityDistConvertor_.build(6, symmetric=True),
        lambda: nt.nn.UnityDistConvertor_.build(6, symmetric=True, **F64),
        flow, unit((3, *LAT))),
    "PhaseDistConvertor": (
        lambda: nf.nn.PhaseDistConvertor_.build(6, symmetric=True),
        lambda: nt.nn.PhaseDistConvertor_.build(6, symmetric=True, **F64),
        flow, phase((3, *LAT))),
    "DistConvertor": (
        lambda: nf.nn.DistConvertor_.build(10, final_scale=True),
        lambda: nt.nn.DistConvertor_.build(10, final_scale=True, **F64),
        flow, real((3, *LAT))),
    "IPSD": (lambda: jm.spectral.IPSD.build(6, logy=[0.1, 0.3],
                                            ignore_zeromode=True),
             lambda: tm.spectral.IPSD.build(6, logy=[0.1, 0.3],
                                            ignore_zeromode=True, **F64),
             call, lambda rng: KERNEL_K2),
    "IPSDNoZeroMode": (
        lambda: jm.spectral.IPSDNoZeroMode.build(6, logy=[0.2]),
        lambda: tm.spectral.IPSDNoZeroMode.build(6, logy=[0.2], **F64),
        call, lambda rng: KERNEL_K2),
    "FFTFlow": (lambda: nf.nn.FFTNet_.build(LAT, knots_len=5,
                                            eff_mass2=0.7,
                                            ignore_zeromode=True),
                lambda: nt.nn.FFTNet_.build(LAT, knots_len=5, eff_mass2=0.7,
                                            ignore_zeromode=True, **F64),
                flow, real((3, *LAT))),
    "MeanFieldFlow": (lambda: nf.nn.MeanFieldNet_.build(6),
                      lambda: nt.nn.MeanFieldNet_.build(6, **F64), flow,
                      real((3, *LAT))),
    "CircularConv": (lambda: nf.nn.ConvNd.build(KEY, 2, 3, 3),
                     lambda: nt.nn.ConvNd.build(gen(), 2, 3, 3, **F64),
                     nhwc, real((2, *LAT, 2))),
    "ConvNet": (lambda: nf.nn.ConvAct.build(KEY, 2, 3, 3, hidden_sizes=(4,),
                                            acts=("tanh", None)),
                lambda: nt.nn.ConvAct.build(gen(), 2, 3, 3,
                                            hidden_sizes=(4,),
                                            acts=("tanh", None), **F64),
                nhwc, real((2, *LAT, 2))),
    "Dense": (lambda: jm.nets.Dense.build(KEY, 5, 3),
              lambda: tm.nets.Dense.build(gen(), 5, 3, **F64), call,
              real((4, 5))),
    "PlusBias": (lambda: jm.nets.PlusBias.build(KEY, 3),
                 lambda: tm.nets.PlusBias.build(gen(), 3, **F64), call,
                 real((4, 3))),
    "LinearNet": (lambda: nf.nn.LinearAct.build(KEY, 5, 2, hidden_sizes=(3,),
                                                acts=("tanh", None),
                                                final_bias=True),
                  lambda: nt.nn.LinearAct.build(gen(), 5, 2,
                                                hidden_sizes=(3,),
                                                acts=("tanh", None),
                                                final_bias=True, **F64),
                  call, real((4, 5))),
    "RQSplineCoupling": (
        lambda: nf.nn.RQSplineCoupling_.build(
            conv_nets(True, 2, 1, 10), mask=nf.mask.EvenOddMask(shape=LAT),
            xlim=(-4.0, 4.0), ylim=(-4.0, 4.0),
            extrap={"left": "linear", "right": "linear"}),
        lambda: nt.nn.RQSplineCoupling_.build(
            conv_nets(False, 2, 1, 10), mask=nt.mask.EvenOddMask(shape=LAT),
            xlim=(-4.0, 4.0), ylim=(-4.0, 4.0),
            extrap={"left": "linear", "right": "linear"}),
        flow, real((3, *LAT))),
    "MultiRQSplineCoupling": (
        lambda: nf.nn.MultiRQSplineCoupling_.build(
            conv_nets(True, 2, 2, 20), mask=nf.mask.EvenOddMask(shape=LAT)),
        lambda: nt.nn.MultiRQSplineCoupling_.build(
            conv_nets(False, 2, 2, 20), mask=nt.mask.EvenOddMask(shape=LAT)),
        flow, unit((3, *LAT, 2))),
    "SchwingerAction": (
        lambda: nf.action.SchwingerAction.build(beta=2.0),
        lambda: nt.action.SchwingerAction.build(beta=2.0), call, links),
}


def _numpy(out):
    if isinstance(out, (tuple, list)):
        return [_numpy(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    return np.asarray(out)


@pytest.mark.parametrize("name", list(CASES))
def test_build_matches_jax(rng, name):
    jax_build, port_build, evaluate, make_input = CASES[name]
    jobj, pobj = jax_build(), port_build()
    assert type(pobj).__name__ == type(jobj).__name__
    if isinstance(pobj, torch.nn.Module) and any(
            p.requires_grad for p in pobj.parameters()):
        leaves = perturbed_leaves(jobj, rng, scale=0.2)
        jobj = restore_into(jobj, leaves)
        load_jax_leaves(pobj, leaves)
    arr = make_input(rng)
    want = _numpy(evaluate(jobj, jnp.asarray(arr)))
    with torch.no_grad():
        got = _numpy(evaluate(pobj, torch.from_numpy(arr)))
    got, want = (v if isinstance(v, list) else [v] for v in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_reg"])
def test_rqspline_build_keeps_the_backend(rng, backend):
    """``RQSplineCoupling_.build(backend=...)`` keeps the backend, as the
    JAX factory does, and the coupling computes the JAX one's map on every
    route (the JAX side on ``xla``: its Pallas kernels run compiled only)."""
    kw = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0),
              extrap={"left": "linear", "right": "linear"})
    assert nf.nn.RQSplineCoupling_.build(
        conv_nets(True, 2, 1, 10), mask=nf.mask.EvenOddMask(shape=LAT),
        backend=backend, **kw).backend == backend
    jobj = nf.nn.RQSplineCoupling_.build(
        conv_nets(True, 2, 1, 10), mask=nf.mask.EvenOddMask(shape=LAT), **kw)
    pobj = nt.nn.RQSplineCoupling_.build(
        conv_nets(False, 2, 1, 10), mask=nt.mask.EvenOddMask(shape=LAT),
        backend=backend, **kw)
    assert pobj.backend == backend
    leaves = perturbed_leaves(jobj, rng, scale=0.2)
    jobj = restore_into(jobj, leaves)
    load_jax_leaves(pobj, leaves)
    arr = real((3, *LAT))(rng)
    want = _numpy(flow(jobj, jnp.asarray(arr)))
    with torch.no_grad():
        got = _numpy(flow(pobj, torch.from_numpy(arr)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_keyed_builds_take_a_generator():
    """Where the JAX ``build`` takes a key first, the port's takes a
    ``torch.Generator`` there: the same generator state, the same
    weights."""
    a = nt.nn.ConvAct.build(gen(), 2, 3, 3, hidden_sizes=(4,),
                            acts=("tanh", None))
    b = nt.nn.ConvAct.build(gen(), 2, 3, 3, hidden_sizes=(4,),
                            acts=("tanh", None))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    s = nt.nn.SgnBiasNet_.build(key=gen(), size=(2,))
    assert s.w.shape == (2,) and bool((s.w < 0.1).all())
    dc = nt.nn.DistConvertor_.build(4, sgnbias=True, key=gen())
    assert dc.sgnbias_layer is not None


def test_canonical_drive_on_the_port():
    """The JAX package's canonical zero-dim drive through the port's
    names, on the CPU, shortened to 300 epochs: the loss falls towards the zero-dim target, the Metropolis
    chain accepts and the round trip is exact to float32 round-off."""
    net = nt.nn.DistConvertor_.build(10, symmetric=True)
    prior = nt.prior.NormalPrior.build(shape=(1,))
    action = nt.action.ScalarPhi4Action(kappa=0, m_sq=-1.2, lambd=0.5)
    model = nt.Model(net_=net, prior=prior, action=action, seed=42)
    assert model.device.type == "cpu"
    hist = model.fit(n_epochs=300, batch_size=128,
                     hyperparam=dict(lr=0.01, weight_decay=0.0),
                     checkpoint_dict=dict(print_stride=None))
    loss = hist["loss"]
    assert len(loss) == 300 and np.isfinite(loss).all()
    assert np.mean(loss[-20:]) < np.mean(loss[:20]) and np.mean(
        loss[-20:]) < -0.9
    y, logq, logp = model.mcmc.sample__(batch_size=1024)
    assert y.shape == (1024, 1)
    assert 0.5 < model.mcmc.history.accept_rate[-1] <= 1.0
    x_err, logj_err = nt.backward_sanitychecker(model, verbose=False)
    assert x_err < 1e-4 and logj_err < 1e-4
    assert math.isfinite(float(logq.mean()))
