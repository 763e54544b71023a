"""Port parity of the controlled couplings, on the CPU, in float64.

``DirectCntrCoupling`` and ``CntrCoupling`` over the shift, affine,
RQ-spline and multi-spline couplings: transplanted, perturbed weights and
an injected control give the same ``y``, ``logJ`` and parameter gradients
as the JAX package to 1e-10, both ways.  ``refresh_controls`` /
``has_controls`` find couplings inside lists and dicts; a refresh writes
the buffer in place whenever the shape holds; one ``Fitter`` step with a
fixed control generator equals the JAX step (loss and every leaf after the
update, 1e-10); evaluation and sampling keep the training control.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from normflow__tpu.models import actions as ja
from normflow__tpu.models import core as jco
from normflow__tpu.models import couplings as jc
from normflow__tpu.models import elementwise as je
from normflow__tpu.models import masks as jm
from normflow__tpu.models import priors as jpr
from normflow__tpu.struct import Const
from normflow__tpu.training.model import Model as JModel
from normflow__tpu.utils.serialization import leaves_of, restore_into
import normflow__tpu_torch as nt
from normflow__tpu_torch.models import couplings as tc
from normflow__tpu_torch.models import masks as tm
from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.models.core import FlowList
from normflow__tpu_torch.models.elementwise import DistConvertor
from normflow__tpu_torch.models.priors import NormalPrior
from normflow__tpu_torch.utils.transplant import (jax_leaf_grads,
                                                  jax_leaf_order,
                                                  load_jax_leaves)
from test_torch_flow_zoo import F64, KEY, LAT, MASKS, TOL, _conv_pair, _t
from test_torch_modules import perturbed_leaves, transplant

RQS = dict(xlim=(-3.0, 3.0), ylim=(-3.0, 3.0),
           extrap={"left": "linear", "right": "linear"})
# (JAX coupling builder, port class, conditioner channels, data channels)
KINDS = {
    "shift": (lambda nets, mask: jc.ShiftCoupling(nets=nets, mask=mask),
              tc.ShiftCoupling, 1, 0, {}),
    "affine": (lambda nets, mask: jc.AffineCoupling(nets=nets, mask=mask),
               tc.AffineCoupling, 2, 0, {}),
    "rq spline": (jc.RQSplineCoupling.build, tc.RQSplineCoupling, 10, 0,
                  RQS),
    "multi spline": (jc.MultiRQSplineCoupling.build,
                     tc.MultiRQSplineCoupling, 2 * 10, 2,
                     dict(xlims=((-3.0, 3.0),) * 2,
                          ylims=((-3.0, 3.0),) * 2,
                          extraps=[{"left": "linear",
                                    "right": "linear"}] * 2)),
}


def _jit0(fn, *args):
    """``fn(*args)`` compiled at XLA's lowest backend optimisation level
    (each case runs once)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _pair(kind, rng, n_nets=2):
    """A JAX coupling and its port on the even-odd mask, with perturbed
    weights transplanted; and the data's trailing shape."""
    jbuild, tcls, n_out, ch, kw = KINDS[kind]
    pairs = [_conv_pair(k, max(ch, 1), n_out)
             for k in jax.random.split(KEY, n_nets)]
    jcpl = jbuild(tuple(p[0] for p in pairs), mask=MASKS["even-odd"](jm),
                  **kw)
    tcpl = tcls([p[1] for p in pairs], mask=MASKS["even-odd"](tm), **kw)
    jcpl = transplant(jcpl, tcpl, rng)
    return jcpl, tcpl, (ch,) if ch else ()


def _direct_both_ways(flow, x, control, cys, cls):
    out = []
    for direction, cy, cl in zip(("forward", "backward"), cys, cls):
        def scalar(f, cy=cy, cl=cl, direction=direction):
            (y, _), logj = getattr(f, direction)((x, control))
            return jnp.sum(y * cy) + jnp.sum(logj * cl)

        (y, c), logj = getattr(flow, direction)((x, control))
        out.append((y, c, logj, jax.grad(scalar)(flow)))
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_direct_cntr_coupling_matches_jax(rng, kind):
    jcpl, tcpl, tail = _pair(kind, rng)
    jflow, tflow = jc.DirectCntrCoupling(coupling=jcpl), \
        tc.DirectCntrCoupling(tcpl)
    x = rng.standard_normal((3, *LAT, *tail))
    control = rng.standard_normal((3, *LAT, *tail))
    cys = [rng.standard_normal(x.shape) for _ in range(2)]
    cls = [rng.standard_normal(3) for _ in range(2)]
    results = _jit0(_direct_both_ways, jflow, jnp.asarray(x),
                    jnp.asarray(control), cys, cls)
    for direction, cy, cl, (jy, jcon, jlogj, jgrads) in zip(
            ("forward", "backward"), cys, cls, results):
        tflow.zero_grad(set_to_none=True)
        (ty, tcon), tlogj = getattr(tflow, direction)((_t(x), _t(control)))
        assert tcon is not None and np.array_equal(tcon.numpy(), control)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=0, atol=TOL, err_msg=direction)
        np.testing.assert_allclose(tlogj.detach().numpy(), np.asarray(jlogj),
                                   rtol=0, atol=TOL, err_msg=direction)
        (torch.sum(ty * _t(cy)) + torch.sum(tlogj * _t(cl))).backward()
        got, want = jax_leaf_grads(tflow), leaves_of(jgrads)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                       err_msg=f"{direction} leaf {k}")
    # the round trip, and the control conditions the first layer
    with torch.no_grad():
        (y, _), logj = tflow.forward((_t(x), _t(control)))
        (x2, _), log0 = tflow.backward((y, _t(control)), log0=logj)
        (y2, _), _ = tflow.forward((_t(x), _t(control * 2)))
    np.testing.assert_allclose(x2.numpy(), x, rtol=0, atol=TOL)
    np.testing.assert_allclose(log0.numpy(), 0.0, rtol=0, atol=TOL)
    assert not np.allclose(y2.numpy(), y.numpy())


@pytest.mark.parametrize("kind", ["affine", "rq spline"])
def test_cntr_coupling_with_its_control_matches_jax(rng, kind):
    """A ``CntrCoupling`` whose control is the JAX ``Const`` leaf: the
    transplant copies it into the buffer (the port must have drawn one of
    that shape), and both directions agree."""
    jcpl, tcpl, tail = _pair(kind, rng)
    control = rng.standard_normal((3, *LAT, *tail))
    jflow = jc.CntrCoupling(coupling=jcpl, control=Const(jnp.asarray(
        control)))
    tflow = tc.CntrCoupling(tcpl, control_generator=lambda g, b: torch.zeros(
        (b, *LAT, *tail), dtype=torch.float64))
    with pytest.raises(ValueError, match="refresh_control"):
        tflow.forward(_t(control))
    tflow.refresh_control(None, 3)
    leaves = leaves_of(jflow)
    assert len(list(jax_leaf_order(tflow))) == len(leaves)
    load_jax_leaves(tflow, leaves)
    assert np.array_equal(tflow.control.numpy(), control)
    assert "control" not in dict(tflow.named_parameters())
    x = rng.standard_normal((3, *LAT, *tail))
    for direction in ("forward", "backward"):
        jy, jlogj = _jit0(lambda f, x, d=direction: getattr(f, d)(x), jflow,
                          jnp.asarray(x))
        with torch.no_grad():
            ty, tlogj = getattr(tflow, direction)(_t(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(tlogj.numpy(), np.asarray(jlogj), rtol=0,
                                   atol=TOL)
    # a batch other than the control's raises, as in JAX
    with pytest.raises(Exception):
        tflow.forward(_t(rng.standard_normal((5, *LAT, *tail))))
    with pytest.raises(Exception):
        jflow.forward(jnp.asarray(rng.standard_normal((5, *LAT, *tail))))


def _jax_layout(owner, name, t):
    """A port tensor in the JAX layout (conv weights OIHW -> HWIO)."""
    a = t.detach().numpy()
    if isinstance(owner, nt.models.CircularConv) and name == "weight":
        a = a.transpose(*range(2, a.ndim), 1, 0)
    return a


def _gen_control(shape):
    def draw(generator, batch_size):
        return torch.randn((batch_size, *shape), generator=generator,
                           dtype=torch.float64)
    return draw


def _port_cntr(shape=LAT, generator=True):
    nets = [nt.models.ConvNet(1, 2, 3, hidden_sizes=(2,),
                              acts=("tanh", None), **F64) for _ in range(2)]
    return tc.CntrAffineCoupling(
        nets, mask=tm.EvenOddMask(shape=shape),
        control_generator=_gen_control(shape) if generator else None)


class _Holder(nn.Module):
    """Controlled couplings in a plain list and a plain dict (not
    registered submodules), and one in a ``FlowList``."""

    def __init__(self):
        super().__init__()
        self.flows = FlowList([DistConvertor(4, **F64), _port_cntr()])
        self.in_list = [_port_cntr(), [_port_cntr()]]
        self.in_dict = {"a": _port_cntr(), "b": {"c": _port_cntr()}}
        self.no_generator = _port_cntr(generator=False)


def test_refresh_controls_walks_lists_and_dicts():
    holder = _Holder()
    found = list(tc._cntr_couplings(holder))
    assert len(found) == 5 and holder.no_generator not in found
    assert tc.has_controls(holder)
    assert not tc.has_controls(FlowList([DistConvertor(4, **F64)]))
    assert not tc.has_controls(_port_cntr(generator=False))
    gen = torch.Generator().manual_seed(0)
    assert tc.refresh_controls(holder, gen, 4) is holder
    assert all(c.control.shape == (4, *LAT) for c in found)
    assert holder.no_generator.control is None
    first = [c.control.clone() for c in found]
    ptrs = [c.control.data_ptr() for c in found]
    tc.refresh_controls(holder, gen, 4)
    # a fresh draw, each in its own buffer, in place
    assert [c.control.data_ptr() for c in found] == ptrs
    assert all(not torch.equal(a, c.control) for a, c in zip(first, found))
    assert len({c.control[0, 0, 0].item() for c in found}) == 5
    tc.refresh_controls(holder, gen, 6)  # another shape: new buffers
    assert all(c.control.shape == (6, *LAT) for c in found)
    with pytest.raises(ValueError, match="control_generator"):
        holder.no_generator.refresh_control(gen, 4)


def _twin_cntr_models(rng, control):
    """A JAX and a port ``FlowList(DistConvertor, CntrRQSplineCoupling)``
    at 8x8 with the same perturbed weights, whose control generators
    return ``control`` whatever the key or generator."""
    lat, b = (8, 8), control.shape[0]
    pairs = [_conv_pair(k, 1, 10) for k in jax.random.split(KEY, 2)]
    jnet = jco.FlowList(flows=(
        je.DistConvertor.build(4, symmetric=True),
        jc.CntrRQSplineCoupling(
            [p[0] for p in pairs], mask=jm.EvenOddMask(shape=lat),
            control_generator=lambda k, n: jnp.asarray(control), **RQS)))
    tnet = FlowList([
        DistConvertor(4, **F64),
        tc.CntrRQSplineCoupling(
            [p[1] for p in pairs], mask=tm.EvenOddMask(shape=lat),
            control_generator=lambda g, n: torch.from_numpy(control.copy()),
            **RQS)])
    leaves = perturbed_leaves(jnet, rng)
    load_jax_leaves(tnet, leaves)
    jnet = restore_into(jnet, leaves)
    action = dict(kappa=0.3, m_sq=-1.0, lambd=0.3)
    jmodel = JModel(net_=jnet, prior=jpr.NormalPrior.build(shape=lat),
                    action=ja.ScalarPhi4Action(**action), seed=1)
    model = nt.Model(net_=tnet, prior=NormalPrior(shape=lat, **F64),
                     action=ScalarPhi4Action(**action), seed=1)
    return jmodel, model, b


@pytest.mark.parametrize("estimator", ["rep", "path"])
def test_fitter_step_with_a_fixed_control_matches_jax(rng, estimator):
    control = rng.standard_normal((8, 8, 8))
    jmodel, model, b = _twin_cntr_models(rng, control)
    jfit = jmodel.fit
    jfit(n_epochs=0, batch_size=b, grad_estimator=estimator,
         checkpoint_dict=dict(print_stride=None))
    key = jax.random.key(5)
    jnet, _, jloss, _ = jfit._step_fn(jmodel.net_, jfit.opt_state, key, b,
                                      1.0)
    # the JAX step's draw: its key after the control's split
    x = np.asarray(jmodel.prior.sample(jax.random.split(key)[1], b))

    def draw(batch_size, generator):
        xt = torch.from_numpy(x.copy())
        return xt, model.prior.log_prob(xt)

    model.fit._draw = draw
    hist = model.fit(n_epochs=1, batch_size=b, grad_estimator=estimator,
                     checkpoint_dict=dict(print_stride=None))
    np.testing.assert_allclose(hist["loss"][0], float(jloss), rtol=0,
                               atol=TOL)
    want = leaves_of(jnet)
    got = [_jax_layout(owner, name, t)
           for owner, name, t in jax_leaf_order(model.net_)]
    assert len(got) == len(want)  # the control is the last leaf
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[str(i)], rtol=0, atol=TOL,
                                   err_msg=f"leaf {i}")
    assert model.fit._has_controls
    assert all(p is not model.net_[1].control for p in model.fit.params)


def test_fit_draws_every_step_and_keeps_the_control_for_sampling():
    """Each step draws a new control into the same buffer; the metrics'
    evaluation at another batch puts the training control back; sampling
    never draws, and refuses another batch than the control's."""
    torch.manual_seed(0)
    cpl = _port_cntr(shape=(4, 4))
    model = nt.Model(net_=cpl, prior=NormalPrior(shape=(4, 4), **F64),
                     action=ScalarPhi4Action(kappa=0.3, m_sq=-1.0,
                                             lambd=0.3), seed=3)
    seen = []
    real = cpl.refresh_control

    def spy(generator, batch_size):
        seen.append(batch_size)
        return real(generator, batch_size)

    cpl.refresh_control = spy
    hist = model.fit(n_epochs=30, batch_size=32,
                     hyperparam=dict(lr=5e-3, weight_decay=0.0),
                     checkpoint_dict=dict(print_stride=15,
                                          print_batch_size=64))
    # fit, 30 steps, and the evaluations at epochs 1, 10, 15 and 30
    assert seen.count(32) == 31 and seen.count(64) == 4
    assert cpl.control.shape == (32, 4, 4)
    assert np.isfinite(hist["loss"]).all() and hist["loss"][-1] < \
        hist["loss"][0]
    ptr, kept = cpl.control.data_ptr(), cpl.control.clone()
    n = len(seen)
    y, logq, logp = model.posterior.sample__(32)
    assert len(seen) == n and cpl.control.data_ptr() == ptr
    assert torch.equal(cpl.control, kept)
    with pytest.raises(RuntimeError):
        model.posterior.sample__(16)
