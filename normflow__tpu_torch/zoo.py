"""Model zoo: the 2-D phi^4 flagship (``normflow__tpu/zoo.py:51-107``) and
the 2-D U(1) gauge model (``zoo.py:110-136``, BASELINE config 5).

PSD block -> DistConvertor -> RQ-spline coupling of ``n_layers``
checkerboard conditioners with 3x3 circular convs and tanh, no bias ->
DistConvertor, over a standard normal prior, with the action
``ScalarPhi4Action(kappa, m_sq, lambd)``.  The checkerboard is packed
(``PackedEvenOddMask``: each conditioner, ``RowParityFeature(ConvNet)``,
sees the frozen half of the sites as a dense grid, with a row-parity
channel) or, with ``packed=False``, multiplicative (``EvenOddMask``, the
reference's layout: a bare ``ConvNet`` on the whole lattice, whose output
goes to the coupling kernel at every site).

The weights start as in the JAX build, from the same distributions (the
random streams differ): Kaiming-uniform conv weights with bound
``1/sqrt(fan_in)``, zero spline weights, and the FFT flow's ``logy`` from
its effective-mass initialisation.

The U(1) model (:func:`build_u1_model`) is ``models.gauge``'s plaquette
coupling flow over a uniform prior on the link angles, with the Wilson
action on angles.

:func:`with_conv_compute_dtype` gives a trained flow bf16 conditioners for
sampling (``normflow__tpu/zoo.py:35-48``), :func:`with_coupling_backend`
another coupling route (root ``bench.py:299-307``'s ``with_backend``),
each a copy that shares the flow's weights.  ``build_phi4_model``'s
``coupling_backend`` is the JAX builder's: ``"pallas_reg"`` runs the
conditioners channels-last into the channels-last coupling kernels
(``models/couplings.py``), at every lattice rank the unpacked flagship
takes, 1 to 4 (the packed mask is 2-D, as in the JAX package).
"""

from __future__ import annotations

import copy
import math

import torch

from .models.actions import ScalarPhi4Action
from .models.core import FlowList
from .models.couplings import RQSplineCoupling
from .models.elementwise import DistConvertor
from .models.gauge import U1AngleAction, build_u1_gauge_flow
from .models.masks import EvenOddMask, PackedEvenOddMask
from .models.nets import ConvNet, RowParityFeature, _as_dtype
from .models.priors import NormalPrior, UniformPrior
from .models.spectral import FFTFlow, MeanFieldFlow, PSDBlock
from .training.model import Model
from .utils.device import resolve_device

__all__ = ["build_phi4_model", "build_u1_model", "with_conv_compute_dtype",
           "with_coupling_backend"]


def with_conv_compute_dtype(net_, dtype):
    """A copy of the flow ``net_`` with every ``ConvNet``'s compute dtype
    set to ``dtype`` (``torch.bfloat16`` or ``'bfloat16'``; ``None`` for
    the weights' own), sharing ``net_``'s parameters and buffers: the
    modules are new, the tensors the same, so training ``net_`` moves both
    and neither's graph replays for the other (``Model.graph_stamp``).
    The flow's log-Jacobian comes from the conditioners' cast-back
    outputs, so ``logq`` and the sample still come from one map."""
    new = _sharing_copy(net_)
    for m in new.modules():
        if isinstance(m, ConvNet):
            m.compute_dtype = _as_dtype(dtype)
    return new


def with_coupling_backend(net_, backend):
    """A copy of the flow ``net_`` whose every ``RQSplineCoupling`` is
    built anew with ``backend`` (``"xla"``, ``"pallas"`` or
    ``"pallas_reg"``) around the copy's conditioners, at any lattice rank,
    sharing ``net_``'s parameters and buffers as
    :func:`with_conv_compute_dtype` does: run it on a ``Model`` of its
    own."""
    if backend not in RQSplineCoupling.BACKENDS:
        raise ValueError(f"backend {backend!r}: one of "
                         f"{RQSplineCoupling.BACKENDS}")
    new = _sharing_copy(net_)
    for name, m in list(new.named_modules()):
        if isinstance(m, RQSplineCoupling):
            m = RQSplineCoupling(
                m.nets, mask=m.mask, xlim=m.xlim, ylim=m.ylim,
                knots_x=m.knots_x, knots_y=m.knots_y, extrap=m.extrap,
                backend=backend)
            if not name:
                return m
            new.set_submodule(name, m)
    return new


def _sharing_copy(net_):
    """New modules holding ``net_``'s parameter and buffer tensors."""
    shared = {id(t): t for t in (*net_.parameters(), *net_.buffers())}
    return copy.deepcopy(net_, memo=shared)


def build_phi4_model(lat_shape=(32, 32), *, kappa=0.6, m_sq=-2.4, lambd=0.5,
                     knots=8, hidden=(24, 24), n_layers=4, dc_knots=16,
                     packed=True, parity_feature=None, kernel_size=3,
                     coupling_backend="xla", seed=0, dtype=torch.float32,
                     device=None, conv_dilations=None) -> Model:
    """The flagship on ``device`` (``None`` means ``cuda``, and raises when
    no GPU is present).  ``parity_feature`` (default: ``packed``) adds the
    row-parity input channel; ``coupling_backend`` is the couplings'
    route (``RQSplineCoupling``'s ``backend``); ``conv_dilations`` are the
    conditioner layers' dilations (``ConvNet``)."""
    device = resolve_device(device)
    lat_shape = tuple(lat_shape)
    if parity_feature is None:
        parity_feature = packed
    mask = (PackedEvenOddMask(shape=lat_shape) if packed
            else EvenOddMask(shape=lat_shape))
    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=dtype, device=device)

    def make_net():
        net = ConvNet(
            2 if parity_feature else 1, 3 * knots - 2, kernel_size,
            conv_dim=len(lat_shape), hidden_sizes=tuple(hidden),
            acts=("tanh",) * len(hidden) + (None,), bias=False,
            dilations=conv_dilations, generator=gen, **kw)
        return RowParityFeature(net) if parity_feature else net

    net_ = FlowList([
        PSDBlock(
            mfnet=MeanFieldFlow(8, smooth=True, final_scale=True, **kw),
            fftnet=FFTFlow(lat_shape, knots_len=8, ignore_zeromode=True,
                           **kw),
        ),
        DistConvertor(dc_knots, smooth=True, **kw),
        RQSplineCoupling(
            [make_net() for _ in range(n_layers)],
            mask=mask,
            xlim=(-4.0, 4.0), ylim=(-4.0, 4.0),
            extrap={"left": "linear", "right": "linear"},
            backend=coupling_backend),
        DistConvertor(dc_knots, smooth=True, **kw),
    ])
    prior = NormalPrior(shape=lat_shape, **kw)
    action = ScalarPhi4Action(kappa=kappa, m_sq=m_sq, lambd=lambd)
    return Model(net_=net_, prior=prior, action=action, seed=seed)


def build_u1_model(lat_shape=(16, 16), *, beta=2.0, knots_len=8,
                   hidden=(16,), n_cycles=4, seed=0, dtype=torch.float32,
                   device=None) -> Model:
    """2-D U(1) gauge model with gauge-equivariant plaquette couplings
    (BASELINE config 5) on ``device`` (``None`` means ``cuda``): ``8
    n_cycles`` couplings, a uniform prior on [-pi, pi] per link angle and
    ``U1AngleAction(beta)``; the conditioners' weights drawn from a
    generator seeded with ``seed``."""
    device = resolve_device(device)
    lat_shape = tuple(lat_shape)
    flow = build_u1_gauge_flow(torch.Generator().manual_seed(seed),
                               lat_shape, knots_len=knots_len, hidden=hidden,
                               n_cycles=n_cycles, dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=device)
    prior = UniformPrior(torch.full((2, *lat_shape), -math.pi, **kw),
                         torch.full((2, *lat_shape), math.pi, **kw))
    return Model(net_=flow, prior=prior, action=U1AngleAction(beta=beta),
                 seed=seed)
