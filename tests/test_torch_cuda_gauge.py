"""The U(1) gauge and Schwinger paths on the card.

Like ``tests/test_torch_cuda.py`` these need a CUDA card, skip without
one, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_gauge.py

Held here, with TF32 off:

- BASELINE config 5 (``build_u1_model()``): a replayed batch against its
  eager body, bit for bit; replayed training steps against eager bodies
  from one state, bit for bit under cuDNN's deterministic algorithms;
- the 8x8 exact Schwinger model: the same two (the steps within the
  smoke's step tolerance), its log-det on the Cholesky graph;
- the exact Schur log-det on the card (float32) against the dense float64
  ``slogdet`` on the CPU, relative ``LOGDET_REL_TOL``: the float32 CPU
  Schur path is ~4e-7 off float64 at 8x8 and 16x16 (random links, this
  file's inputs), and the bar gives ten times that;
- the stochastic log-det's fit: a replayed step draws the probes its eager
  body draws from the same generator state, and other probes after a
  reseed.
"""

import math

import numpy as np
import pytest
import torch

from normflow__tpu_torch import Model
from normflow__tpu_torch.models.fermions import (SchwingerAngleAction,
                                                 StaggeredFermionLogDet,
                                                 StochasticStaggeredLogDet)
from normflow__tpu_torch.models.gauge import build_u1_gauge_flow
from normflow__tpu_torch.models.priors import UniformPrior
from normflow__tpu_torch.training import optim
from normflow__tpu_torch.zoo import build_u1_model

pytestmark = pytest.mark.gpu

LOGDET_REL_TOL = 5e-6
STEP_TOL = 1e-5  # chip_smoke.py's REPLAY_LOSS_TOL and REPLAY_PARAM_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _schwinger(lat=(8, 8), logdet_func=None, n_cycles=1):
    kw = dict(dtype=torch.float32, device="cuda")
    flow = build_u1_gauge_flow(torch.Generator().manual_seed(0), lat,
                               hidden=(16,), n_cycles=n_cycles, **kw)
    prior = UniformPrior(torch.full((2, *lat), -math.pi, **kw),
                         torch.full((2, *lat), math.pi, **kw))
    action = SchwingerAngleAction(beta=2.0, lat_shape=lat, mass=0.2,
                                  logdet_func=logdet_func)
    return Model(net_=flow, prior=prior, action=action, seed=0)


def _bits(t):
    return t.view(torch.int32)


def _batch_replay_vs_eager(model, batch):
    model.seed(5)
    got = model.posterior.logqp_stream(2, batch)
    model.seed(5)
    want = torch.cat([model.posterior.logqp_batch(batch, model.generator)
                      for _ in range(2)])
    assert torch.equal(_bits(got), _bits(want))
    assert bool(torch.isfinite(got).all())


def _steps_replay_vs_eager(model, n=4, bits=False):
    """``n`` replayed steps against ``n`` eager bodies from one state:
    within ``STEP_TOL``, or with ``bits`` (cuDNN's deterministic
    algorithms, set before the capture) bit for bit."""
    fit = model.fit
    live = fit.params + optim.state_leaves(fit.opt_state)
    start = [t.detach().clone() for t in live], model.generator.get_state()

    def run(step):
        with torch.no_grad():
            for t, v in zip(live, start[0]):
                t.copy_(v)
        model.generator.set_state(start[1])
        losses = torch.stack([step()[0] for _ in range(n)])
        return losses, [p.detach().clone() for p in fit.params]

    (la, pa), (lb, pb) = run(fit.step), run(fit.train_body)
    assert bool(torch.isfinite(la).all())
    if bits:
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip((la, *pa), (lb, *pb)))
    assert float(((la - lb).abs() / lb.abs().clamp(min=1.0)).max()) \
        <= STEP_TOL
    assert max(float((x - y).abs().max()) for x, y in zip(pa, pb)) \
        <= STEP_TOL


def _fit(model, n, batch, **kw):
    return model.fit(n_epochs=n, batch_size=batch,
                     hyperparam=dict(lr=1e-3, weight_decay=0.0),
                     checkpoint_dict=dict(print_stride=None), **kw)


def test_u1_config5_replays_match_eager(cuda):
    """The steps bit for bit under cuDNN's deterministic algorithms: Adam's
    first steps turn a last-bit difference of the default weight-gradient
    order into 5e-4 of the loss within four steps (this test's first card
    run, on an H100 80GB HBM3)."""
    model = build_u1_model()
    assert model.net_.npar == 107168
    _batch_replay_vs_eager(model, 256)
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _fit(model, 2, 64, grad_estimator="path", clip_grad_norm=25.0)
        _steps_replay_vs_eager(model, bits=True)
    finally:
        torch.backends.cudnn.deterministic = flag


def test_schwinger_replays_match_eager(cuda):
    model = _schwinger()
    _batch_replay_vs_eager(model, 128)
    _fit(model, 2, 64)
    _steps_replay_vs_eager(model)


@pytest.mark.parametrize("lat", [(8, 8), (16, 16)])
def test_schur_logdet_on_the_card_matches_float64_dense(cuda, lat):
    rng = np.random.default_rng(3)
    theta = rng.uniform(-np.pi, np.pi, (32, 2, *lat))
    got = StaggeredFermionLogDet(lat_shape=lat, mass=0.2)(
        torch.tensor(theta, dtype=torch.float32, device="cuda"))
    want = StaggeredFermionLogDet(lat_shape=lat, mass=0.2, method="dense")(
        torch.tensor(theta, dtype=torch.float64))
    err = (got.double().cpu() - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= LOGDET_REL_TOL


def test_keyed_fit_draws_probes_under_a_replay(cuda):
    est = StochasticStaggeredLogDet(lat_shape=(8, 8), mass=0.2, n_probes=2,
                                    cg_tol=1e-5, cg_maxiter=64)
    model = _schwinger(logdet_func=est)
    _fit(model, 2, 32)
    _steps_replay_vs_eager(model, n=3)
    fit = model.fit
    live = fit.params + optim.state_leaves(fit.opt_state)
    start = [t.detach().clone() for t in live]

    def replay(seed):
        with torch.no_grad():
            for t, v in zip(live, start):
                t.copy_(v)
        model.seed(seed)
        return float(fit.step()[0])

    assert replay(1) == replay(1)
    assert replay(1) != replay(2)  # other probes (and another draw)
