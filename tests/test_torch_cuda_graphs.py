"""The port's CUDA graphs on the card: one sampled batch, one training step.

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``, skip
without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_graphs.py

``Posterior.logqp_stream`` and ``model.fit`` replay a captured batch and a
captured step on a CUDA model (``normflow__tpu_torch/utils/graphs.py``).
Held here, with TF32 off:

- a replayed batch against the eager body from the same generator state,
  at the flagship's 32x32 and B = 1024 and at 8x8, bit for bit, and eager
  draws after replays continuing the stream;
- ``manual_seed`` between replays taking effect, without a new capture;
- weights loaded in place after the capture changing the replay's output,
  and a swapped net capturing anew;
- 10 replayed training steps against 10 eager bodies from the same
  parameters, optimizer state and generator state, bit for bit in the
  losses, the parameters and the state (cuDNN set deterministic for this
  test: its default weight-gradient algorithms may sum in another order
  on every run, eager or replayed);
- a planted NaN parameter: the replayed step leaves the parameters and the
  optimizer state as they were, bit for bit;
- the launches of one replay by profiler name: 4 ``rqs_coupling`` and 1
  ``phi4_action`` per batch, 8 / 8 / 1 / 1 per step, every one tiled, while
  the wrappers' counters do not move.
"""

import math

import numpy as np
import pytest
import torch

from normflow__tpu_torch.models.nets import CircularConv
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.tools.kernel_times import device_launches
from normflow__tpu_torch.training import optim
from normflow__tpu_torch.training.optim import cosine_decay_schedule
from normflow__tpu_torch.utils.transplant import jax_leaf_order
from normflow__tpu_torch.zoo import build_phi4_model

pytestmark = pytest.mark.gpu

BENCH = dict(hyperparam=dict(lr=3e-3, weight_decay=1e-4),
             grad_estimator="path", clip_grad_norm=25.0,
             checkpoint_dict=dict(print_stride=None))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _model(lat, seed=0, noise=0):
    """The flagship at ``lat`` on the card, its weights plus seeded noise
    (0.3 of the init bound on the convs, N(0, 0.3^2) elsewhere, as
    ``chip_smoke.py`` perturbs them) so that no flow is the identity."""
    model = build_phi4_model(lat, seed=seed)
    rng = np.random.default_rng(20261018 + noise)
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(model.net_):
            s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                if isinstance(owner, CircularConv) else 0.3
            p.add_(torch.tensor(rng.standard_normal(tuple(p.shape)) * s,
                                dtype=p.dtype, device=p.device))
    return model


def _same_bits(a, b):
    return all(torch.equal(p.reshape(-1).view(torch.uint8),
                           q.reshape(-1).view(torch.uint8))
               for p, q in zip(a, b, strict=True))


def _eager(model, n, batch):
    return torch.cat([model.posterior.logqp_batch(batch, model.generator)
                      for _ in range(n)])


@pytest.mark.parametrize("lat,batch", [((32, 32), 1024), ((8, 8), 64)])
def test_replayed_batch_matches_the_eager_body(cuda, lat, batch):
    model = _model(lat)
    model.seed(11)
    got = model.posterior.logqp_stream(3, batch)
    after = model.posterior.logqp_batch(batch, model.generator)
    model.seed(11)
    want = _eager(model, 4, batch)
    torch.cuda.synchronize()
    assert got.shape == (3 * batch,) and bool(torch.isfinite(got).all())
    assert _same_bits(got, want[:3 * batch])
    assert _same_bits(after, want[3 * batch:])  # eager draws continue


def test_manual_seed_between_replays(cuda):
    model = _model((8, 8))
    post = model.posterior
    model.seed(1)
    a = post.logqp_stream(2, 64)
    captured = post.batch_graph(64)
    launches = sc.rqs_coupling.launches
    model.seed(2)
    b = post.logqp_stream(2, 64)
    model.seed(1)
    c = post.logqp_stream(2, 64)
    assert post.batch_graph(64) is captured
    assert sc.rqs_coupling.launches == launches  # no new capture
    assert _same_bits(a, c) and not torch.equal(a, b)


def test_weights_loaded_in_place_reach_the_replay(cuda):
    model = _model((8, 8))
    other = _model((8, 8), seed=1, noise=1)
    post = model.posterior
    model.seed(4)
    before = post.logqp_stream(1, 64)
    captured = post.batch_graph(64)
    model.net_.load_state_dict(other.net_.state_dict())
    model.seed(4)
    got = post.logqp_stream(1, 64)
    assert post.batch_graph(64) is captured
    model.seed(4)
    want = _eager(model, 1, 64)
    assert not torch.equal(got, before) and _same_bits(got, want)
    model.net_ = other.net_  # a swapped net captures anew
    assert post.batch_graph(64) is not captured


def _fitted(lat, batch, n_epochs=0):
    model = _model(lat)
    model.fit(n_epochs=n_epochs, batch_size=batch,
              scheduler=cosine_decay_schedule(1.0, decay_steps=20,
                                              alpha=0.05), **BENCH)
    return model


def _live(fit):
    return fit.params + optim.state_leaves(fit.opt_state)


def test_replayed_steps_match_eager_steps(cuda):
    torch.backends.cudnn.deterministic = True
    model = _fitted((8, 8), 64)
    fit = model.fit
    start = ([t.detach().clone() for t in _live(fit)],
             model.generator.get_state())

    def run(step):
        with torch.no_grad():
            for t, v in zip(_live(fit), start[0]):
                t.copy_(v)
        model.generator.set_state(start[1])
        losses = torch.stack([step()[0] for _ in range(10)])
        return losses, [t.detach().clone() for t in _live(fit)]

    replayed = run(fit.step)
    assert fit.step_graph() is not None
    eager = run(fit.train_body)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(replayed[0]).all())
    assert _same_bits((replayed[0],), (eager[0],))
    assert _same_bits(replayed[1], eager[1])
    assert float(optim.state_leaves(fit.opt_state)[0]) == 10.0


def test_planted_nan_leaves_params_and_state(cuda):
    model = _fitted((8, 8), 64, n_epochs=3)
    fit = model.fit
    with torch.no_grad():
        fit.params[0].view(-1)[0] = float("nan")
    before = [t.detach().clone() for t in _live(fit)]
    loss, _ = fit.step()
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(loss))
    assert _same_bits(_live(fit), before)


def test_one_replay_launches_every_kernel_tiled(cuda):
    model = _fitted((32, 32), 512)
    post, fit = model.posterior, model.fit
    post.logqp_stream(1, 1024)
    fit.step()  # both captured
    counters = (sc.rqs_coupling, sc.rqs_coupling_bwd, phi4.phi4_action,
                phi4.phi4_action_grad)
    before = [c.launches for c in counters]
    sample = {"rqs_coupling": (4, 4), "phi4_action": (1, 1)}
    step = {"rqs_coupling": (8, 8), "rqs_coupling_bwd": (8, 8),
            "phi4_action": (1, 1), "phi4_action_grad": (1, 1)}
    assert device_launches(lambda: post.logqp_stream(1, 1024))[0] == sample
    assert device_launches(fit.step)[0] == step
    assert [c.launches for c in counters] == before
