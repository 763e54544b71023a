"""bf16 conditioners and controlled couplings on the card.

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``, skip
without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_bf16_cntr.py

They mirror ``chip_smoke.py``'s "bf16 sampling path" and "controlled
coupling training" phases at small sizes, with TF32 off:

- the flagship sampled through ``zoo.with_conv_compute_dtype(net_,
  torch.bfloat16)`` on a ``Model`` of its own that shares the weights: a
  replayed batch bit for bit with its eager body under
  ``cudnn.deterministic``; its gap from the float32 flow on the same draws
  at most twice the port's gap on the CPU (the same weights, draws and
  bf16 rounding, in another conv library); one replay at 32x32 and B =
  1024 launching 4 ``rqs_coupling`` + 1 ``phi4_action``, all tiled;
- the flagship with its couplings as one ``CntrRQSplineCoupling`` and a
  normal control of the frozen partition's shape, trained: two replays
  draw different controls into the same buffer, 10 replayed steps equal
  10 eager bodies bit for bit under ``cudnn.deterministic``, one replay at
  32x32 and batch 512 launches 8 / 8 / 1 / 1, all tiled;
- ``utils.profiling.trace`` writes a Chrome trace that holds the kernels.
"""

import json
import math

import numpy as np
import pytest
import torch

from normflow__tpu_torch.models.couplings import CntrRQSplineCoupling
from normflow__tpu_torch.models.nets import CircularConv
from normflow__tpu_torch.tools.kernel_times import device_launches
from normflow__tpu_torch.training import optim
from normflow__tpu_torch.training.model import Model
from normflow__tpu_torch.training.optim import cosine_decay_schedule
from normflow__tpu_torch.utils.profiling import trace
from normflow__tpu_torch.utils.transplant import jax_leaf_order
from normflow__tpu_torch.zoo import build_phi4_model, with_conv_compute_dtype

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


def _perturbed(model, seed=20261018):
    """Seeded noise on every weight (``chip_smoke.perturb_``'s)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(model.net_):
            s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                if isinstance(owner, CircularConv) else 0.3
            p.add_(torch.tensor(rng.standard_normal(tuple(p.shape)) * s,
                                dtype=p.dtype, device=p.device))
    return model


def _bf16_arm(model):
    return Model(net_=with_conv_compute_dtype(model.net_, torch.bfloat16),
                 prior=model.prior, action=model.action)


def _same_bits(a, b):
    return all(torch.equal(p.reshape(-1).view(torch.uint8),
                           q.reshape(-1).view(torch.uint8))
               for p, q in zip(a, b, strict=True))


def controlled(model):
    """``model`` with its coupling stack rebuilt as one
    ``CntrRQSplineCoupling`` on the same nets and mask, whose control is a
    standard normal field of the frozen partition's shape."""
    cpl = model.net_[2]
    lat = model.prior.shape
    shape = (lat[0], lat[1] // 2)  # the packed partition

    def draw(generator, batch_size):
        return torch.randn((batch_size, *shape), generator=generator,
                           device=generator.device)

    model.net_.flows[2] = CntrRQSplineCoupling(
        list(cpl.nets), mask=cpl.mask, xlim=cpl.xlim, ylim=cpl.ylim,
        extrap=cpl.extrap, control_generator=draw)
    return model


def test_bf16_replay_matches_its_eager_body(cuda):
    torch.backends.cudnn.deterministic = True
    arm = _bf16_arm(_perturbed(build_phi4_model((8, 8))))
    arm.seed(3)
    got = arm.posterior.logqp_stream(3, 64)
    arm.seed(3)
    want = torch.cat([arm.posterior.logqp_batch(64, arm.generator)
                      for _ in range(3)])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and _same_bits((got,), (want,))


def test_bf16_gap_on_the_card_within_twice_the_cpus(cuda):
    model = _perturbed(build_phi4_model((8, 8)))
    x = torch.randn((256, 8, 8), generator=torch.Generator().manual_seed(5))
    cpu = build_phi4_model((8, 8), device="cpu")
    cpu.net_.load_state_dict({k: v.cpu()
                              for k, v in model.net_.state_dict().items()})
    gaps = []
    for net in (model.net_, cpu.net_):
        dev = next(net.parameters()).device
        with torch.no_grad():
            _, l32 = net.forward(x.to(dev))
            _, l16 = with_conv_compute_dtype(net, "bfloat16").forward(
                x.to(dev))
        gaps.append(float((l16 - l32).abs().max()))
    card, cpu_gap = gaps
    assert 0 < card <= 2 * cpu_gap, gaps


def test_bf16_replay_launches_the_kernels_tiled(cuda):
    arm = _bf16_arm(_perturbed(build_phi4_model((32, 32))))
    arm.posterior.logqp_stream(1, 1024)  # captured
    assert device_launches(lambda: arm.posterior.logqp_stream(1, 1024))[0] \
        == {"rqs_coupling": (4, 4), "phi4_action": (1, 1)}


def _fitted_controlled(lat, batch, n_epochs):
    model = controlled(build_phi4_model(lat))
    hist = model.fit(n_epochs=n_epochs, batch_size=batch,
                     scheduler=cosine_decay_schedule(1.0, decay_steps=20,
                                                     alpha=0.05), **BENCH)
    return model, hist


def test_controlled_replays_draw_new_controls(cuda):
    model, hist = _fitted_controlled((8, 8), 64, 3)
    assert np.isfinite(hist["loss"]).all()
    cpl = model.net_[2]
    ptr = cpl.control.data_ptr()
    seen = []
    for _ in range(2):
        model.fit.step()
        seen.append(cpl.control.clone())
    assert cpl.control.data_ptr() == ptr and cpl.control.shape == (64, 8, 4)
    assert not torch.equal(seen[0], seen[1])


def test_controlled_replayed_steps_match_eager_steps(cuda):
    torch.backends.cudnn.deterministic = True
    model, _ = _fitted_controlled((8, 8), 64, 0)
    fit = model.fit
    live = fit.params + optim.state_leaves(fit.opt_state)
    start = ([t.detach().clone() for t in live], model.generator.get_state())

    def run(step):
        with torch.no_grad():
            for t, v in zip(live, start[0]):
                t.copy_(v)
        model.generator.set_state(start[1])
        losses = torch.stack([step()[0] for _ in range(10)])
        return losses, [t.detach().clone() for t in live]

    replayed = run(fit.step)
    assert fit.step_graph() is not None
    eager = run(fit.train_body)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(replayed[0]).all())
    assert _same_bits((replayed[0],), (eager[0],))
    assert _same_bits(replayed[1], eager[1])


def test_controlled_replay_launches_every_kernel_tiled(cuda):
    model, _ = _fitted_controlled((32, 32), 512, 1)
    step = {"rqs_coupling": (8, 8), "rqs_coupling_bwd": (8, 8),
            "phi4_action": (1, 1), "phi4_action_grad": (1, 1)}
    assert device_launches(model.fit.step)[0] == step


def test_trace_writes_a_chrome_trace(cuda, tmp_path):
    model = _perturbed(build_phi4_model((8, 8)))
    model.posterior.logqp_stream(1, 64)
    with trace(str(tmp_path / "tr")) as logdir:
        model.posterior.logqp_stream(1, 64)
    with open(f"{logdir}/trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("rqs_coupling" in n for n in names)
