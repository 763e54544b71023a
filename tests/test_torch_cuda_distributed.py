"""Data parallelism on the card: a world-size-1 NCCL group, in process.

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``,
skip without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_distributed.py

One card holds one rank (NCCL refuses two ranks on one card), so the group
has one rank; its collectives still run, inside the captured graphs
(``normflow__tpu_torch/parallel/mesh.py``).  Held here, with TF32 off:

- the group is NCCL and attached;
- 10 replayed training steps, each with the gradients' all-reduce in it,
  against 10 eager bodies from the same state, bit for bit (cuDNN
  deterministic), and the same loss as the model without a group;
- one replayed step's launches by profiler name: 4 / 4 / 1 / 1 of the
  port's kernels (the reparametrization estimator: 4 coupling forwards
  and their VJPs), every one tiled (a one-rank all-reduce launches no
  NCCL kernel);
- a replayed ``sample_chain`` round (its gather in the graph) against its
  eager body, bit for bit, and ``sample_parallel_chains``' outputs at the
  global shapes.
"""

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from normflow__tpu_torch.models.nets import CircularConv
from normflow__tpu_torch.parallel import free_port, init_distributed
from normflow__tpu_torch.tools.kernel_times import device_launches
from normflow__tpu_torch.training import optim
from normflow__tpu_torch.utils.transplant import jax_leaf_order
from normflow__tpu_torch.zoo import build_phi4_model

pytestmark = pytest.mark.gpu

FIT = dict(hyperparam=dict(lr=3e-3, weight_decay=1e-4),
           checkpoint_dict=dict(print_stride=None))


@pytest.fixture(scope="module")
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    init_distributed(rank=0, world_size=1,
                     init_method=f"tcp://localhost:{free_port()}")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture
def cuda(group):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield group
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _model(lat=(64, 64), attach=True):
    """The config 4 flagship (hidden (16, 16)) at ``lat``, weights plus
    seeded noise, attached to the group."""
    model = build_phi4_model(lat, hidden=(16, 16), seed=0)
    rng = np.random.default_rng(20261019)
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(model.net_):
            s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                if isinstance(owner, CircularConv) else 0.3
            p.add_(torch.tensor(rng.standard_normal(tuple(p.shape)) * s,
                                dtype=p.dtype, device=p.device))
    if attach:
        model.device_handler.use_mesh(n_devices=1)
    return model


def _same_bits(a, b):
    return all(torch.equal(p.reshape(-1).view(torch.uint8),
                           q.reshape(-1).view(torch.uint8))
               for p, q in zip(a, b, strict=True))


def test_the_group_is_nccl_and_attached(cuda):
    model = _model((16, 16))
    assert dist.get_backend() == "nccl"
    assert model.device_handler.group is not None
    assert model.device_handler.nranks == 1


def test_replayed_steps_with_the_all_reduce_match_eager(cuda):
    model = _model()
    fit = model.fit
    fit(n_epochs=2, batch_size=512, **FIT)
    live = fit.params + optim.state_leaves(fit.opt_state)
    start = ([t.detach().clone() for t in live], model.generator.get_state())

    def run(step):
        with torch.no_grad():
            for t, v in zip(live, start[0]):
                t.copy_(v)
        model.generator.set_state(start[1])
        return (torch.stack([step()[0] for _ in range(10)]),
                [t.detach().clone() for t in live])

    replayed = run(fit.step)
    eager = run(fit.train_body)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(replayed[0]).all())
    assert _same_bits((replayed[0],), (eager[0],))
    assert _same_bits(replayed[1], eager[1])

    plain = _model(attach=False)  # the same fit without a group
    plain.fit(n_epochs=2, batch_size=512, **FIT)
    assert _same_bits(plain.fit.params, start[0][:len(plain.fit.params)])


def test_one_replayed_step_launches_every_kernel_tiled(cuda):
    model = _model()
    model.fit(n_epochs=1, batch_size=512, **FIT)

    def replay():
        model.fit.step_graph().graph.replay()

    launches = device_launches(replay)[0]
    assert launches == {"rqs_coupling": (4, 4), "rqs_coupling_bwd": (4, 4),
                        "phi4_action": (1, 1),
                        "phi4_action_grad": (1, 1)}, launches


def test_replayed_chain_round_with_the_gather_matches_eager(cuda):
    model = _model()
    mcmc = model.mcmc
    model.seed(5)
    got = mcmc.sample_chain(2, 1024, collect_samples=True)
    mcmc.reset()
    model.seed(5)
    carry = mcmc._zero_carry(())
    carry[1].fill_(math.inf)
    want = [mcmc.chain_body(1024, model.generator, carry)[:3]
            for _ in range(2)]
    torch.cuda.synchronize()
    for i, (y, lq, lp) in enumerate(want):
        assert _same_bits((got["samples"][i], got["logq"][i],
                           got["logp"][i]), (y, lq, lp))


def test_parallel_chains_gather_to_global_shapes(cuda):
    model = _model()
    out = model.mcmc.sample_parallel_chains(3, 1024, collect_samples=True)
    assert out["samples"].shape == (3, 1024, 64, 64)
    assert out["logq"].shape == (3, 1024)
    assert out["final_samples"].shape == (1024, 64, 64)
    assert bool(torch.isfinite(out["logq"]).all())
