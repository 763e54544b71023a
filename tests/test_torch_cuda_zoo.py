"""The flow zoo's new paths on the card: the unpacked flagship and the 8x8
affine example.

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``, skip
without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_zoo.py

Held here, with TF32 off:

- ``rqs_coupling`` (forward and inverse, B = 1024 and 512) and
  ``rqs_coupling_bwd`` (B = 512) at the unpacked flagship's S = 1024 sites
  against their plain versions, on the tiled kernels;
- the unpacked flagship's replayed batch against its eager body, bit for
  bit;
- the affine example's guarded training step on the card against a float64
  CPU copy on the same draw, its action and force on the general kernels;
- a wrapper raising for a CUDA tensor it does not take: the coupling
  kernel at a knot count it was not built for, reached through a fusable
  ``RQSplineCoupling``.
"""

import copy
import math

import numpy as np
import pytest
import torch

from normflow__tpu_torch.examples import scalar_affine as affine
from normflow__tpu_torch.models.couplings import RQSplineCoupling
from normflow__tpu_torch.models.masks import EvenOddMask
from normflow__tpu_torch.models.nets import CircularConv, ConvNet
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.utils.transplant import jax_leaf_order
from normflow__tpu_torch.zoo import build_phi4_model

pytestmark = pytest.mark.gpu

LIM = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear", right="linear")


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


@pytest.fixture
def np_rng():
    return np.random.default_rng(20261017)


def _f32(rng, shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device="cuda")


def _perturb_(net, rng):
    with torch.no_grad():
        for owner, _, p in jax_leaf_order(net):
            s = 0.3 / math.sqrt(math.prod(p.shape[1:])) \
                if isinstance(owner, CircularConv) else 0.3
            p.add_(torch.tensor(rng.standard_normal(tuple(p.shape)) * s,
                                dtype=p.dtype, device=p.device))


@pytest.mark.parametrize("b", [1024, 512])
@pytest.mark.parametrize("inverse", [False, True])
def test_coupling_at_1024_sites_matches_plain(cuda, np_rng, b, inverse):
    x, out = _f32(np_rng, (b, 32, 32)), _f32(np_rng, (b, 22, 32, 32))
    tiled = sc.rqs_coupling.tiled_launches
    y, g = sc.rqs_coupling(x, out, inverse=inverse, **LIM)
    yp, gp = sc.rqs_coupling_plain(x, out, inverse=inverse, **LIM)
    assert sc.rqs_coupling.tiled_launches == tiled + 1
    assert float((y - yp).abs().max()) <= 1e-4
    assert float((g - gp).abs().max()) <= 1e-4


@pytest.mark.parametrize("inverse", [False, True])
def test_coupling_vjp_at_1024_sites_matches_plain(cuda, np_rng, inverse):
    b = 512
    x, out = _f32(np_rng, (b, 32, 32)), _f32(np_rng, (b, 22, 32, 32))
    ybar, loggbar = _f32(np_rng, (b, 32, 32)), _f32(np_rng, (b, 32, 32))
    tiled = sc.rqs_coupling_bwd.tiled_launches
    got = sc.rqs_coupling_bwd(x, out, ybar, loggbar, inverse=inverse, **LIM)
    want = sc.rqs_coupling_vjp_plain(x, out, ybar, loggbar, inverse=inverse,
                                     **LIM)
    assert sc.rqs_coupling_bwd.tiled_launches == tiled + 1
    for g, w in zip(got, want):
        assert bool(((g - w).abs() <= 2e-4 + 2e-4 * w.abs()).all())


def test_unpacked_replayed_batch_matches_the_eager_body(cuda):
    model = build_phi4_model((32, 32), packed=False, seed=0)
    _perturb_(model.net_, np.random.default_rng(3))
    model.seed(11)
    got = model.posterior.logqp_stream(2, 1024)
    model.seed(11)
    want = torch.cat([model.posterior.logqp_batch(1024, model.generator)
                      for _ in range(2)])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_affine_step_on_the_card_matches_float64(cuda, np_rng):
    """One reparametrisation-gradient step of the example's loss at batch
    128 on the card against a float64 CPU copy: the loss to 1e-5
    (relative), every leaf's gradient to 1e-3 (relative norm); the action
    and its force take their general kernels (8x8 has no tile)."""
    model = affine.main(n_epochs=0, device="cuda", print_stride=None)
    _perturb_(model.net_, np_rng)
    cpu = affine.main(n_epochs=0, device="cpu", dtype=torch.float64,
                      print_stride=None)
    cpu.net_.load_state_dict({k: v.double().cpu() for k, v in
                              model.net_.state_dict().items()})
    x = np_rng.standard_normal((128, 8, 8))
    res = []
    before = (phi4.phi4_action.tiled_launches,
              phi4.phi4_action_grad.tiled_launches,
              phi4.phi4_action_grad.launches)
    for m, dtype in ((model, torch.float32), (cpu, torch.float64)):
        xd = torch.tensor(x, dtype=dtype, device=m.device)
        loss, _, _ = m.fit.loss_of(xd, m.prior.log_prob(xd))
        grads = torch.autograd.grad(loss, list(m.net_.parameters()))
        res.append((float(loss.detach()), [g.double().cpu() for g in grads]))
    assert (phi4.phi4_action.tiled_launches,
            phi4.phi4_action_grad.tiled_launches) == before[:2]
    assert phi4.phi4_action_grad.launches == before[2] + 1
    (lg, gg), (lc, gc) = res
    assert abs(lg - lc) <= 1e-5 * max(1.0, abs(lc))
    for a, b in zip(gg, gc):
        assert float((a - b).norm()) <= 1e-3 * max(float(b.norm()), 1e-30)


def test_unsupported_knot_count_raises_on_the_card(cuda):
    m = 5
    assert m not in sc.SUPPORTED_KNOTS
    flow = RQSplineCoupling([ConvNet(1, 3 * m - 2, 3, device="cuda")],
                            mask=EvenOddMask(shape=(8, 8)),
                            extrap={"left": "linear", "right": "linear"},
                            xlim=(-4.0, 4.0), ylim=(-4.0, 4.0))
    assert flow._can_fuse()
    with pytest.raises(ValueError, match="knots"):
        flow.forward(torch.zeros((2, 8, 8), device="cuda"))
    plain = copy.deepcopy(flow).cpu()
    y, _ = plain.forward(torch.zeros((2, 8, 8)))  # the CPU's plain version
    assert bool(torch.isfinite(y).all())
