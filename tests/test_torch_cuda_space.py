"""The slab kernels of lattice sharding on the card (``chip_smoke.py``
phase 21, step 1).

Like ``tests/test_torch_cuda.py`` these need a CUDA card and ``nvcc``,
skip without a card, and import nothing of JAX::

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_space.py

A field is cut into two slabs with halos built by hand (the row before
each slab and the row after it, periodic over the lattice); the slab
action and force (``ops.kernels.phi4.phi4_action_slab`` /
``phi4_action_slab_grad``) on each, summed and stacked, must match the
whole-lattice tiled kernels and the plain slab versions, at the flagship's
(1024, 32, 32) and config 4's (1024, 64, 64) on the tiled kernels and at
(128, 8, 8) on the general ones, with the smoke's tolerances (the action
2e-5 relative to max(1, |S|), the force rtol 2e-4 and atol 2e-5, as
``tests/test_kernels.py:36-37``); the tiled slab force equals the general
one bit for bit.  A lattice whose rows do not split evenly
(``parallel/space.slab_of``: the flagship's 32 rows over three ranks are
11, 11 and 10) takes the general slab kernels and holds the same bars; a
slab of no rows and a coupling of no sites launch nothing (the wrappers
decide by shape) and return the empty or zero result.
"""

import numpy as np
import pytest
import torch

from normflow__tpu_torch.models.actions import ScalarPhi4Action
from normflow__tpu_torch.ops.kernels import phi4, spline_coupling
from normflow__tpu_torch.parallel import space

pytestmark = pytest.mark.gpu

PHI4_REL_TOL, FORCE_RTOL, FORCE_ATOL = 2e-5, 2e-4, 2e-5
W = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def slabs(cfgs, n=2):
    l0 = cfgs.shape[1]
    rows = l0 // n
    return [(cfgs[:, r * rows:(r + 1) * rows].contiguous(),
             torch.stack([cfgs[:, (r * rows - 1) % l0],
                          cfgs[:, ((r + 1) * rows) % l0]], 1).contiguous())
            for r in range(n)]


def xla_slabs(cfgs, m):
    """The ``m`` slabs of ``cfgs`` as ``space.slab_of`` splits the rows,
    with their halos built by hand."""
    l0, out = cfgs.shape[1], []
    for r in range(m):
        s = space.slab_of(None, r, m, l0)
        out.append((cfgs[:, s.row0:s.row0 + s.rows].contiguous(),
                    torch.stack([cfgs[:, (s.row0 - 1) % l0],
                                 cfgs[:, (s.row0 + s.rows) % l0]],
                                1).contiguous()))
    return out


@pytest.mark.parametrize("shape,m", [((1024, 32, 32), 3),
                                     ((1024, 10, 32), 2),
                                     ((256, 9, 8), 2),
                                     ((64, 5, 4, 4, 4), 3)])
def test_ragged_slabs_match_the_whole_lattice(cuda, shape, m):
    """(1024, 11, 32) and (1024, 10, 32), (1024, 5, 32) twice, and other
    ragged splits: one launch each per slab, on the general slab kernels
    but for the 4-D split's two slabs of 2 rows (32 float4s a sample),
    which take the tiled nd ones, summed and stacked against the
    whole-lattice kernels and the plain slab versions."""
    tiled = {(64, 5, 4, 4, 4): 2}.get(shape, 0)
    rng = np.random.default_rng(23)
    cfgs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    g = torch.tensor(rng.standard_normal(shape[0]), dtype=torch.float32,
                     device=cuda)
    w = ScalarPhi4Action(kappa=0.6, m_sq=-2.4, lambd=0.5).get_coef(
        len(shape) - 1)
    counters = (phi4.phi4_action_slab, phi4.phi4_action_slab_grad)
    before = [(c.launches, c.tiled_launches) for c in counters]
    act, plain_act, force, plain_force = 0, 0, [], []
    for slab, halo in xla_slabs(cfgs, m):
        act = act + phi4.phi4_action_slab(slab, halo, *w)
        plain_act = plain_act + phi4.phi4_action_slab_plain(slab, halo, *w)
        force.append(phi4.phi4_action_slab_grad(slab, halo, g, *w))
        plain_force.append(phi4.phi4_action_slab_grad_plain(slab, halo, g,
                                                            *w))
    force, plain_force = torch.cat(force, 1), torch.cat(plain_force, 1)
    torch.cuda.synchronize()
    after = [(c.launches, c.tiled_launches) for c in counters]
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] \
        == [(m, tiled)] * 2
    for want in (phi4.phi4_action(cfgs, *w), plain_act):
        rel = ((act - want).abs() / want.abs().clamp(min=1.0)).max()
        assert float(rel) <= PHI4_REL_TOL
    for want in (phi4.phi4_action_grad(cfgs, g, *w), plain_force):
        assert bool(((force - want).abs()
                     <= FORCE_ATOL + FORCE_RTOL * want.abs()).all())


def test_zero_row_slab_launches_nothing(cuda):
    """The empty slab of 4 rows over three ranks: the action is zero, the
    force empty, through the wrappers and autograd, with no launch."""
    cfgs = torch.zeros(16, 0, 32, device=cuda)
    halo = torch.randn(16, 2, 32, device=cuda)
    g = torch.randn(16, device=cuda)
    counters = (phi4.phi4_action_slab, phi4.phi4_action_slab_grad)
    before = [c.launches for c in counters]
    x = cfgs.clone().requires_grad_(True)
    act = phi4.phi4_action_slab(x, halo, *W)
    (gx,) = torch.autograd.grad((g * act).sum(), x)
    force = phi4.phi4_action_slab_grad(cfgs, halo, g, *W)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert act.shape == (16,) and not bool(act.any())
    assert gx.shape == force.shape == (16, 0, 32)


def test_zero_site_coupling_launches_nothing(cuda):
    """A coupling on an empty slab's packed partition (no sites): empty
    results and cotangents, forward and inverse, with no launch."""
    cfg = dict(xlim=(-4.0, 4.0), ylim=(-4.0, 4.0), left="linear",
               right="linear")
    counters = (spline_coupling.rqs_coupling, spline_coupling.rqs_coupling_bwd)
    before = [c.launches for c in counters]
    for inverse in (False, True):
        x = torch.zeros(16, 0, 16, device=cuda, requires_grad=True)
        out = torch.zeros(16, 22, 0, 16, device=cuda, requires_grad=True)
        y, logg = spline_coupling.rqs_coupling(x, out, inverse=inverse,
                                               **cfg)
        gx, gout = torch.autograd.grad((y.sum() + logg.sum()), (x, out))
        assert y.shape == logg.shape == gx.shape == x.shape
        assert gout.shape == out.shape
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("shape,tiled", [((1024, 32, 32), True),
                                         ((1024, 64, 64), True),
                                         ((128, 8, 8), False)])
def test_two_slabs_match_the_whole_lattice(cuda, shape, tiled):
    rng = np.random.default_rng(21)
    cfgs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    g = torch.tensor(rng.standard_normal(shape[0]), dtype=torch.float32,
                     device=cuda)
    before = (phi4.phi4_action_slab.tiled_launches,
              phi4.phi4_action_slab_grad.tiled_launches)
    act, plain_act, force, plain_force = 0, 0, [], []
    for slab, halo in slabs(cfgs):
        act = act + phi4.phi4_action_slab(slab, halo, *W)
        plain_act = plain_act + phi4.phi4_action_slab_plain(slab, halo, *W)
        force.append(phi4.phi4_action_slab_grad(slab, halo, g, *W))
        plain_force.append(phi4.phi4_action_slab_grad_plain(slab, halo, g,
                                                            *W))
    force, plain_force = torch.cat(force, 1), torch.cat(plain_force, 1)
    torch.cuda.synchronize()
    after = (phi4.phi4_action_slab.tiled_launches,
             phi4.phi4_action_slab_grad.tiled_launches)
    assert [a - b for a, b in zip(after, before)] == [2 * tiled] * 2
    for want in (phi4.phi4_action(cfgs, *W), plain_act):
        rel = ((act - want).abs() / want.abs().clamp(min=1.0)).max()
        assert float(rel) <= PHI4_REL_TOL
    for want in (phi4.phi4_action_grad(cfgs, g, *W), plain_force):
        assert bool(((force - want).abs()
                     <= FORCE_ATOL + FORCE_RTOL * want.abs()).all())


def test_tiled_slab_force_equals_the_general_one(cuda):
    rng = np.random.default_rng(22)
    cfgs = torch.tensor(rng.standard_normal((512, 32, 32)),
                        dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.standard_normal(512), dtype=torch.float32,
                     device=cuda)
    slab, halo = slabs(cfgs)[1]
    buf = torch.empty(slab.numel() + 1, dtype=slab.dtype, device=cuda)
    offset = buf[1:].view(slab.shape)  # 4 bytes off: the general kernel
    offset.copy_(slab)
    tiled = phi4.phi4_action_slab_grad(slab, halo, g, *W)
    general = phi4.phi4_action_slab_grad(offset, halo, g, *W)
    assert torch.equal(tiled.view(torch.int32), general.view(torch.int32))


def test_slab_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    cfgs = torch.zeros(4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="halo"):
        phi4.phi4_action_slab(cfgs, torch.zeros(4, 3, 8, device=cuda), *W)
    with pytest.raises(ValueError, match="halo"):
        phi4.phi4_action_slab(cfgs, torch.zeros(4, 2, 8), *W)
    with pytest.raises(TypeError):
        phi4.phi4_action_slab(cfgs.double(), torch.zeros(
            4, 2, 8, device=cuda, dtype=torch.float64), *W)
