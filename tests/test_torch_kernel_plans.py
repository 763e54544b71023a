"""Host-side plans of the port's tiled kernels, and the kernel timing tool.

The tiled CUDA kernels run only on the card (``tests/test_torch_cuda*.py``,
marker ``gpu``), but the wrappers choose between variants, and plan the
tiled action's blocks, on the host by shape and alignment alone: these
tests hold that logic, and the bytes, bounds and output comparison of
``normflow__tpu_torch/tools/kernel_times.py``, on the CPU.
"""

import pytest
import torch

from normflow__tpu_torch.ops.kernels import phi4, spline_coupling as sc
from normflow__tpu_torch.tools import kernel_times as kt


@pytest.mark.parametrize("s,offsets,variant", [
    (512, (0, 0, 0, 0, 0, 0), "tiled"),     # the flagship's 32x16 sites
    (240, (0, 0, 0, 0, 0, 0), "tiled"),     # a ragged last tile
    (4, (0, 0, 0, 0, 0, 0), "tiled"),
    (35, (0, 0, 0, 0, 0, 0), "sites"),      # S % 4 != 0: rows off 16 bytes
    (512, (0, 4, 0, 0, 0, 0), "sites"),     # out at a storage offset
    (512, (0, 0, 0, 0, 8, 0), "sites"),     # an output off 16 bytes
    (512, (0, 0, 0, 0, 0, 12), "sites"),    # outbar off 16 bytes
    (512, (16, 32, 48, 64, 80, 96), "tiled"),  # offsets of whole 16 bytes
    (1, (0, 0, 0, 0, 0, 0), "sites"),       # one site per sample
    (2, (0, 0, 0, 0, 0, 0), "sites"),
    (6, (0, 0, 0, 0, 0, 0), "sites"),
    (8, (0, 0, 0, 0, 0, 0), "tiled"),
    (128, (0, 0, 0, 0, 0, 0), "tiled"),     # one whole tile
    (132, (0, 0, 0, 0, 0, 0), "tiled"),     # a last tile of 4 sites
    (1024, (0, 0, 4, 4, 0, 0), "sites"),    # the cotangents off 16 bytes
])
def test_bwd_variant_by_shape_and_alignment(s, offsets, variant):
    ptrs = [(1 << 20) + 512 * k + o for k, o in enumerate(offsets)]
    assert sc.bwd_variant(s, ptrs) == variant


@pytest.mark.parametrize("lat,plan", [
    ((32, 32), (256, 1)), ((16, 16), (64, 4)), ((1, 128), (32, 8)),
    ((64, 64), (1024, 1)), ((8, 16), (32, 8)), ((128, 64), None),
    ((8, 8), None), ((5, 7), None), ((6, 30), None), ((64,), None),
    ((4, 4, 4), None), ((1,), None),
])
def test_action_plan(lat, plan):
    assert phi4.action_plan(lat) == plan
    if plan is not None:
        groups, samples = plan
        assert groups * 4 == lat[0] * lat[1] and groups % 32 == 0
        assert groups * samples <= 1024


@pytest.mark.parametrize("lat,ptr,variant", [
    ((32, 32), 1 << 20, "tiled"), ((32, 32), (1 << 20) + 4, "general"),
    ((32, 32), (1 << 20) + 16, "tiled"), ((5, 7), 1 << 20, "general"),
    ((1,), 1 << 20, "general"), ((4, 4, 4), 1 << 20, "general"),
    ((16, 16), (1 << 20) + 8, "general"), ((16, 16), (1 << 20) + 32, "tiled"),
    ((64,), 1 << 20, "general"), ((6, 30), 1 << 20, "general"),
])
def test_action_variant(lat, ptr, variant):
    assert phi4.action_variant(lat, ptr) == variant


@pytest.mark.parametrize("name,shape,nbytes", [
    ("rqs_coupling", (1024, 22, 32, 16), 1024 * 512 * 4 * 25),
    ("rqs_coupling_bwd", (512, 22, 32, 16), 512 * 512 * 4 * 48),
    ("phi4_action", (1024, 32, 32), 1024 * 1024 * 4 + 1024 * 4),
    ("phi4_action_grad", (512, 32, 32), 512 * 1024 * 8 + 512 * 4),
])
def test_kernel_bytes_and_bound(name, shape, nbytes):
    got, nops = kt.work(name, shape)
    assert got == nbytes and nops > 0
    peaks = kt.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == (3.35e12, 67e12)
    ms, by = kt.bound_ms(got, nops, peaks)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def test_card_peaks_refuses_an_unknown_card():
    assert kt.card_peaks("NVIDIA H100 PCIe")[0] == 2.0e12
    with pytest.raises(RuntimeError, match="no published peaks"):
        kt.card_peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("kernel,name,hit", [
    ("rqs_coupling", "void (anonymous namespace)::rqs_coupling_kernel<8, "
     "true, true, false>(float const*)", True),
    ("rqs_coupling", "void (anonymous namespace)::rqs_coupling_bwd_kernel"
     "<8, true, true, false>(float const*)", False),
    ("rqs_coupling_bwd", "void (anonymous namespace)::"
     "rqs_coupling_bwd_tiled_kernel<8, true, true, true>(float const*)",
     True),
    ("rqs_coupling_bwd", "rqs_coupling_bwd_kernel<4, false, false, false>",
     True),
    ("phi4_action", "(anonymous namespace)::phi4_action_tiled_kernel(float "
     "const*, float*, long long, int, int, float, float, float)", True),
    ("phi4_action", "phi4_action_kernel(float const*)", True),
    ("phi4_action", "phi4_action_grad_kernel(float const*)", False),
    ("phi4_action_grad", "phi4_action_grad_kernel(float const*)", True),
])
def test_profiler_names_pick_each_kernel(kernel, name, hit):
    import re

    assert bool(re.search(kt.KERNEL_RE[kernel], name)) is hit


def _saved(tmp_path, label, bwd_bits=0, action_rel=0.0):
    gen = torch.Generator().manual_seed(3)
    out = {"card": "cpu"}
    for case in ("rqs_coupling", "rqs_coupling_bwd forward",
                 "rqs_coupling_bwd inverse", "phi4_action_grad"):
        out[case] = [torch.randn(4, 8, generator=gen),
                     torch.randn(4, generator=gen)]
    out["phi4_action"] = [torch.randn(16, generator=gen) * 100]
    out["rqs_coupling_bwd inverse"][0].view(torch.int32)[0, 0] += bwd_bits
    out["phi4_action"][0] *= 1 + action_rel
    path = tmp_path / f"{label}.pt"
    torch.save(out, path)
    return str(path)


@pytest.mark.parametrize("bwd_bits,action_rel,rc", [
    (0, 0.0, 0), (0, 1e-6, 0), (1, 0.0, 1), (0, 3e-5, 1),
])
def test_compare_holds_bits_and_the_action_bar(tmp_path, capsys, bwd_bits,
                                               action_rel, rc):
    """One ulp in a backward output fails; the action passes within 2e-5
    relative and fails beyond."""
    a = _saved(tmp_path, "a")
    b = _saved(tmp_path, "b", bwd_bits, action_rel)
    assert kt.compare(a, b) == rc
    assert ("FAILED" in capsys.readouterr().out) is bool(rc)
