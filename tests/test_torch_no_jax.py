"""The port stands alone: no JAX, nothing of the JAX package, GPU by default."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax)\b|from\s+(jax|flax|optax)\b"
    r"|import\s+normflow__tpu(\.|\s|,|$)|from\s+normflow__tpu(\.|\s))",
    re.MULTILINE)


def test_import_leaves_jax_out():
    code = ("import sys, normflow__tpu_torch, normflow__tpu_torch.zoo\n"
            "import normflow__tpu_torch.parallel.dryrun\n"
            "import normflow__tpu_torch.parallel.space\n"
            "import normflow__tpu_torch.examples.scalar_64x64_distributed\n"
            "import normflow__tpu_torch.examples.scalar_zerodim\n"
            "import normflow__tpu_torch.utils.profiling\n"
            "import normflow__tpu_torch.nn.scalar.cntr_couplings_\n"
            "import normflow__tpu_torch.tools.protocol_run\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'normflow__tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_sources_import_no_jax():
    files = sorted((ROOT / "normflow__tpu_torch").rglob("*.py"))
    # and what runs on the card, where JAX is not installed
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
              ROOT / "tests" / "test_torch_cuda_grad.py",
              ROOT / "tests" / "test_torch_cuda_graphs.py",
              ROOT / "tests" / "test_torch_cuda_mcmc.py",
              ROOT / "tests" / "test_torch_cuda_zoo.py",
              ROOT / "tests" / "test_torch_cuda_gauge.py",
              ROOT / "tests" / "test_torch_cuda_distributed.py",
              ROOT / "tests" / "test_torch_cuda_bf16_cntr.py",
              ROOT / "tests" / "_torch_ddp_worker.py",
              ROOT / "tests" / "_torch_space_worker.py",
              ROOT / "tests" / "_torch_4d_worker.py",
              ROOT / "tests" / "test_torch_cuda_space.py",
              ROOT / "tests" / "test_torch_cuda_channels_last.py",
              ROOT / "normflow__tpu_torch" / "parallel" / "space.py",
              ROOT / "normflow__tpu_torch" / "parallel" / "mesh.py",
              ROOT / "normflow__tpu_torch" / "parallel" / "dryrun.py",
              ROOT / "normflow__tpu_torch" / "examples"
              / "scalar_64x64_distributed.py",
              ROOT / "normflow__tpu_torch" / "ops" / "kernels"
              / "accept_scan.py",
              ROOT / "normflow__tpu_torch" / "models" / "gauge.py",
              ROOT / "normflow__tpu_torch" / "models" / "fermions.py",
              ROOT / "normflow__tpu_torch" / "examples" / "u1_gauge.py",
              ROOT / "normflow__tpu_torch" / "examples" / "schwinger.py",
              ROOT / "normflow__tpu_torch" / "examples" / "scalar_zerodim.py",
              ROOT / "normflow__tpu_torch" / "utils" / "profiling.py",
              ROOT / "normflow__tpu_torch" / "models" / "couplings.py",
              ROOT / "normflow__tpu_torch" / "models" / "nets.py",
              ROOT / "normflow__tpu_torch" / "nn" / "scalar"
              / "cntr_couplings_.py",
              ROOT / "normflow__tpu_torch" / "bench.py",
              ROOT / "normflow__tpu_torch" / "tools" / "protocol_run.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert not offenders


def test_forbidden_pattern_catches_jax_imports():
    for line in ("import jax", "from jax import numpy", "import optax",
                 "from normflow__tpu.zoo import x", "import normflow__tpu",
                 "from normflow__tpu import zoo", "  import flax.linen"):
        assert FORBIDDEN.search(line), line
    for line in ("import normflow__tpu_torch", "from normflow__tpu_torch "
                 "import zoo", "from .jax_like import x"):
        assert not FORBIDDEN.search(line), line


def test_default_device_is_the_gpu():
    from normflow__tpu_torch.examples import (scalar_zerodim, schwinger,
                                              u1_gauge)
    from normflow__tpu_torch.zoo import build_phi4_model, build_u1_model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for entry in (build_phi4_model, build_u1_model, u1_gauge.main,
                  schwinger.main, scalar_zerodim.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
