"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``normflow__tpu_torch/csrc/`` is compiled with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The build happens at first use, into
``normflow__tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so a fresh checkout builds everything the first time a kernel is
launched.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "build_info", "check"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# --fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round operation by operation as their plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libnormflow_kernels.so"

_lock = threading.Lock()
_lib = None
build_info: dict = {}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures: every function returns cudaGetLastError() after its launch
_SIGNATURES = {
    # x, out, y, logg, B, S, m, xlo, xw, ylo, yw, left_linear,
    # right_linear, inverse, stream (every variant; out channels-last for
    # the _cl ones)
    "rqs_coupling_f32": (_P, _P, _P, _P, _L, _L, _I, _F, _F, _F, _F, _I,
                         _I, _I, _P),
    "rqs_coupling_tiled_f32": (_P, _P, _P, _P, _L, _L, _I, _F, _F, _F, _F,
                               _I, _I, _I, _P),
    "rqs_coupling_cl_f32": (_P, _P, _P, _P, _L, _L, _I, _F, _F, _F, _F, _I,
                            _I, _I, _P),
    "rqs_coupling_cl_tiled_f32": (_P, _P, _P, _P, _L, _L, _I, _F, _F, _F,
                                  _F, _I, _I, _I, _P),
    # x, out, ybar, loggbar, xbar, outbar, B, S, m, xlo, xw, ylo, yw,
    # left_linear, right_linear, inverse, stream (every variant)
    "rqs_coupling_bwd_f32": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _F, _F,
                             _F, _F, _I, _I, _I, _P),
    "rqs_coupling_bwd_tiled_f32": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _F,
                                   _F, _F, _F, _I, _I, _I, _P),
    "rqs_coupling_bwd_cl_f32": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _F, _F,
                                _F, _F, _I, _I, _I, _P),
    "rqs_coupling_bwd_cl_tiled_f32": (_P, _P, _P, _P, _P, _P, _L, _L, _I,
                                      _F, _F, _F, _F, _I, _I, _I, _P),
    # cfgs, act, B, nd, L0, L1, L2, L3, w0, w2, w4, stream
    "phi4_action_f32": (_P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    # cfgs, act, B, L0, L1, samples, w0, w2, w4, stream
    "phi4_action_tiled_f32": (_P, _P, _L, _I, _I, _I, _F, _F, _F, _P),
    # cfgs, g, grad, B, nd, L0, L1, L2, L3, w0, w2, w4, stream
    "phi4_action_grad_f32": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F,
                             _F, _P),
    # the tiled kernels at 3-D and 4-D: the general kernels' arguments
    "phi4_action_tiled_nd_f32": (_P, _P, _L, _I, _I, _I, _I, _I, _F, _F,
                                 _F, _P),
    "phi4_action_grad_tiled_nd_f32": (_P, _P, _P, _L, _I, _I, _I, _I, _I,
                                      _F, _F, _F, _P),
    # cfgs, g, grad, B, L0, L1, samples, w0, w2, w4, stream
    "phi4_action_grad_tiled_f32": (_P, _P, _P, _L, _I, _I, _I, _F, _F, _F,
                                   _P),
    # the slab variants: the halo after the field
    "phi4_action_slab_f32": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F,
                             _F, _P),
    "phi4_action_slab_tiled_f32": (_P, _P, _P, _L, _I, _I, _I, _F, _F, _F,
                                   _P),
    "phi4_action_grad_slab_f32": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                  _F, _F, _F, _P),
    "phi4_action_grad_slab_tiled_f32": (_P, _P, _P, _P, _L, _I, _I, _I, _F,
                                        _F, _F, _P),
    # the tiled nd slab kernels: the general slab kernels' arguments
    "phi4_action_slab_tiled_nd_f32": (_P, _P, _P, _L, _I, _I, _I, _I, _I,
                                      _F, _F, _F, _P),
    "phi4_action_grad_slab_tiled_nd_f32": (_P, _P, _P, _P, _L, _I, _I, _I,
                                           _I, _I, _F, _F, _F, _P),
    # lrand, logqp, ref, accept, indices, n, stream
    "accept_scan_f32": (_P, _P, _P, _P, _P, _L, _P),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME is not None:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build normflow__tpu_torch's kernels")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, cwd):
    """Start every command at once, wait for all, raise with stderr."""
    procs = [(cmd, subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, p in procs:
        out, err = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def _build(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (cu.stem + ".o") for cu in cus]
        log = _run_all([[nvcc, "--version"]] + [
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o", str(o)]
            for cu, o in zip(cus, objs)], tmp)
        log += _run_all([[nvcc, "-shared", "-o", str(tmp / _LIB_NAME),
                          *map(str, objs)]], tmp)
        (tmp / "build.log").write_text(log)
        try:
            os.replace(tmp, target)  # atomic: a concurrent build may win
        except OSError:
            if not (target / _LIB_NAME).exists():
                raise
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_ROOT / _digest()
        t0 = time.perf_counter()
        built = not (target / _LIB_NAME).exists()
        if built:
            _build(target)
        lib = ctypes.CDLL(str(target / _LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.normflow_cuda_error_string.argtypes = [ctypes.c_int]
        lib.normflow_cuda_error_string.restype = ctypes.c_char_p
        build_info.update(path=str(target / _LIB_NAME), built=built,
                          seconds=time.perf_counter() - t0,
                          log=str(target / "build.log"))
        _lib = lib
        return lib


def check(err: int, name: str):
    """Raise if a launch reported an error (a refused launch never runs,
    and a later synchronise would not say so)."""
    if err != 0:
        what = _lib.normflow_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {what} ({err})")
