"""The Metropolis accept/reject recurrence over a chain of proposals.

Counterpart of ``_accept_scan_core`` / ``accept_scan``
(``normflow__tpu/mcmc/metropolis.py:31-75``), standard rule: proposal ``i``
is accepted iff ``lrand[i] < ref - logqp[i]``, ``ref`` being ``logqp`` of
the last accepted proposal (``logqp_ref`` at the start).  In JAX it is a
``lax.scan`` on the device; PyTorch has no scan, so on the card it is a
hand-written CUDA kernel (``csrc/accept_scan.cu``): one block that takes
the dependence out of the chain, 1024 proposals at a time.  Each state
(the incoming reference, or proposal ``j`` accepted) finds the proposal it
would accept next, all at once, by the sequential chain's own float32
comparison; pointer doubling over those links marks the states the chain
passes through, and a max-scan of the marks gives the indices.  The
reference is read from the device, so a CUDA graph holds the launch while
the reference changes between replays.

:func:`accept_scan` runs :func:`accept_scan_plain` for CPU tensors and the
kernel for CUDA tensors (float32), and raises for anything else.
``accept_scan.launches`` counts the kernel's launches from the host: once
per capture under a CUDA graph, not once per replay.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["accept_scan", "accept_scan_plain"]


def accept_scan_plain(lrand, logqp, logqp_ref):
    """Plain PyTorch version: a loop over the proposals as 0-d tensors in
    the dtype of ``logqp``, with no read from the host.  Returns
    ``(accept_seq, indices)``, bool and int64: ``indices[i]`` is 0 for
    "the incoming reference" or ``j + 1`` for proposal ``j``."""
    ref = torch.as_tensor(logqp_ref, dtype=logqp.dtype, device=logqp.device)
    if not logqp.shape[0]:
        return (torch.zeros(0, dtype=torch.bool, device=logqp.device),
                torch.zeros(0, dtype=torch.int64, device=logqp.device))
    index = torch.zeros((), dtype=torch.int64, device=logqp.device)
    accept, indices = [], []
    for i, (lr, lq) in enumerate(zip(lrand.unbind(), logqp.unbind())):
        a = lr < ref - lq
        ref = torch.where(a, lq, ref)
        index = torch.where(a, i + 1, index)
        accept.append(a)
        indices.append(index)
    return torch.stack(accept), torch.stack(indices)


def accept_scan(lrand, logqp, logqp_ref):
    """``(accept_seq, indices)`` of the chain ``logqp`` ``(n,)`` with log
    uniforms ``lrand`` ``(n,)`` against the incoming ``logqp_ref`` (a 0-d
    tensor on the same device, or a number).  CPU tensors take
    :func:`accept_scan_plain`; CUDA tensors (float32, contiguous) launch
    the kernel or raise."""
    if logqp.dim() != 1 or lrand.shape != logqp.shape:
        raise ValueError(f"accept_scan: lrand {tuple(lrand.shape)} and logqp "
                         f"{tuple(logqp.shape)} must be one (n,) shape")
    ref = torch.as_tensor(logqp_ref, dtype=logqp.dtype, device=logqp.device)
    devices = {t.device for t in (lrand, logqp, ref)}
    if all(d.type == "cpu" for d in devices):
        return accept_scan_plain(lrand, logqp, ref)
    if len(devices) != 1 or logqp.device.type != "cuda":
        raise ValueError("accept_scan: no kernel for tensors on "
                         f"{sorted(map(str, devices))}")
    if lrand.dtype != torch.float32 or logqp.dtype != torch.float32:
        raise TypeError("accept_scan: the CUDA kernel takes float32")
    if ref.numel() != 1 or not (lrand.is_contiguous()
                                and logqp.is_contiguous()):
        raise ValueError("accept_scan: contiguous lrand and logqp and one "
                         "reference value")
    n = logqp.shape[0]
    accept = torch.empty(n, dtype=torch.bool, device=logqp.device)
    indices = torch.empty(n, dtype=torch.int64, device=logqp.device)
    if not n:
        return accept, indices
    lib = _lib.library()
    with torch.cuda.device(logqp.device):
        stream = torch.cuda.current_stream(logqp.device).cuda_stream
        err = lib.accept_scan_f32(lrand.data_ptr(), logqp.data_ptr(),
                                  ref.data_ptr(), accept.data_ptr(),
                                  indices.data_ptr(), n, stream)
    _lib.check(err, "accept_scan")
    accept_scan.launches += 1
    return accept, indices


accept_scan.launches = 0
