"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

from .accept_scan import accept_scan, accept_scan_plain
from .phi4 import phi4_action, phi4_action_plain
from .spline_coupling import rqs_coupling, rqs_coupling_plain

__all__ = ["accept_scan", "accept_scan_plain", "phi4_action",
           "phi4_action_plain", "rqs_coupling", "rqs_coupling_plain"]
