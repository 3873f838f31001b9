"""Public wrapper for the SSD inter-chunk scan: the CUDA kernel for tensors
on the card, the plain PyTorch version for tensors on the host.  There is
no fallback between them: a CUDA tensor goes through the kernel or the
call raises."""
from __future__ import annotations

from .kernel import ssd_scan_kernel
from .ref import ssd_scan_ref


def ssd_scan(s, decay, h0=None):
    """s: (B,NC,H,P,N) fp32; decay: (B,NC,H) fp32; h0: (B,H,P,N) fp32 or
    None (a zero start) -> ``(h_in, h_last)``
    (``repro.kernels.ssd_scan.ops.ssd_scan``, plus the ``initial_state``
    that ``repro.models.mamba.mamba_seq`` feeds its scan)."""
    if s.device.type == "cuda":
        return ssd_scan_kernel(s, decay, h0)
    if s.device.type == "cpu":
        return ssd_scan_ref(s, decay, h0)
    raise ValueError(f"no ssd scan for device {s.device}")
