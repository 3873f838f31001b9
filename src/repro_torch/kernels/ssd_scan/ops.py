"""Public wrapper for the SSD inter-chunk scan: the CUDA kernel for tensors
on the card, the plain PyTorch version for tensors on the host.  There is
no fallback between them: a CUDA tensor goes through the kernel or the
call raises.

The scan is a ``torch.autograd.Function`` on both devices, and its
backward is the same scan run over the chunks in reverse: with ``a_c`` the
chunk decay and ``G`` the incoming gradients of ``h_in`` and ``h_last``,
the adjoint state ``lam_c = a_c * lam_{c+1} + G_c`` starts from
``lam_NC = G_last``; then ``ds_c = lam_{c+1}``, ``d(a_c) = sum_{P,N}
lam_{c+1} * h_in[:, c]`` and ``dh0 = lam_0``.  That is one more call of the
dispatch below on the flipped gradients and decays, seeded with
``G_last``, so the host tests check the very backward the card runs."""
from __future__ import annotations

import torch

from .kernel import ssd_scan_kernel
from .ref import ssd_scan_ref


def _scan(s, decay, h0):
    if s.device.type == "cuda":
        return ssd_scan_kernel(s, decay, h0)
    if s.device.type == "cpu":
        return ssd_scan_ref(s, decay, h0)
    raise ValueError(f"no ssd scan for device {s.device}")


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, decay, h0):
        h_in, h_last = _scan(s, decay, h0)
        ctx.save_for_backward(decay, h_in)
        ctx.has_h0 = h0 is not None
        return h_in, h_last

    @staticmethod
    def backward(ctx, g_in, g_last):
        decay, h_in = ctx.saved_tensors
        # an output without a gradient contributes zeros
        g_in = torch.zeros_like(h_in) if g_in is None else g_in
        g_last = torch.zeros_like(h_in[:, 0]) if g_last is None else g_last
        lam, lam0 = _scan(torch.flip(g_in, dims=(1,)).contiguous(),
                          torch.flip(decay, dims=(1,)).contiguous(), g_last.contiguous())
        ds = torch.flip(lam, dims=(1,))                   # ds[:, c] = lam_{c+1}
        d_decay = (ds * h_in).sum(dim=(-2, -1))
        return ds, d_decay, (lam0 if ctx.has_h0 else None)


def ssd_scan(s, decay, h0=None):
    """s: (B,NC,H,P,N) fp32; decay: (B,NC,H) fp32; h0: (B,H,P,N) fp32 or
    None (a zero start) -> ``(h_in, h_last)``
    (``repro.kernels.ssd_scan.ops.ssd_scan``, plus the ``initial_state``
    that ``repro.models.mamba.mamba_seq`` feeds its scan), differentiable
    in ``s``, ``decay`` and ``h0``."""
    return _SSDScan.apply(s, decay, h0)
