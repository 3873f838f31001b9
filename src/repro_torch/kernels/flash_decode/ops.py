"""Public wrapper for flash-decode attention: the CUDA kernel for tensors
on the card, the plain PyTorch version for tensors on the host.  There is
no fallback between them: a CUDA tensor goes through the kernel or the
call raises."""
from __future__ import annotations

from .kernel import flash_decode_kernel
from .ref import flash_decode_ref


def flash_decode(q, k, v, kpos, pos, *, window: int = 0, soft_cap: float = 0.0):
    """q: (B,K,G,Hd); k/v: (B,W,K,Hd); kpos: (B,W) int32; pos: (B,) int32
    -> (B,K,G,Hd) fp32 (``repro.kernels.flash_decode.ops.flash_decode``).
    ``soft_cap`` exists on the host only; the kernel refuses it."""
    if q.device.type == "cuda":
        if soft_cap:
            raise NotImplementedError("the flash-decode kernel has no logit soft cap "
                                      "(nor has the Pallas kernel it replaces)")
        return flash_decode_kernel(q, k, v, kpos, pos, window=window)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, kpos, pos, window=window, soft_cap=soft_cap)
    raise ValueError(f"no flash decode for device {q.device}")
