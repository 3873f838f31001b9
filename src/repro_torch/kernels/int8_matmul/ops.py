"""Public wrapper for the w8a16 matmul: the CUDA kernel for tensors on the
card, the plain PyTorch version for tensors on the host.  There is no
fallback between them: a CUDA tensor goes through the kernel or the call
raises.  As in the JAX package, no model, engine or shadow path calls it."""
from __future__ import annotations

from .kernel import int8_matmul_kernel
from .ref import int8_matmul_ref


def int8_matmul(x, w_q, scale):
    """x: (M,K) fp32 or bf16; w_q: (K,N) int8; scale: (N,) fp32 -> (M,N)
    fp32 (``repro.kernels.int8_matmul.ops.int8_matmul``; the TPU block
    sizes have no counterpart, the CUDA kernel tiles on its own)."""
    if x.device.type == "cuda":
        return int8_matmul_kernel(x, w_q, scale)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, scale)
    raise ValueError(f"no int8 matmul for device {x.device}")
