"""Plain PyTorch version of the w8a16 dequantizing matmul."""
import torch


def int8_matmul_ref(x, w_q, scale):
    """x: (M,K) float; w_q: (K,N) int8; scale: (N,) -> (M,N) fp32, the
    formula of ``repro.kernels.int8_matmul.ref``: ``x @ (w_q * scale)``."""
    return x.float() @ (w_q.float() * scale.float()[None, :])
