"""Hand-written CUDA w8a16 matmul (``csrc/int8_matmul.cu``), bound with
ctypes.

Replaces ``repro/kernels/int8_matmul/kernel.py:56 int8_matmul_kernel``.
The library is built by :mod:`repro_torch.kernels._nvcc` on first use;
hosts without ``nvcc`` import this module freely, and only a launch needs
the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor, refuse_grad


def _bind(lib) -> None:
    lib.int8_matmul_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.int8_matmul_plan.restype = ctypes.c_int
    lib.int8_matmul_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.int8_matmul_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("int8_matmul", "int8_matmul.cu", headers=("moe_ffn_common.cuh",),
                      bind=_bind)

_PLAN_KEYS = ("segment_rows", "segments", "cluster_blocks", "block_segments", "tile_bytes",
              "row_tile", "blocks")


def plan(m: int, n: int, k: int) -> dict:
    """How a call of shape (M, K) x (K, N) is cut: K into ``segments`` of
    ``segment_rows`` (a function of K alone, which fixes every sum's order),
    clusters of ``cluster_blocks`` blocks of ``block_segments`` segments
    each, column tiles of ``tile_bytes`` codes, row tiles of ``row_tile``
    rows of x, ``blocks`` in all."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    LIBRARY.lib.int8_matmul_plan(m, n, k, out)
    return dict(zip(_PLAN_KEYS, out))


def int8_matmul_kernel(x, w_q, scale):
    """x: (M,K) fp32 or bf16; w_q: (K,N) int8; scale: (N,) fp32; contiguous,
    on one CUDA device -> (M,N) fp32, ``(x @ w_q) * scale`` with fp32 sums
    and the scale applied after the whole sum.  Anything else raises."""
    if x.device.type != "cuda":
        raise ValueError("int8_matmul_kernel launches on a CUDA device only")
    refuse_grad("int8_matmul_kernel", x, scale)
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"x must be (M,K) and w_q (K,N), got {tuple(x.shape)} and "
                         f"{tuple(w_q.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or bfloat16")
    m, k = x.shape
    n = w_q.shape[1]
    check_tensor("x", x, (m, k), x.dtype, x.device)
    check_tensor("w_q", w_q, (k, n), torch.int8, x.device)
    check_tensor("scale", scale, (n,), torch.float32, x.device)
    if min(m, k, n) <= 0:
        raise ValueError("int8_matmul_kernel needs non-empty M, K and N")
    lib = LIBRARY.lib
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matmul_launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                     w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
                                     stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul_kernel.launches += 1
    return out


int8_matmul_kernel.launches = 0  # launches of the CUDA kernel, reset by callers
