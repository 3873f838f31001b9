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

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor

_GRID_YZ_MAX = 65535            # row tiles of 4 and K splits of 256 ride on y and z
_ROWS_PER_TILE, _SPLIT_K = 4, 256


def _bind(lib) -> None:
    lib.int8_matmul_splits.argtypes = [ctypes.c_int] * 3
    lib.int8_matmul_splits.restype = ctypes.c_int
    lib.int8_matmul_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.int8_matmul_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("int8_matmul", "int8_matmul.cu", bind=_bind)


def int8_matmul_kernel(x, w_q, scale):
    """x: (M,K) fp32 or bf16; w_q: (K,N) int8; scale: (N,) fp32; contiguous,
    on one CUDA device -> (M,N) fp32, ``(x @ w_q) * scale`` with fp32 sums
    and the scale applied after the whole sum.  Anything else raises."""
    if x.device.type != "cuda":
        raise ValueError("int8_matmul_kernel launches on a CUDA device only")
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
    if -(-m // _ROWS_PER_TILE) > _GRID_YZ_MAX or -(-k // _SPLIT_K) > _GRID_YZ_MAX:
        raise ValueError(f"M={m} and K={k} must be at most {_GRID_YZ_MAX * _ROWS_PER_TILE} "
                         f"and {_GRID_YZ_MAX * _SPLIT_K}")
    lib = LIBRARY.lib
    splits = lib.int8_matmul_splits(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matmul_launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                     w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                     None if ws is None else ws.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    int8_matmul_kernel.launches += 1
    return out


int8_matmul_kernel.launches = 0  # launches of the CUDA kernel, reset by callers
