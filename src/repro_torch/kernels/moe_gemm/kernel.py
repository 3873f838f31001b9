"""Hand-written CUDA grouped expert FFN (``csrc/moe_ffn.cu``), bound with ctypes.

Replaces ``repro/kernels/moe_gemm/kernel.py:61 moe_ffn_kernel``.  The
library is built by :mod:`repro_torch.kernels._nvcc` on first use; hosts
without ``nvcc`` import this module freely, and only a launch needs the
card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor

_WEIGHT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    lib.moe_ffn_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.moe_ffn_launch.restype = ctypes.c_int
    lib.moe_ffn_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.moe_ffn_workspace_floats.restype = ctypes.c_longlong


LIBRARY = CudaLibrary("moe_ffn", "moe_ffn.cu", headers=("moe_ffn_common.cuh",), bind=_bind)


def moe_ffn_kernel(xd, w_gate, w_up, w_down):
    """xd: (E, C, D) fp32 on a CUDA device -> (E, C, D) fp32.

    ``w_gate``/``w_up``: (E, D, F), ``w_down``: (E, F, D), all bf16 or
    all fp32, contiguous, on ``xd``'s device.  Anything else raises."""
    if xd.device.type != "cuda":
        raise ValueError("moe_ffn_kernel launches on a CUDA device only")
    if xd.dim() != 3:
        raise ValueError(f"xd must be (E, C, D), got shape {tuple(xd.shape)}")
    e, c, d = xd.shape
    f = w_gate.shape[-1] if w_gate.dim() == 3 else -1
    wdt = w_gate.dtype
    if wdt not in _WEIGHT_DTYPES:
        raise TypeError(f"weights must be bf16 or fp32, got {wdt}")
    check_tensor("xd", xd, (e, c, d), torch.float32, xd.device)
    check_tensor("w_gate", w_gate, (e, d, f), wdt, xd.device)
    check_tensor("w_up", w_up, (e, d, f), wdt, xd.device)
    check_tensor("w_down", w_down, (e, f, d), wdt, xd.device)
    if min(e, c, d, f) <= 0:
        raise ValueError("moe_ffn_kernel needs non-empty E, C, D and F")
    lib = LIBRARY.lib
    ws = torch.empty((lib.moe_ffn_workspace_floats(e, c, d, f),), dtype=torch.float32,
                     device=xd.device)
    y = torch.empty((e, c, d), dtype=torch.float32, device=xd.device)
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream(xd.device).cuda_stream
        err = lib.moe_ffn_launch(xd.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                                  w_down.data_ptr(), ws.data_ptr(), y.data_ptr(),
                                  e, c, d, f, _WEIGHT_DTYPES[wdt], stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn kernel launch failed: cudaError {err}")
    moe_ffn_kernel.launches += 1
    return y


moe_ffn_kernel.launches = 0    # launches of the CUDA kernel, reset by callers
