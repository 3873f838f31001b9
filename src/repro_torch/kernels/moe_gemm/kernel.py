"""Hand-written CUDA grouped expert FFN (``csrc/moe_ffn.cu``), bound with ctypes.

Replaces ``repro/kernels/moe_gemm/kernel.py:61 moe_ffn_kernel``.  bf16
weights run on tensor cores (``csrc/moe_ffn_mma.cuh``), fp32 weights on the
staged CUDA-core passes the packed kernel shares (``csrc/moe_ffn_common.cuh``).
The library is built by :mod:`repro_torch.kernels._nvcc` on first use;
hosts without ``nvcc`` import this module freely, and only a launch needs
the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor, refuse_grad

_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib) -> None:
    lib.moe_ffn_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.moe_ffn_launch.restype = ctypes.c_int
    lib.moe_ffn_bf16_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.moe_ffn_bf16_launch.restype = ctypes.c_int
    for name in ("moe_ffn_workspace_floats", "moe_ffn_counters",
                 "moe_ffn_bf16_workspace_bytes", "moe_ffn_bf16_counters"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 4
        getattr(lib, name).restype = ctypes.c_longlong


LIBRARY = CudaLibrary("moe_ffn", "moe_ffn.cu", headers=("moe_ffn_common.cuh", "moe_ffn_mma.cuh"),
                      bind=_bind)

# (device index, stream) -> tile counters, grown on demand: the bf16 path's,
# the fp32 path's and the packed kernel's (``packed.py``).  Every launch
# leaves them at zero and launches on one stream run one after another, so
# they share one array; another stream gets its own.
_COUNTERS: dict = {}


def _counters(device, stream: int, n: int):
    key = (device.index, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < n:
        counters = torch.zeros((max(n, 1),), dtype=torch.int32, device=device)
        _COUNTERS[key] = counters
    return counters


# (C function, device index, arguments) -> its answer: the workspace and
# counter sizes of a call depend only on its sizes and the card.
_SIZES: dict = {}


def _size(fn, device, *args) -> int:
    key = (fn.__name__, device.index, args)
    n = _SIZES.get(key)
    if n is None:
        n = _SIZES[key] = int(fn(*args))
    return n


def workspace_bytes(e: int, c: int, d: int, f: int, dtype) -> int:
    """Bytes of workspace one call at these sizes allocates on the current
    device (x's and hu's split terms and, at small C, segment partials
    for bf16 weights; hu and, at small C, segment partials for fp32
    weights)."""
    lib = LIBRARY.lib
    if dtype == torch.bfloat16:
        return int(lib.moe_ffn_bf16_workspace_bytes(e, c, d, f))
    return 4 * int(lib.moe_ffn_workspace_floats(e, c, d, f))


def moe_ffn_kernel(xd, w_gate, w_up, w_down):
    """xd: (E, C, D) fp32 on a CUDA device -> (E, C, D) fp32.

    ``w_gate``/``w_up``: (E, D, F), ``w_down``: (E, F, D), all bf16 or
    all fp32, contiguous, on ``xd``'s device.  Anything else raises."""
    if xd.device.type != "cuda":
        raise ValueError("moe_ffn_kernel launches on a CUDA device only")
    refuse_grad("moe_ffn_kernel", xd, w_gate, w_up, w_down)
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
    y = torch.empty((e, c, d), dtype=torch.float32, device=xd.device)
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream(xd.device).cuda_stream
        ptrs = (xd.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr())
        if wdt == torch.bfloat16:
            ws = torch.empty((lib.moe_ffn_bf16_workspace_bytes(e, c, d, f),),
                             dtype=torch.uint8, device=xd.device)
            counters = _counters(xd.device, stream, lib.moe_ffn_bf16_counters(e, c, d, f))
            err = lib.moe_ffn_bf16_launch(*ptrs, ws.data_ptr(), counters.data_ptr(),
                                          y.data_ptr(), e, c, d, f, stream)
        else:
            ws = torch.empty((_size(lib.moe_ffn_workspace_floats, xd.device, e, c, d, f),),
                             dtype=torch.float32, device=xd.device)
            counters = _counters(xd.device, stream,
                                 _size(lib.moe_ffn_counters, xd.device, e, c, d, f))
            err = lib.moe_ffn_launch(*ptrs, ws.data_ptr(), counters.data_ptr(), y.data_ptr(),
                                     e, c, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn kernel launch failed: cudaError {err}")
    moe_ffn_kernel.launches += 1
    return y


moe_ffn_kernel.launches = 0    # launches of the CUDA kernel, reset by callers
