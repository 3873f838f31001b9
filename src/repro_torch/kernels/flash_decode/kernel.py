"""Hand-written CUDA flash-decode attention (``csrc/flash_decode.cu``),
bound with ctypes.

Replaces ``repro/kernels/flash_decode/kernel.py:74 flash_decode_kernel``.
The library is built by :mod:`repro_torch.kernels._nvcc` on first use;
hosts without ``nvcc`` import this module freely, and only a launch needs
the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor, refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    lib.flash_decode_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.flash_decode_workspace_floats.restype = ctypes.c_longlong
    lib.flash_decode_counters.argtypes = [ctypes.c_int] * 3
    lib.flash_decode_counters.restype = ctypes.c_longlong
    for name in ("flash_decode_max_group", "flash_decode_max_head_dim", "flash_decode_chunk"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_decode", "flash_decode.cu", bind=_bind)

# (device index, stream) -> (workspace, counters), grown on demand and reused
# by every later launch on that stream.  The kernel leaves the counters at
# zero, and launches on one stream run one after another, so they share
# both; a launch on another stream gets its own pair.
_SCRATCH: dict = {}


def _scratch(device, stream: int, ws_floats: int, n_counters: int):
    key = (device.index, stream)
    ws, counters = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < ws_floats:
        ws = torch.empty((ws_floats,), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros((n_counters,), dtype=torch.int32, device=device)
    _SCRATCH[key] = (ws, counters)
    return ws, counters


def release_scratch() -> None:
    """Drop every cached workspace and counter array; the next launch on a
    stream allocates its pair anew at that launch's size."""
    _SCRATCH.clear()


def flash_decode_kernel(q, k, v, kpos, pos, *, window: int = 0):
    """q: (B,K,G,Hd); k/v: (B,W,K,Hd), all bf16 or all fp32; kpos: (B,W)
    int32; pos: (B,) int32; contiguous, on one CUDA device ->
    (B,K,G,Hd) fp32.

    A row's output does not depend on B, on W or on masked tail slots
    (see the source).  A row with no valid slot gives 0, where the plain
    version averages V (never on the decode path: the slot just written
    is always valid).  Anything else raises."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_kernel launches on a CUDA device only")
    refuse_grad("flash_decode_kernel", q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,K,G,Hd) and k (B,W,K,Hd), got shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, kh, g, hd = q.shape
    w = k.shape[1]
    dt = q.dtype
    if dt not in _DTYPES:
        raise TypeError(f"q, k and v must be bf16 or fp32, got {dt}")
    check_tensor("q", q, (b, kh, g, hd), dt, q.device)
    check_tensor("k", k, (b, w, kh, hd), dt, q.device)
    check_tensor("v", v, (b, w, kh, hd), dt, q.device)
    check_tensor("kpos", kpos, (b, w), torch.int32, q.device)
    check_tensor("pos", pos, (b,), torch.int32, q.device)
    if min(b, w, kh, g, hd) <= 0:
        raise ValueError("flash_decode_kernel needs non-empty B, W, K, G and Hd")
    if window < 0:
        raise ValueError("window must be >= 0")
    lib = LIBRARY.lib
    if g > lib.flash_decode_max_group() or hd > lib.flash_decode_max_head_dim():
        raise ValueError(f"G={g} heads per kv head and Hd={hd} exceed the kernel's "
                         f"{lib.flash_decode_max_group()} and "
                         f"{lib.flash_decode_max_head_dim()}")
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws, counters = _scratch(q.device, stream,
                                lib.flash_decode_workspace_floats(b, w, kh, g, hd),
                                lib.flash_decode_counters(b, w, kh))
        err = lib.flash_decode_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      kpos.data_ptr(), pos.data_ptr(), ws.data_ptr(),
                                      counters.data_ptr(), out.data_ptr(), b, w, kh, g, hd,
                                      int(window), _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    flash_decode_kernel.launches += 1
    return out


flash_decode_kernel.launches = 0    # launches of the CUDA kernel, reset by callers
