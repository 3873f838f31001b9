"""Hand-written CUDA SSD inter-chunk scan (``csrc/ssd_scan.cu``), bound
with ctypes.

Replaces ``repro/kernels/ssd_scan/kernel.py:44 ssd_scan_kernel``.  The
library is built by :mod:`repro_torch.kernels._nvcc` on first use; hosts
without ``nvcc`` import this module freely, and only a launch needs the
card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor, refuse_grad

_GRID_YZ_MAX = 65535            # H and B ride on the grid's y and z axes


def _bind(lib) -> None:
    lib.ssd_scan_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("ssd_scan", "ssd_scan.cu", bind=_bind)


def ssd_scan_kernel(s, decay, h0=None):
    """s: (B,NC,H,P,N) fp32; decay: (B,NC,H) fp32; h0: (B,H,P,N) fp32 or
    None; contiguous, on one CUDA device -> ``(h_in (B,NC,H,P,N), h_last
    (B,H,P,N))`` fp32, bitwise equal to ``ssd_scan_ref``.  The kernel
    moves float4s, so P*N must be a multiple of 4 and every pointer 16-byte
    aligned.  Anything else raises."""
    if s.device.type != "cuda":
        raise ValueError("ssd_scan_kernel launches on a CUDA device only")
    refuse_grad("ssd_scan_kernel", s, decay, h0)
    if s.dim() != 5:
        raise ValueError(f"s must be (B,NC,H,P,N), got shape {tuple(s.shape)}")
    b, nc, h, p, n = s.shape
    check_tensor("s", s, (b, nc, h, p, n), torch.float32, s.device)
    check_tensor("decay", decay, (b, nc, h), torch.float32, s.device)
    if h0 is not None:
        check_tensor("h0", h0, (b, h, p, n), torch.float32, s.device)
    if min(b, nc, h, p, n) <= 0:
        raise ValueError("ssd_scan_kernel needs non-empty B, NC, H, P and N")
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"B={b} and H={h} must each be at most {_GRID_YZ_MAX}")
    if (p * n) % 4:
        raise ValueError(f"P*N={p * n} must be a multiple of 4 (the kernel moves float4s)")
    if any(t.data_ptr() % 16 for t in (s,) + (() if h0 is None else (h0,))):
        raise ValueError("s and h0 must be 16-byte aligned (the kernel moves float4s)")
    h_in = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=s.device)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=s.device)
    lib = LIBRARY.lib
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.ssd_scan_launch(s.data_ptr(), decay.data_ptr(),
                                  None if h0 is None else h0.data_ptr(), h_in.data_ptr(),
                                  h_last.data_ptr(), b, nc, h, p * n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan_kernel.launches += 1
    return h_in, h_last


ssd_scan_kernel.launches = 0    # launches of the CUDA kernel, reset by callers
