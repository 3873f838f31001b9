"""Hand-written CUDA grouped expert FFN (``csrc/moe_ffn.cu``), bound with ctypes.

Replaces ``repro/kernels/moe_gemm/kernel.py:61 moe_ffn_kernel``.  The
shared library is compiled with ``nvcc`` for ``sm_90a`` into ``build/``
at the repository root on first use and rebuilt whenever the source or
the flags change (the file name carries their hash).  Nothing is built
or loaded at import time, so hosts without ``nvcc`` import this module
freely; only a launch needs the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "moe_ffn.cu"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_WEIGHT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_built = None        # (ctypes library, build info) once loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the moe_ffn kernel is compiled on "
                       "the machine with the card")


def build() -> dict:
    """Compile (if needed) and load the kernel library, once per process.
    Returns the library path, the seconds the compile took (0.0 when the
    library was already there) and the compiler's resource report
    (``-Xptxas -v``)."""
    global _built
    if _built is not None:
        return _built[1]
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"moe_ffn_{digest}.so"
    seconds, report = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        report = proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.moe_ffn_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.moe_ffn_launch.restype = ctypes.c_int
    lib.moe_ffn_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.moe_ffn_workspace_floats.restype = ctypes.c_longlong
    _built = (lib, {"path": str(so), "seconds": seconds, "report": report})
    return _built[1]


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check("xd", xd, (e, c, d), torch.float32, xd.device)
    _check("w_gate", w_gate, (e, d, f), wdt, xd.device)
    _check("w_up", w_up, (e, d, f), wdt, xd.device)
    _check("w_down", w_down, (e, f, d), wdt, xd.device)
    if min(e, c, d, f) <= 0:
        raise ValueError("moe_ffn_kernel needs non-empty E, C, D and F")
    build()
    lib = _built[0]
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
