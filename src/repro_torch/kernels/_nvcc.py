"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source under ``repro_torch/csrc`` with a plain
C interface, compiled by ``nvcc`` for ``sm_90a`` into a shared library in
``build/`` at the repository root and loaded with ctypes.  The file name
carries a hash of the source, the headers it includes and the flags, so a
changed source is rebuilt.  Nothing is compiled or loaded at import time:
hosts without ``nvcc`` import the kernel modules freely, and only a launch
needs the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's kernels are compiled on the "
                       "machine with the card")


class CudaLibrary:
    """One kernel library: ``source`` (a file in ``csrc``) and the
    ``headers`` it includes.  ``bind(lib)`` sets the ctypes signatures
    after loading."""

    def __init__(self, name: str, source: str, headers=(), bind=None):
        self.name = name
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self._bind = bind
        self._lock = threading.Lock()
        self._loaded = None          # (ctypes library, build info)

    @property
    def lib(self):
        self.build()
        return self._loaded[0]

    def build(self) -> dict:
        """Compile (if needed) and load, once per process.  Returns the
        library path, the seconds the compile took (0.0 when the library
        was already there) and the compiler's resource report
        (``-Xptxas -v``)."""
        with self._lock:
            if self._loaded is not None:
                return self._loaded[1]
            digest = hashlib.sha256()
            for path in (self.source, *self.headers):
                digest.update(path.read_bytes())
            digest.update(" ".join(NVCC_FLAGS).encode())
            so = BUILD_DIR / f"{self.name}_{digest.hexdigest()[:16]}.so"
            seconds, report = 0.0, ""
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                t0 = time.perf_counter()
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                      capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source.name} "
                                       f"({proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, so)
                report = proc.stderr
            lib = ctypes.CDLL(str(so))
            if self._bind is not None:
                self._bind(lib)
            self._loaded = (lib, {"path": str(so), "seconds": seconds, "report": report})
            return self._loaded[1]


def check_tensor(name: str, t, shape, dtype, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``kernel``: the
    port's hand-written kernels have no backward (nor has any Pallas
    kernel of the reference), and a launch's outputs would carry no
    ``grad_fn``, so a training step would lose its gradient silently."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward on the card (ROADMAP.md queue 2: kernel "
            f"backwards); differentiate the plain PyTorch paths, e.g. loss_fn with "
            f"moe_method='scatter' as the reference's training step does, or run "
            f"under torch.no_grad()")
