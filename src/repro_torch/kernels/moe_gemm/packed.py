"""Grouped expert FFN on wire-format weights (``csrc/moe_ffn_packed.cu``),
bound with ctypes, beside its plain PyTorch version.

Replaces ``repro/kernels/moe_gemm/packed.py:147 moe_ffn_packed_kernel``.
The weights arrive as the tile-aligned device layout of
``repro_torch.quant.transport.device_layout``, stacked on a leading
expert axis (what ``WorkerSlots.gather_stack_packed`` produces):

  * fp16 — ``(halves,)``;
  * int8 — ``(codes, scales)``: codes keep the weight's shape, scales are
    one ``(1, last)`` row;
  * nf4  — ``(codes, absmax)``: codes ``(rows, cols/2)``, two per byte,
    high nibble first; absmax ``(rows, cols/64)``.

The kernel dequantizes each word of codes as it reads it from shared
memory.  Dequantization is elementwise and exact and the passes are kernel
1's fp32 ones, so the output equals, bit for bit, ``moe_ffn_kernel`` on
``dequantize_tiles`` of the same parts.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._nvcc import CudaLibrary, check_tensor, refuse_grad

from .kernel import _counters, _size
from .ref import moe_ffn_ref

_SCHEME_IDS = {"fp16": 0, "int8": 1, "nf4": 2}
_NF4_BLOCK = 64            # == repro_torch.quant.quantize.NF4_BLOCK
_LEVELS: Dict[torch.device, torch.Tensor] = {}     # NF4_LEVELS per device


def _bind(lib) -> None:
    lib.moe_ffn_packed_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                                          + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.moe_ffn_packed_launch.restype = ctypes.c_int
    for name in ("moe_ffn_packed_workspace_floats", "moe_ffn_packed_counters"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 5
        getattr(lib, name).restype = ctypes.c_longlong


LIBRARY = CudaLibrary("moe_ffn_packed", "moe_ffn_packed.cu",
                      headers=("moe_ffn_common.cuh",), bind=_bind)


def packed_logical_f(scheme: str, parts) -> int:
    """The logical expert width f of stacked packed parts."""
    last = parts["w_gate"][0].shape[-1]
    return last * 2 if scheme == "nf4" else last


def moe_ffn_packed_ref(xd, parts, *, scheme: str):
    """Plain version: dequantize the stacks elementwise, then the plain
    grouped FFN (``repro.kernels.moe_gemm.ops.moe_ffn_packed`` off the
    TPU)."""
    from repro_torch.quant.quantize import dequantize_tiles
    return moe_ffn_ref(xd, *(dequantize_tiles(scheme, parts[n])
                             for n in ("w_gate", "w_up", "w_down")))


def _part_specs(scheme: str, e: int, d: int, f: int):
    """Expected (shape, dtype) of each part of w_gate, w_up, w_down."""
    if scheme == "fp16":
        up = [((e, d, f), torch.float16)]
        down = [((e, f, d), torch.float16)]
    elif scheme == "int8":
        up = [((e, d, f), torch.int8), ((e, 1, f), torch.float32)]
        down = [((e, f, d), torch.int8), ((e, 1, d), torch.float32)]
    else:
        up = [((e, d, f // 2), torch.uint8), ((e, d, f // _NF4_BLOCK), torch.float32)]
        down = [((e, f, d // 2), torch.uint8), ((e, f, d // _NF4_BLOCK), torch.float32)]
    return {"w_gate": up, "w_up": up, "w_down": down}


def _levels(device: torch.device) -> torch.Tensor:
    if device not in _LEVELS:
        from repro_torch.quant.quantize import NF4_LEVELS
        _LEVELS[device] = NF4_LEVELS.to(device)
    return _LEVELS[device]


def moe_ffn_packed_kernel(xd, parts, *, scheme: str):
    """xd: (E, C, D) fp32 on a CUDA device -> (E, C, D) fp32, with the
    weights in wire format (module docstring).  Raises on a host tensor,
    an unknown scheme, a wrong dtype, shape or layout, nf4 widths not
    aligned to 64, or a failed launch."""
    if scheme not in _SCHEME_IDS:
        raise ValueError(f"no packed kernel for scheme {scheme!r}")
    if xd.dim() != 3:
        raise ValueError(f"xd must be (E, C, D), got shape {tuple(xd.shape)}")
    e, c, d = xd.shape
    f = packed_logical_f(scheme, parts)
    if scheme == "nf4" and (f % _NF4_BLOCK or d % _NF4_BLOCK):
        raise ValueError("nf4 packed kernel needs f and d aligned to the 64-element "
                         f"absmax block; got f={f}, d={d}")
    if xd.device.type != "cuda":
        raise ValueError("moe_ffn_packed_kernel launches on a CUDA device only")
    refuse_grad("moe_ffn_packed_kernel", xd, *(t for ps in parts.values() for t in ps))
    if min(e, c, d, f) <= 0:
        raise ValueError("moe_ffn_packed_kernel needs non-empty E, C, D and F")
    check_tensor("xd", xd, (e, c, d), torch.float32, xd.device)
    ptrs = []
    for name, specs in _part_specs(scheme, e, d, f).items():
        if len(parts[name]) != len(specs):
            raise ValueError(f"{name} has {len(parts[name])} parts, {scheme} takes "
                             f"{len(specs)}")
        for j, (t, (shape, dtype)) in enumerate(zip(parts[name], specs)):
            check_tensor(f"{name}[{j}]", t, shape, dtype, xd.device)
        ptrs += [parts[name][0].data_ptr(),
                 parts[name][1].data_ptr() if len(specs) > 1 else None]
    levels = _levels(xd.device).data_ptr() if scheme == "nf4" else None
    lib = LIBRARY.lib
    sid = _SCHEME_IDS[scheme]
    ws = torch.empty((_size(lib.moe_ffn_packed_workspace_floats, xd.device, sid, e, c, d, f),),
                     dtype=torch.float32, device=xd.device)
    y = torch.empty((e, c, d), dtype=torch.float32, device=xd.device)
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream(xd.device).cuda_stream
        counters = _counters(xd.device, stream,
                             _size(lib.moe_ffn_packed_counters, xd.device, sid, e, c, d, f))
        err = lib.moe_ffn_packed_launch(sid, xd.data_ptr(), *ptrs, levels, ws.data_ptr(),
                                        counters.data_ptr(), y.data_ptr(), e, c, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn_packed kernel launch failed: cudaError {err}")
    moe_ffn_packed_kernel.launches += 1
    return y


moe_ffn_packed_kernel.launches = 0    # launches of the CUDA kernel, reset by callers
