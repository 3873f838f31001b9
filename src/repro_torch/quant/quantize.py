"""Weight quantization for the SEP shadow model: FP16 / INT8 / NF4.

The shadow model is the full model quantized to a cheaper precision.
Real quantize->dequantize keeps the shadow's numerics (and so its
routing divergence, the quantity the paper studies) faithful:

  * fp16 — plain dtype cast.
  * int8 — symmetric per-output-channel (last axis) scaling.
  * nf4  — 4-bit NormalFloat with per-block (64) absmax scaling, the
           QLoRA code-book; two codes per byte, high nibble first.

Codes, scales and rounding follow ``repro.quant.quantize`` exactly
(round half to even, first index on ``argmin`` ties); tests hold them
byte-equal.  Arithmetic runs in the leaf's own dtype, as there.
"""
from __future__ import annotations

from typing import Tuple

import torch

NF4_LEVELS = torch.tensor([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=torch.float32)

NF4_BLOCK = 64

_NF4_CHUNK = 1 << 18       # blocks per argmin pass: bounds the (n, 64, 16) temporary


# ----------------------------------------------------------------- int8
def quantize_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel (last axis) int8.  Returns (q, scale).  The
    absmax runs over every axis but the last of ``w`` as given, so a
    stacked (R, E, d, f) leaf shares one scale per f across R and E."""
    dims = tuple(range(w.dim() - 1))
    absmax = w.abs().amax(dim=dims, keepdim=True) if dims else w.abs()
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q, scale):
    return q.float() * scale


# ------------------------------------------------------------------ nf4
def quantize_nf4(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise (64) absmax NF4.  Returns (codes uint8 (n_blocks, 64),
    scales (n_blocks, 1))."""
    flat = w.reshape(-1)
    pad = (-flat.shape[0]) % NF4_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, NF4_BLOCK).float()
    absmax = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True), 1e-8)
    levels = NF4_LEVELS.to(w.device)
    codes = torch.empty(blocks.shape, dtype=torch.uint8, device=w.device)
    for s in range(0, blocks.shape[0], _NF4_CHUNK):
        normed = blocks[s:s + _NF4_CHUNK] / absmax[s:s + _NF4_CHUNK]
        codes[s:s + _NF4_CHUNK] = torch.argmin(
            (normed[..., None] - levels).abs(), dim=-1).to(torch.uint8)
    return codes, absmax


def dequantize_nf4(codes, scales, shape):
    vals = NF4_LEVELS.to(codes.device)[codes.long()] * scales
    n = 1
    for s in shape:
        n *= s
    return vals.reshape(-1)[:n].reshape(shape)


def pack_nf4_codes(codes):
    """Two codes per byte, high nibble first (the flat length is a
    multiple of 64, so the packing is exact)."""
    flat = codes.reshape(-1).to(torch.uint8)
    return (flat[0::2] << 4) | (flat[1::2] & 0xF)


def unpack_nf4_codes(packed, n_blocks: int):
    """Inverse of :func:`pack_nf4_codes` -> (n_blocks, 64) codes."""
    hi = (packed >> 4) & 0xF
    lo = packed & 0xF
    return torch.stack([hi, lo], dim=1).reshape(n_blocks, NF4_BLOCK)


# ----------------------------------------- tile-aligned device layout
def nf4_pair_unpack(codes):
    """Device-layout nf4 bytes along the last axis: ``(..., m)`` packed
    bytes -> ``(..., 2m)`` 4-bit codes, high nibble first (the bit order
    of :func:`unpack_nf4_codes`).  Leading batch dims pass through
    (``repro.quant.quantize.nf4_pair_unpack``)."""
    hi = (codes >> 4) & 0xF
    lo = codes & 0xF
    return torch.stack([hi, lo], dim=-1).reshape(
        tuple(codes.shape[:-1]) + (codes.shape[-1] * 2,))


def dequantize_tiles(scheme: str, parts):
    """Elementwise dequantization of tile-aligned device-layout parts
    (``repro_torch.quant.transport.device_layout``), with any leading
    batch dims (a stacked wave dequantizes in one call).  Per element it
    is the fp32 arithmetic of the wire-side ``dequantize`` — int8
    ``code * scale``, nf4 ``LUT[code] * block_absmax`` — on the same
    pairs, so the result equals dequantize-on-arrival bit for bit
    (``repro.quant.quantize.dequantize_tiles``)."""
    if scheme == "fp32":
        return parts[0]
    if scheme == "fp16":
        return parts[0].float()
    if scheme == "int8":
        return parts[0].float() * parts[1]
    if scheme == "nf4":
        codes = nf4_pair_unpack(parts[0]).long()
        scales = torch.repeat_interleave(parts[1], NF4_BLOCK, dim=-1)
        return NF4_LEVELS.to(codes.device)[codes] * scales
    raise ValueError(f"unknown scheme {scheme!r}")


# ------------------------------------------------------------- dispatch
def quantize(w, scheme: str):
    if scheme == "fp16":
        return (w.to(torch.float16),)
    if scheme == "int8":
        return quantize_int8(w)
    if scheme == "nf4":
        return quantize_nf4(w) + (tuple(w.shape),)
    raise ValueError(f"unknown scheme {scheme!r}")


def dequantize(packed, scheme: str):
    if scheme == "fp16":
        return packed[0].float()
    if scheme == "int8":
        return dequantize_int8(*packed)
    if scheme == "nf4":
        return dequantize_nf4(*packed)
    raise ValueError(f"unknown scheme {scheme!r}")


def simulate_quantization(w, scheme: str):
    """Quantize-dequantize round trip (a float tensor with quant error)."""
    if scheme in ("fp32", "none"):
        return w
    return dequantize(quantize(w, scheme), scheme).to(w.dtype)


_MIN_QUANT_SIZE = 256  # leave norms / small vectors in full precision


def _quantizes(w) -> bool:
    return w.dim() >= 2 and w.numel() >= _MIN_QUANT_SIZE and w.is_floating_point()


def quantize_pytree(params, scheme: str):
    """Quantize every large weight leaf; small leaves are kept as they are."""
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda w: simulate_quantization(w, scheme) if _quantizes(w) else w,
                    params)


def shadow_params(params, scheme: str):
    """The SEP shadow model's parameters: quantized view of the full set."""
    with torch.no_grad():
        return quantize_pytree(params, scheme)


def shadow_nbytes(params, scheme: str) -> int:
    """Deployed bytes of ``shadow_params(params, scheme)``: quantized
    leaves at the scheme's exact packed size (codes plus scales), the
    leaves kept at full width at their real size."""
    from repro_torch.models.transformer import tree_leaves
    from .transport import get_codec
    codec = get_codec("fp32" if scheme in ("fp32", "none") else scheme)
    total = 0
    for w in tree_leaves(params):
        if _quantizes(w):
            total += codec.packed_nbytes(tuple(w.shape), elem_bytes=w.element_size())
        else:
            total += w.numel() * w.element_size()
    return total
