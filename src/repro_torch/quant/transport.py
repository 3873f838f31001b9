"""Mixed-precision on-demand expert transport: wire format + policy.

  * ``TransportCodec`` — fp32 / fp16 / int8 / nf4 pack->unpack of one
    expert weight matrix.  The packed parts are what moves over the
    link; workers dequantize on arrival.  ``packed_nbytes`` is the exact
    payload in closed form.
  * ``UniformPolicy`` — which scheme each (layer, expert) ships at; one
    scheme fleet-wide.  ``TieredPolicy`` waits (ROADMAP.md queue 1).
  * ``transport_params`` — the reference side: the same round trip
    applied to a parameter tree, so ``greedy_generate(...,
    transport=policy)`` consumes exactly the weights a worker
    reconstructs, and engine decode stays token-identical to it under
    the same policy.

"fp32" means "ship the deployment dtype untouched" (bf16 weights ship
as bf16): packing it aliases the tensor, unpacking returns the same
values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import MOE_FF, ModelConfig

from .quantize import (NF4_BLOCK, dequantize_int8, dequantize_nf4, pack_nf4_codes,
                       quantize_int8, quantize_nf4, unpack_nf4_codes)

SCHEMES = ("fp32", "fp16", "int8", "nf4")

EXPERT_WEIGHT_NAMES = ("w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class PackedWeight:
    """One expert weight matrix in wire format: the tensors that cross
    the link, plus what is needed to reconstruct the original."""
    scheme: str
    shape: Tuple[int, ...]
    dtype: torch.dtype               # dtype the unpacked weight restores to
    parts: Tuple[torch.Tensor, ...]

    @property
    def nbytes(self) -> int:
        """Exact transport payload of this weight."""
        return int(sum(p.numel() * p.element_size() for p in self.parts))


class TransportCodec:
    """Pack/unpack one weight matrix at a transport precision."""

    def __init__(self, scheme: str):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown transport scheme {scheme!r}; "
                             f"expected one of {SCHEMES}")
        self.scheme = scheme

    def pack(self, w: torch.Tensor) -> PackedWeight:
        shape = tuple(int(s) for s in w.shape)
        if self.scheme == "fp32":
            parts = (w,)
        elif self.scheme == "fp16":
            parts = (w.to(torch.float16),)
        elif self.scheme == "int8":
            parts = quantize_int8(w)
        else:                                                   # nf4
            codes, scales = quantize_nf4(w)
            parts = (pack_nf4_codes(codes), scales)
        return PackedWeight(self.scheme, shape, w.dtype, tuple(parts))

    def unpack(self, pw: PackedWeight, parts: Optional[tuple] = None):
        """Reconstruct the weight (dequantize on arrival).  ``parts`` may
        override ``pw.parts`` with device copies of them."""
        parts = pw.parts if parts is None else parts
        if pw.scheme == "fp32":
            return parts[0]
        if pw.scheme == "fp16":
            w = parts[0].float()
        elif pw.scheme == "int8":
            w = dequantize_int8(parts[0], parts[1])
        else:                                                   # nf4
            n = 1
            for s in pw.shape:
                n *= s
            codes = unpack_nf4_codes(parts[0], -(-n // NF4_BLOCK))
            w = dequantize_nf4(codes, parts[1], pw.shape)
        return w.to(pw.dtype)

    def round_trip(self, w):
        """quantize->dequantize: the values a worker holds after a load."""
        return self.unpack(self.pack(w))

    def packed_nbytes(self, shape: Tuple[int, ...], elem_bytes: int = 4) -> int:
        """Closed-form transport payload for a weight of ``shape`` whose
        deployment dtype is ``elem_bytes`` wide (equals ``pack().nbytes``)."""
        size = 1
        for s in shape:
            size *= int(s)
        if self.scheme == "fp32":
            return size * elem_bytes
        if self.scheme == "fp16":
            return size * 2
        if self.scheme == "int8":
            # int8 codes + one f32 scale per output channel (last axis)
            return size + 4 * (int(shape[-1]) if shape else 1)
        # nf4: two codes per byte over the 64-padded length + one f32 absmax per block
        padded = -(-size // NF4_BLOCK) * NF4_BLOCK
        return padded // 2 + 4 * (padded // NF4_BLOCK)


_CODECS: Dict[str, TransportCodec] = {s: TransportCodec(s) for s in SCHEMES}


def get_codec(scheme: str) -> TransportCodec:
    if scheme not in _CODECS:
        raise ValueError(f"unknown transport scheme {scheme!r}")
    return _CODECS[scheme]


class PrecisionPolicy:
    """Maps (layer, expert) -> transport scheme.  Must be a pure function
    of its arguments: the engine, the store and the reference decoder
    consult the same policy and must see the same answer."""

    def scheme_for(self, layer: int, expert: int) -> str:
        raise NotImplementedError

    @property
    def trivial(self) -> bool:
        """True when every expert ships untouched."""
        return False

    def codec_for(self, layer: int, expert: int) -> TransportCodec:
        return get_codec(self.scheme_for(layer, expert))

    def describe(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class UniformPolicy(PrecisionPolicy):
    """Every expert ships at one scheme (the paper's implicit fp32)."""
    scheme: str = "fp32"

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown transport scheme {self.scheme!r}")

    def scheme_for(self, layer: int, expert: int) -> str:
        return self.scheme

    @property
    def trivial(self) -> bool:
        return self.scheme == "fp32"

    def describe(self) -> str:
        return f"uniform/{self.scheme}"


def resolve_policy(spec) -> PrecisionPolicy:
    """None -> fp32 identity; a scheme name -> ``UniformPolicy``; a
    policy -> itself."""
    if spec is None:
        return UniformPolicy("fp32")
    if isinstance(spec, PrecisionPolicy):
        return spec
    if isinstance(spec, str):
        return UniformPolicy(spec)
    raise TypeError(f"cannot resolve transport policy from {spec!r}")


@torch.no_grad()
def transport_params(cfg: ModelConfig, params, policy, packed=None) -> dict:
    """The reference decoder's view of a transport policy: every routed
    expert weight replaced by its codec round trip.  Routers, attention,
    norms and embeddings never cross the expert link and are untouched.

    ``packed`` (optional, ``(layer, expert) -> {name: PackedWeight}``,
    e.g. ``ExpertStore.get_packed``) reuses already-packed shards."""
    policy = resolve_policy(policy)
    if policy.trivial:
        return params
    pattern, reps = cfg.pattern()
    new_layers = []
    for pos, kinds in enumerate(pattern):
        sub = params["layers"][pos]
        if kinds[1] != MOE_FF:
            new_layers.append(sub)
            continue
        ff = dict(sub["ff"])
        for name in EXPERT_WEIGHT_NAMES:
            w = ff[name]                               # (reps, ep, d, f)
            out = w.clone()
            for r in range(reps):
                li = r * len(pattern) + pos
                for e in range(cfg.num_experts):       # pad rows stay as they are
                    if packed is not None:
                        pw = packed(li, e)[name]
                        out[r, e] = get_codec(pw.scheme).unpack(
                            pw, tuple(p.to(w.device) for p in pw.parts))
                    else:
                        out[r, e] = policy.codec_for(li, e).round_trip(w[r, e])
            ff[name] = out
        new_layers.append(dict(sub, ff=ff))
    return dict(params, layers=tuple(new_layers))
