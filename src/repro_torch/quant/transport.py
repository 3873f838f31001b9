"""Mixed-precision on-demand expert transport: wire format + policy.

  * ``TransportCodec`` — fp32 / fp16 / int8 / nf4 pack->unpack of one
    expert weight matrix.  The packed parts are what moves over the
    link.  By default workers dequantize on arrival; packed-resident
    slots keep the parts, rearranged by :func:`device_layout`, and the
    CUDA kernel ``csrc/moe_ffn_packed.cu`` dequantizes in registers.
    ``packed_nbytes`` is the exact payload in closed form.
  * ``PrecisionPolicy`` — which scheme each (layer, expert) ships at:
    ``UniformPolicy`` one scheme fleet-wide, ``TieredPolicy`` the
    HOBBIT rule (low-confidence experts ship at the cheaper scheme).
  * ``transport_params`` — the reference side: the same round trip
    applied to a parameter tree, so ``greedy_generate(...,
    transport=policy)`` consumes exactly the weights a worker
    reconstructs, and engine decode stays token-identical to it under
    the same policy.
  * ``transport_expert_bytes`` — closed-form packed bytes of one expert,
    which the timing model prices loads by.

"fp32" means "ship the deployment dtype untouched" (bf16 weights ship
as bf16): packing it aliases the tensor, unpacking returns the same
values.  Counterpart: ``repro.quant.transport``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
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


def tileable(scheme: str, shape: Tuple[int, ...]) -> bool:
    """Whether a weight of ``shape`` has the tile-aligned device layout
    at ``scheme``, the precondition for a packed-resident slot: fp32 and
    fp16 always; int8 for 2-D weights (its scale row ``(1, last)``
    slices with the columns); nf4 for 2-D weights whose last axis is a
    multiple of ``NF4_BLOCK``, so each absmax block is one 64-column run
    of one row.  Other shapes keep dequantize-on-arrival, a fallback
    and never an error (``repro.quant.transport.tileable``)."""
    if scheme in ("fp32", "fp16"):
        return True
    if len(shape) != 2:
        return False
    if scheme == "int8":
        return True
    if scheme == "nf4":
        return shape[-1] % NF4_BLOCK == 0
    return False


def device_layout(pw: PackedWeight) -> Tuple[torch.Tensor, ...]:
    """The wire parts rearranged into the tile-aligned device layout the
    packed kernel reads; a lossless reshape of the same codes and scales
    (``repro.quant.transport.device_layout``):

      * fp32/fp16/int8 — as they are (int8 scales are one ``(1, last)``
        row);
      * nf4 — flat codes ``(n/2,)`` -> ``(d, f/2)`` (two f-adjacent codes
        per byte, high nibble first) and block absmax ``(n/64, 1)`` ->
        ``(d, f/64)``.
    """
    if not tileable(pw.scheme, pw.shape):
        raise ValueError(f"shape {pw.shape} has no tile-aligned device "
                         f"layout at {pw.scheme!r}")
    if pw.scheme != "nf4":
        return pw.parts
    d, f = pw.shape
    return (pw.parts[0].reshape(d, f // 2), pw.parts[1].reshape(d, f // NF4_BLOCK))


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
    def default_scheme(self) -> str:
        """Scheme assumed for a load whose expert is unknown (the timing
        model's group-padding loads)."""
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
    def default_scheme(self) -> str:
        return self.scheme

    @property
    def trivial(self) -> bool:
        return self.scheme == "fp32"

    def describe(self) -> str:
        return f"uniform/{self.scheme}"


class TieredPolicy(PrecisionPolicy):
    """HOBBIT-style confidence tiering: experts the router historically
    selects with low gate weight move little probability mass, so they
    ship at the cheaper scheme.  The tier map is fixed once, from a
    calibration trace or an explicit set, which keeps decode identical
    to the reference under the same policy
    (``repro.quant.transport.TieredPolicy``)."""

    def __init__(self, low_experts: Iterable[Tuple[int, int]],
                 high: str = "fp16", low: str = "int8"):
        if high not in SCHEMES or low not in SCHEMES:
            raise ValueError("unknown transport scheme in tiered policy")
        self.high, self.low = high, low
        self.low_experts = frozenset((int(l), int(e)) for l, e in low_experts)

    def scheme_for(self, layer: int, expert: int) -> str:
        return self.low if (layer, expert) in self.low_experts else self.high

    @property
    def default_scheme(self) -> str:
        return self.high

    @property
    def trivial(self) -> bool:
        return self.high == "fp32" and (not self.low_experts or self.low == "fp32")

    def describe(self) -> str:
        return f"tiered/{self.high}+{self.low}[{len(self.low_experts)} low]"

    @classmethod
    def from_trace(cls, trace, low_fraction: float = 0.5, high: str = "fp16",
                   low: str = "int8", num_experts: Optional[int] = None
                   ) -> "TieredPolicy":
        """Tier map from a calibration trace: per (layer, expert) the
        confidence is the mean gate weight when selected (the selection
        count when the trace has no gates); per layer the bottom
        ``low_fraction`` of the seen experts ship ``low``, and so does
        every expert the trace never routed to, up to ``num_experts``
        (inferred from the largest routed index when not given)."""
        if not 0.0 <= low_fraction <= 1.0:
            raise ValueError("low_fraction must be in [0, 1]")
        gate_sum: Dict[Tuple[int, int], float] = {}
        count: Dict[Tuple[int, int], int] = {}
        layers: Dict[int, set] = {}
        num_experts = int(num_experts or 0)
        for rec in trace.records:
            for lr in rec.layers:
                true = np.asarray(lr.true)
                gates = getattr(lr, "gates", None)
                gates = None if gates is None else np.asarray(gates)
                num_experts = max(num_experts, int(true.max()) + 1)
                seen = layers.setdefault(lr.layer, set())
                for bi in range(true.shape[0]):
                    for j in range(true.shape[1]):
                        key = (lr.layer, int(true[bi, j]))
                        count[key] = count.get(key, 0) + 1
                        seen.add(key[1])
                        if gates is not None:
                            gate_sum[key] = gate_sum.get(key, 0.0) + float(gates[bi, j])
        low_set = set()
        for layer, seen in layers.items():
            def conf(e):
                key = (layer, e)
                if key in gate_sum:
                    return gate_sum[key] / count[key]
                return float(count.get(key, 0))
            ranked = sorted(seen, key=lambda e: (conf(e), e))
            low_set.update((layer, e) for e in ranked[:int(math.floor(low_fraction * len(ranked)))])
            low_set.update((layer, e) for e in range(num_experts) if e not in seen)
        return cls(low_set, high=high, low=low)


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


def expert_weight_shapes(cfg: ModelConfig) -> Tuple[Tuple[int, int], ...]:
    """The three FFN matrices one expert ships: w_gate, w_up, w_down."""
    d, f = cfg.d_model, cfg.d_expert_resolved
    return ((d, f), (d, f), (f, d))


def transport_expert_bytes(cfg: ModelConfig, scheme: str, weight_bytes: int = 4) -> int:
    """Exact packed transport bytes of ONE expert at ``scheme`` for a
    (possibly full-size) config; ``weight_bytes`` is the deployment
    element width, shipped untouched by fp32 transport
    (``repro.quant.transport.transport_expert_bytes``)."""
    codec = get_codec(scheme)
    return sum(codec.packed_nbytes(shape, elem_bytes=weight_bytes)
               for shape in expert_weight_shapes(cfg))
