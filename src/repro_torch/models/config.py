"""Unified model/architecture configuration (plain data, no torch).

One ``ModelConfig`` covers every architecture family of the registry:
dense / moe / ssm / hybrid / vlm / audio (enc-dec).  Family-specific
fields are zero/empty when unused.  Configs are frozen dataclasses so
they hash.  This is the port's own copy of ``repro.models.config``;
tests hold the two equal field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Layer kinds used to build the per-stage layer pattern.
ATTN = "attn"          # attention mixer
MAMBA = "mamba"        # Mamba2 SSD mixer
DENSE_FF = "dense"     # SwiGLU MLP
MOE_FF = "moe"         # top-k routed expert FFN
NO_FF = "none"         # mixer-only layer (mamba blocks without extra FFN)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # per-expert FFN hidden size (0 -> d_ff)
    moe_every: int = 1               # MoE FFN on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Pad the expert-weight axis to this count (0 = no padding) so the
    # expert dim divides a mesh axis.  Padded experts are never routed
    # (the router only has num_experts outputs).
    padded_experts: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: attention at idx % attn_every == attn_offset
    attn_offset: int = 0

    # --- attention details ---
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm "2d rope": rotate only this fraction of head_dim
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 = full attention; >0 = ring-buffer window
    logit_soft_cap: float = 0.0

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality frontend (STUB per spec carve-out) ---
    frontend: str = ""               # ''|'vision'|'audio'
    frontend_tokens: int = 0         # patches / audio frames expected by input_specs
    frontend_dim: int = 0            # raw embedding dim fed to the projector

    norm_type: str = "rmsnorm"       # rmsnorm|layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"           # parameter dtype for init / dry-run
    source: str = ""                 # citation

    # -------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_expert_resolved(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def num_experts_padded(self) -> int:
        return max(self.padded_experts, self.num_experts)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer_kind, ff_kind) for each decoder layer, in order."""
        out = []
        for i in range(self.num_layers):
            if self.family in ("ssm",):
                mixer = MAMBA
            elif self.family == "hybrid" and self.attn_every:
                mixer = ATTN if i % self.attn_every == self.attn_offset else MAMBA
            else:
                mixer = ATTN
            if self.num_experts and i % self.moe_every == self.moe_offset:
                ff = MOE_FF
            elif self.family == "ssm":
                ff = NO_FF                      # Mamba2 blocks carry no separate MLP
            else:
                ff = DENSE_FF
            out.append((mixer, ff))
        return tuple(out)

    def pattern(self) -> Tuple[Tuple[Tuple[str, str], ...], int]:
        """Smallest repeating layer pattern and its repeat count.

        Parameters of each pattern position are stacked along a leading
        ``repeats`` axis; the layout is shared with ``repro`` so weights
        bridge leaf for leaf.
        """
        kinds = self.layer_kinds()
        n = len(kinds)
        for p in range(1, n + 1):
            if n % p == 0 and kinds[:p] * (n // p) == kinds:
                return kinds[:p], n // p
        return kinds, 1

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        period = len(self.pattern()[0])
        small = dict(
            num_layers=max(2, period),
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.head_dim else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            name=self.name + "-smoke",
        )
        if self.num_experts:
            small.update(num_experts=min(self.num_experts, 4),
                         top_k=min(self.top_k, 2),
                         d_expert=min(self.d_expert_resolved, 128),
                         padded_experts=0)
        if self.ssm_state:
            small.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=16,
                         ssm_chunk=16)
        if self.is_encoder_decoder:
            small.update(num_encoder_layers=2)
        if self.frontend:
            small.update(frontend_tokens=min(self.frontend_tokens or 16, 16),
                         frontend_dim=min(self.frontend_dim or 64, 64))
        small.update(dtype="float32")  # CPU smoke tests run in fp32
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used for 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.frontend:
            total += (self.frontend_dim or d) * d + d
        enc_layers = self.num_encoder_layers if self.is_encoder_decoder else 0
        for i in range(enc_layers):
            total += self._attn_params(cross=False) + self._dense_ff_params() + 2 * d
        if self.is_encoder_decoder:
            total += d  # encoder final norm
        for mixer, ff in self.layer_kinds():
            total += d  # pre-mixer norm
            if mixer == ATTN:
                total += self._attn_params(cross=False)
                if self.is_encoder_decoder:
                    total += self._attn_params(cross=True) + d
            else:
                total += self._mamba_params()
            if ff != NO_FF:
                total += d  # pre-ff norm
            if ff == MOE_FF:
                total += d * self.num_experts  # router
                total += self.num_experts_padded * 3 * d * self.d_expert_resolved
            elif ff == DENSE_FF:
                total += self._dense_ff_params()
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts; padded
        expert rows are never routed, hence never active)."""
        if not self.num_experts:
            return self.param_count()
        per_expert = 3 * self.d_model * self.d_expert_resolved
        n_moe_layers = sum(1 for _, ff in self.layer_kinds() if ff == MOE_FF)
        inactive = n_moe_layers * per_expert * (
            self.num_experts_padded - self.top_k)
        return self.param_count() - inactive

    def _attn_params(self, cross: bool) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _dense_ff_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        d, di, ns, nh = self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        conv_ch = di + 2 * ns
        in_proj = d * (2 * di + 2 * ns + nh)
        conv = conv_ch * self.ssm_conv + conv_ch
        extra = nh * 3  # A_log, dt_bias, D
        norm = di
        out_proj = di * d
        return in_proj + conv + extra + norm + out_proj


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
