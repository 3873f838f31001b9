"""Token / KV-cache alignment policy for the SEP shadow model (§3.2).

Quantization error accumulates through divergent tokens and drifting KV
state, so the shadow is periodically overwritten with the main model's
token and/or KV cache, on independent periods (the paper's ``T_i_KV_j``
grid).  Plain Python, copied from ``repro.core.align``, with the
alignment payload sizes the timing model charges.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ATTN, ModelConfig


@dataclass(frozen=True)
class AlignmentPolicy:
    token_period: int = 1      # 0 = never align tokens
    kv_period: int = 1         # 0 = never align KV

    def align_token_at(self, iteration: int) -> bool:
        return self.token_period > 0 and iteration % self.token_period == 0

    def align_kv_at(self, iteration: int) -> bool:
        return self.kv_period > 0 and iteration % self.kv_period == 0

    def label(self) -> str:
        """The paper's grid name, e.g. ``T1_KV16`` (``off`` for period 0)."""
        t = self.token_period if self.token_period else "off"
        k = self.kv_period if self.kv_period else "off"
        return f"T{t}_KV{k}"


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 4) -> int:
    """Alignment payload: one token's K and V across every attention
    layer (Mixtral-8x7B at fp32: 8 KB per layer)."""
    per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * dtype_bytes
    return per_layer * sum(1 for mixer, _ in cfg.layer_kinds() if mixer == ATTN)


def token_bytes() -> int:
    return 4  # a single token id, "negligible" per the paper
