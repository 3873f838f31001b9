"""Token / KV-cache alignment policy for the SEP shadow model (§3.2).

Quantization error accumulates through divergent tokens and drifting KV
state, so the shadow is periodically overwritten with the main model's
token and/or KV cache, on independent periods (the paper's ``T_i_KV_j``
grid).  Plain Python, copied from ``repro.core.align``; the alignment
payload sizes the timing model uses wait with it.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AlignmentPolicy:
    token_period: int = 1      # 0 = never align tokens
    kv_period: int = 1         # 0 = never align KV

    def align_token_at(self, iteration: int) -> bool:
        return self.token_period > 0 and iteration % self.token_period == 0

    def align_kv_at(self, iteration: int) -> bool:
        return self.kv_period > 0 and iteration % self.kv_period == 0

