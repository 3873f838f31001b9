"""Residual blocks: an attention or Mamba2 mixer with a MoE FFN, a dense
SwiGLU FFN or none.

A block is described by ``kinds = (mixer_kind, ff_kind)`` from
``ModelConfig.layer_kinds()``.  Its decode cache is an attention layer's
KV dict or a Mamba layer's ``{"h", "conv"}`` state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.rows import row_blocks

from . import attention as attn_lib
from . import mamba as mamba_lib
from .config import ATTN, DENSE_FF, MOE_FF, NO_FF, ModelConfig
from .layers import apply_norm, dense_init, swiglu_mlp
from .moe import init_moe, moe_grouped, route


# --------------------------------------------------------------------- init
def init_block(gen, cfg: ModelConfig, kinds: Tuple[str, str], dtype,
               device) -> dict:
    ones = lambda: {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    mixer = (attn_lib.init_attention(gen, cfg, dtype, device) if kinds[0] == ATTN
             else mamba_lib.init_mamba(gen, cfg, dtype, device))
    p = {"norm1": ones(), "mixer": mixer}
    ff = kinds[1]
    if ff == MOE_FF:
        p["norm2"] = ones()
        p["ff"] = init_moe(gen, cfg, dtype, device)
    elif ff == DENSE_FF:
        d, f = cfg.d_model, cfg.d_ff
        p["norm2"] = ones()
        p["ff"] = {"w_gate": dense_init(gen, (d, f), dtype, device=device),
                   "w_up": dense_init(gen, (d, f), dtype, device=device),
                   "w_down": dense_init(gen, (f, d), dtype, device=device)}
    return p


def init_block_cache(cfg: ModelConfig, kinds: Tuple[str, str], batch: int,
                     max_len: int, dtype, device) -> dict:
    if kinds[0] == ATTN:
        return attn_lib.init_cache(cfg, batch, max_len, dtype, device)
    return mamba_lib.init_ssm_state(cfg, batch, dtype, device)


# ------------------------------------------------------------------- apply
def apply_ff(cfg: ModelConfig, params, kinds, x):
    """x: (B, T, d) -> (x + ff(x), topk_idx (B, T, k) or None)."""
    ff = kinds[1]
    if ff == NO_FF:
        return x, None
    h = apply_norm(cfg, x, params["norm2"])
    if ff == MOE_FF:
        b, t, d = h.shape
        out, topk_idx = moe_grouped(cfg, params["ff"], h.reshape(b * t, d))
        return x + out.reshape(b, t, d), topk_idx.reshape(b, t, cfg.top_k)
    return x + swiglu_mlp(h, params["ff"]), None


def block_seq(cfg: ModelConfig, params, kinds, x, positions, *,
              make_cache: bool = False, max_cache_len: int = 0):
    """Full-sequence causal block.  Returns (x, cache-or-None)."""
    h = apply_norm(cfg, x, params["norm1"])
    if kinds[0] == ATTN:
        out = attn_lib.attn_seq(cfg, params["mixer"], h, positions, causal=True,
                                window=cfg.sliding_window)
        cache = (attn_lib.seed_cache(cfg, params["mixer"], h, positions,
                                     max_cache_len) if make_cache else None)
    else:
        out, state = mamba_lib.mamba_seq(cfg, params["mixer"], h)
        cache = state if make_cache else None
    x, _ = apply_ff(cfg, params, kinds, x + out)
    return x, cache


def block_decode(cfg: ModelConfig, params, kinds, x, cache, pos, attn=None
                 ) -> Tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
    """One-token block.  x: (B,1,d).  Returns (x, new_cache, topk_idx).

    The norms, projections, router and dense FF run in fixed row blocks
    (``rows.row_blocks``); the experts run on the real rows only, through
    the grouped FFN, whose per-row bits do not depend on the row count.
    A Mamba mixer ignores ``pos``.  ``attn`` replaces ``attn_decode`` for
    an attention mixer with the same signature (a speculative verify
    wave's ``spec_attn_decode``); the rest of the block is unchanged."""
    h = row_blocks(lambda t: apply_norm(cfg, t, params["norm1"]), x)
    if kinds[0] == ATTN:
        out, cache = (attn or attn_lib.attn_decode)(cfg, params["mixer"], h, cache, pos)
    else:
        out, cache = mamba_lib.mamba_decode(cfg, params["mixer"], h, cache)
    x = x + out
    if kinds[1] == NO_FF:
        return x, cache, None
    h = row_blocks(lambda t: apply_norm(cfg, t, params["norm2"]), x)
    if kinds[1] == MOE_FF:
        b, t, d = h.shape
        y, topk_idx = moe_grouped(cfg, params["ff"], h.reshape(b * t, d))
        return x + y.reshape(b, t, d), cache, topk_idx.reshape(b, t, cfg.top_k)
    return x + row_blocks(lambda t: swiglu_mlp(t, params["ff"]), h), cache, None


def block_decode_router(cfg: ModelConfig, params, kinds, x, cache, pos, attn=None):
    """A MoE block's decode step up to its experts: the mixer and its
    residual (``block_decode`` without the FFN), the router input in the
    fixed row blocks ``block_decode`` computes it in, and the top-k
    routing.  Returns ``(x, new_cache, h (B,d), topk_idx, topk_gate)``;
    the engine runs the experts from its worker slots."""
    x, cache, _ = block_decode(cfg, params, (kinds[0], NO_FF), x, cache, pos, attn=attn)
    h = row_blocks(lambda t: apply_norm(cfg, t, params["norm2"]), x)[:, 0]
    topk_idx, topk_gate = route(cfg, params["ff"], h)
    return x, cache, h, topk_idx, topk_gate
