"""Residual blocks: an attention or Mamba2 mixer with a MoE FFN, a dense
SwiGLU FFN or none; an encoder-decoder's decoder block adds
cross-attention over the encoder memory after its self-attention.

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
from .moe import init_moe, moe_ff, moe_grouped, route


# --------------------------------------------------------------------- init
def init_block(gen, cfg: ModelConfig, kinds: Tuple[str, str], dtype,
               device, with_cross: bool = False) -> dict:
    ones = lambda: {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    mixer = (attn_lib.init_attention(gen, cfg, dtype, device) if kinds[0] == ATTN
             else mamba_lib.init_mamba(gen, cfg, dtype, device))
    p = {"norm1": ones(), "mixer": mixer}
    if with_cross and kinds[0] == ATTN:
        p["norm_cross"] = ones()
        p["cross"] = attn_lib.init_attention(gen, cfg, dtype, device, cross=True)
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
def apply_ff(cfg: ModelConfig, params, kinds, x, moe_method="scatter"):
    """x: (B, T, d) -> (x + ff(x), aux): a MoE layer's aux holds its
    load-balance loss and top-k indices (B, T, k); other layers' is {}."""
    ff = kinds[1]
    if ff == NO_FF:
        return x, {}
    h = apply_norm(cfg, x, params["norm2"])
    if ff == MOE_FF:
        b, t, d = h.shape
        out, aux = moe_ff(cfg, params["ff"], h.reshape(b * t, d), moe_method)
        return x + out.reshape(b, t, d), {
            "load_balance_loss": aux["load_balance_loss"],
            "topk_idx": aux["topk_idx"].reshape(b, t, cfg.top_k)}
    return x + swiglu_mlp(h, params["ff"]), {}


def block_seq(cfg: ModelConfig, params, kinds, x, positions, *, causal: bool = True,
              memory: Optional[dict] = None, moe_method="scatter",
              make_cache: bool = False, max_cache_len: int = 0):
    """Full-sequence block: causal (with the config's sliding window) or
    bidirectional (an encoder's), with cross-attention over ``memory``
    after self-attention in a decoder block that has it.  Returns
    (x, aux, cache-or-None)."""
    h = apply_norm(cfg, x, params["norm1"])
    if kinds[0] == ATTN:
        out = attn_lib.attn_seq(cfg, params["mixer"], h, positions, causal=causal,
                                window=cfg.sliding_window if causal else 0)
        cache = (attn_lib.seed_cache(cfg, params["mixer"], h, positions,
                                     max_cache_len) if make_cache else None)
    else:
        out, state = mamba_lib.mamba_seq(cfg, params["mixer"], h)
        cache = state if make_cache else None
    x = x + out
    if memory is not None and "cross" in params:
        hc = apply_norm(cfg, x, params["norm_cross"])
        x = x + attn_lib.cross_attn(cfg, params["cross"], hc, memory)
    x, aux = apply_ff(cfg, params, kinds, x, moe_method)
    return x, aux, cache


def block_decode(cfg: ModelConfig, params, kinds, x, cache, pos, attn=None,
                 memory: Optional[dict] = None, moe_method="grouped"
                 ) -> Tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
    """One-token block.  x: (B,1,d).  Returns (x, new_cache, topk_idx).

    The norms, projections, router and dense FF run in fixed row blocks
    (``rows.row_blocks``); the experts run on the real rows only, through
    the grouped FFN, whose per-row bits do not depend on the row count
    (another ``moe_method`` runs that dispatch through ``moe_ff``).
    A Mamba mixer ignores ``pos``.  ``attn`` replaces ``attn_decode`` for
    an attention mixer with the same signature (a speculative verify
    wave's ``spec_attn_decode``); the rest of the block is unchanged.
    With ``memory`` a decoder block that has cross-attention runs it after
    self-attention (``cross_attn_decode``, through the same kernel)."""
    h = row_blocks(lambda t: apply_norm(cfg, t, params["norm1"]), x)
    if kinds[0] == ATTN:
        out, cache = (attn or attn_lib.attn_decode)(cfg, params["mixer"], h, cache, pos)
    else:
        out, cache = mamba_lib.mamba_decode(cfg, params["mixer"], h, cache)
    x = x + out
    if memory is not None and "cross" in params:
        hc = row_blocks(lambda t: apply_norm(cfg, t, params["norm_cross"]), x)
        x = x + attn_lib.cross_attn_decode(cfg, params["cross"], hc, memory, pos)
    if kinds[1] == NO_FF:
        return x, cache, None
    h = row_blocks(lambda t: apply_norm(cfg, t, params["norm2"]), x)
    if kinds[1] == MOE_FF:
        b, t, d = h.shape
        if moe_method == "grouped":
            y, topk_idx = moe_grouped(cfg, params["ff"], h.reshape(b * t, d))
        else:
            y, aux = moe_ff(cfg, params["ff"], h.reshape(b * t, d), moe_method)
            topk_idx = aux["topk_idx"]
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
