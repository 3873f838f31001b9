"""Encoder-decoder backbone (seamless-m4t-v2 style, audio -> text).

The speech encoder consumes precomputed frame embeddings from the stub
audio frontend (``frontends.py``) and runs bidirectional attention; the
text decoder is causal, with per-layer cross-attention over the encoder
memory.  Cross K/V are computed once per request (``build_memories``), so
a decode step is linear in the memory length; one decoder row attends the
memory through the flash-decode kernel (``attention.cross_attn_decode``).

Parameters keep the reference's stacked layout (``repro.models.encdec``):
the encoder's layers stacked over its depth, the decoder's per pattern
position over repeats, so they bridge leaf for leaf.
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
from .blocks import block_decode, block_seq, init_block, init_block_cache
from .config import ATTN, DENSE_FF, ModelConfig
from .layers import apply_norm, dense_init, embed
from .transformer import (decode_logits, frontend_proj, logits_from_hidden, project_frontend,
                          run_block, stack_made, tree_map, tree_stack, tree_unstack)

ENC_KINDS = (ATTN, DENSE_FF)


# --------------------------------------------------------------------- init
def init_encdec(gen, cfg: ModelConfig, dtype, device) -> dict:
    ones = lambda: {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    pattern, reps = cfg.pattern()
    params = {
        "frontend_proj": frontend_proj(gen, cfg, dtype, device),
        "encoder": stack_made(lambda: init_block(gen, cfg, ENC_KINDS, dtype, device),
                              cfg.num_encoder_layers),
        "enc_norm": ones(),
        "embed": {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                      scale=1.0, device=device)},
        "layers": tuple(stack_made(lambda: init_block(gen, cfg, kinds, dtype, device,
                                                      with_cross=True), reps)
                        for kinds in pattern),
        "final_norm": ones(),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                          device=device)}
    return params


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Empty decoder caches, a tuple per pattern position stacked over
    repeats."""
    pattern, reps = cfg.pattern()
    return tuple(tree_stack([init_block_cache(cfg, kinds, batch, max_len, dtype, device)
                             for _ in range(reps)]) for kinds in pattern)


# ----------------------------------------------------------------- encoder
def encode(cfg: ModelConfig, params, frame_embeds):
    """frame_embeds: (B, S, frontend_dim) -> encoder memory (B, S, d).

    The projection runs in the promoted dtype of the frames and the
    weights, and its output is cast to the model dtype: with frames wider
    than the weights (fp32 frames, bf16 weights) the reference runs the
    whole encoder in the promoted dtype instead."""
    scale = params["enc_norm"]["scale"]
    x = project_frontend(params, frame_embeds.to(scale.device)).to(scale.dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    for lp in tree_unstack(params["encoder"], cfg.num_encoder_layers):
        x, _, _ = block_seq(cfg, lp, ENC_KINDS, x, positions, causal=False)
    return apply_norm(cfg, x, params["enc_norm"])


def build_memories(cfg: ModelConfig, params, enc_out) -> tuple:
    """Per-decoder-layer cross K/V, a tuple per pattern position of
    ``{"k", "v": (R, B, S, K, hd)}`` stacked over repeats."""
    pattern, reps = cfg.pattern()
    return tuple(tree_stack([attn_lib.cross_attn_memory(cfg, cross, enc_out)
                             for cross in tree_unstack(params["layers"][i]["cross"], reps)])
                 for i in range(len(pattern)))


# ----------------------------------------------------------------- decoder
def decoder_seq(cfg: ModelConfig, params, tokens, memories, *, make_cache: bool = False,
                max_cache_len: int = 0, remat: bool = False):
    """The decoder over ``tokens`` (B, T), causal, each block attending its
    layer's memory; ``remat`` rematerialises each block in backward.
    Returns (logits (B, T, V), caches or None)."""
    pattern, reps = cfg.pattern()
    x = embed(tokens, params["embed"])
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    layers = [tree_unstack(stacked, reps) for stacked in params["layers"]]
    mems = [tree_unstack(stacked, reps) for stacked in memories]
    caches = [[] for _ in pattern]
    for r in range(reps):
        for i, kinds in enumerate(pattern):
            x, _, cache = run_block(remat, cfg, layers[i][r], kinds, x, positions, causal=True,
                                    memory=mems[i][r], make_cache=make_cache,
                                    max_cache_len=max_cache_len)
            caches[i].append(cache)
    logits = logits_from_hidden(cfg, params, x)
    return logits, (tuple(tree_stack(c) for c in caches) if make_cache else None)


def encdec_seq(cfg: ModelConfig, params, frame_embeds, tokens, remat: bool = False):
    """Teacher-forced full forward.  Returns (logits, aux).  ``remat``
    rematerialises the decoder's blocks, as the reference checkpoints its
    decoder scan (its ``encdec_seq`` runs the encoder without remat)."""
    memories = build_memories(cfg, params, encode(cfg, params, frame_embeds))
    logits, _ = decoder_seq(cfg, params, tokens, memories, remat=remat)
    return logits, {"load_balance_loss": 0.0}


def encdec_decode(cfg: ModelConfig, params, token, caches, memories, pos):
    """One decoder token (B,) against the KV caches and the precomputed
    cross memories.  Returns (logits (B, V), new_caches)."""
    pattern, reps = cfg.pattern()
    x = embed(token[:, None], params["embed"])
    new_caches = [[] for _ in pattern]
    for r in range(reps):
        for i, kinds in enumerate(pattern):
            lp = tree_map(lambda a: a[r], params["layers"][i])
            lc = tree_map(lambda a: a[r], caches[i])
            mem = tree_map(lambda a: a[r], memories[i])
            x, c, _ = block_decode(cfg, lp, kinds, x, lc, pos, memory=mem)
            new_caches[i].append(c)
    return decode_logits(cfg, params, x), tuple(tree_stack(c) for c in new_caches)
