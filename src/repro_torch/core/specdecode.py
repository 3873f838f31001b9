"""Shadow-drafted speculative decoding: draft, verify, accept
(``repro.core.specdecode``).

The SEP shadow already decodes the whole model in lockstep, so it is the
draft model: ``SEPShadow.rollout_states`` steps it ``S`` times and collects a draft
token and a per-layer expert prediction for each of the next ``S``
positions.  One verify wave then runs all ``S`` positions through the
full model at once by folding them into the batch axis: row ``b*S + s``
carries request ``b``'s position ``pos_b + s`` against its own copy of
the request's KV cache, seeded with the earlier wave rows' K/V, and
``accept_prefix`` keeps the longest prefix on which the full model agrees
with the drafts.

Greedy acceptance makes the tokens equal one-token greedy decode by
construction: row ``b*S`` consumes the request's true last token, so its
argmax is the next token; row ``b*S + s`` equals the sequential step
exactly when the drafts it consumed are the true continuation, which is
the prefix the accept rule keeps; and every row of a wave is an ordinary
one-token decode row.  Its projections run in fixed row blocks, its
attention core is ``flash_decode``, whose output per row does not depend
on B, on W or on masked tail slots, and its experts run through the
grouped FFN, whose bits per (row, expert) pair do not depend on the row
set.  Speculation changes when tokens appear, never which.

The cache commit needs no rollback: row ``b*S + (c_b - 1)`` holds exactly
the slots of positions ``pos_b .. pos_b + c_b - 1``, so ``select_commit``
picks it and the rejected rows' writes are dropped with their copies.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.attention import decode_attend, decode_qkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import tree_map


# ------------------------------------------------------------ verify wave
def _wave_pairs(b: int, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dst, src) wave rows: row ``b*S + s`` receives the K/V of every row
    ``b*S + j`` with ``j <= s`` (its own and the earlier drafts')."""
    tri = torch.tril_indices(S, S, device=device)            # (2, S(S+1)/2), s >= j
    base = torch.arange(b, device=device)[:, None] * S
    return (base + tri[0]).reshape(-1), (base + tri[1]).reshape(-1)


def spec_attn_decode(cfg: ModelConfig, params, x, cache, pos, S: int
                     ) -> Tuple[torch.Tensor, dict]:
    """Multi-position attention decode of a verify wave.

    ``x``: (B*S, 1, d), rows grouped per request, row ``b*S + s`` at
    absolute position ``pos[b*S + s] = base_b + s``; ``cache``: the
    requests' caches (B, W, ...).  Each cache leaf is replicated to one
    copy per wave row, in row order ``b*S + s`` (the copy
    ``attn_decode`` makes of its cache); every row writes its own slot
    ``pos % W`` and each draft row's K, V and position are seeded into
    the later rows of its request, so row ``s`` holds exactly the
    positions ``<= base_b + s``, the cache sequential decode would hold.
    The projections and the core are ``attn_decode``'s own
    (``decode_qkv``, ``decode_attend``).  Requires ``S <= W``, so the
    wave's slots are distinct.  Returns the output and the replicated
    (B*S, W, ...) cache."""
    w = cache["k"].shape[1]
    if S > w:
        raise ValueError(f"a wave of {S} positions does not fit a cache of {w} slots")
    q, k, v = decode_qkv(cfg, params, x, pos)
    dst, src = _wave_pairs(x.shape[0] // S, S, x.device)
    slot = pos.long()[src] % w
    cache = {name: t.repeat_interleave(S, dim=0) for name, t in cache.items()}
    cache["k"][dst, slot] = k[src, 0]
    cache["v"][dst, slot] = v[src, 0]
    cache["pos"][dst, slot] = pos[src].to(torch.int32)
    return decode_attend(cfg, params, q, cache, pos, x.dtype), cache


# ------------------------------------------------------------- acceptance
def accept_prefix(drafts, verified) -> torch.Tensor:
    """Greedy accept rule.  ``drafts`` (B, S): the wave inputs (column 0
    the true last token, columns 1.. the drafts); ``verified`` (B, S): the
    full model's argmax at each position.  Returns the (B,) int32 commit
    counts in ``1..S``: position ``s`` is committed iff every earlier
    draft matched (``verified[:, s-1] == drafts[:, s]``); the first token
    always is.  The committed tokens are ``verified[:, :c]``."""
    drafts, verified = torch.as_tensor(drafts), torch.as_tensor(verified)
    if drafts.shape[1] == 1:
        return torch.ones((drafts.shape[0],), dtype=torch.int32, device=drafts.device)
    ok = (verified[:, :-1] == drafts[:, 1:]).to(torch.int32)
    return (1 + torch.cumprod(ok, dim=1).sum(dim=1)).to(torch.int32)


def select_commit(spec_cache, c, S: int):
    """Each request's accepted row of a replicated (B*S, ...) wave cache:
    row ``b*S + (c_b - 1)`` -> (B, ...), in storage of its own.  ``c``
    should lie on the cache's device (one transfer a wave, not a layer)."""
    c = torch.as_tensor(c)
    idx = torch.arange(c.shape[0], device=c.device) * S + (c.long() - 1)
    return tree_map(lambda a: a[idx.to(a.device)], spec_cache)


def wave_preds(preds_steps: List[Dict[int, np.ndarray]]) -> Dict[int, np.ndarray]:
    """Fold per-step predictions into wave-row order: {layer -> (B*S, k)}
    with row ``b*S + s`` = request ``b``, wave position ``s``, the layout
    ``decode_batch_spec`` routes in."""
    out: Dict[int, np.ndarray] = {}
    for li in preds_steps[0]:
        stacked = np.stack([np.asarray(p[li]) for p in preds_steps], axis=1)   # (B, S, k)
        out[li] = stacked.reshape(-1, stacked.shape[-1])
    return out
