"""Grouped-query attention with a ring-buffer KV cache.

  * ``attn_seq``    — full-sequence causal attention (prefill); above
    ``BLOCKWISE_THRESHOLD`` tokens it runs ``attn_seq_blockwise``.
  * ``attn_decode`` — single-token decode against the cache.
  * ``cross_attn_*`` — encoder-decoder cross attention over a fixed
    memory; one decoder row (``cross_attn_decode``) runs through the
    flash-decode kernel with the memory as its cache.

KV cache layout (per layer): ``{"k","v": (B, W, n_kv, hd), "pos": (B, W)}``
where ``W`` is ``sliding_window`` if set, else the max sequence length,
and ``pos`` holds the absolute position stored in each slot (-1 = empty).
Keys are stored post-RoPE.  Cache updates are out of place: a cache
handed to another consumer (the SEP shadow's KV alignment adopts the
main model's caches) is never written behind its back.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.rows import row_blocks

from .config import ModelConfig
from .layers import apply_rope, dense_init

NEG_INF = -1e30

SEQ_BUCKET_MIN = 8

BLOCKWISE_THRESHOLD = 2048   # switch to online-softmax blocks beyond this

# Position of a pad row or key in the blockwise path: masked on both sides.
P_INVALID = -2 ** 30


def seq_bucket(n: int) -> int:
    """Smallest power-of-two >= n (floored at ``SEQ_BUCKET_MIN``) — the
    shared length-bucket grid of full-seq attention and prefill."""
    b = SEQ_BUCKET_MIN
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------- init
def init_attention(gen, cfg: ModelConfig, dtype, device, cross: bool = False) -> dict:
    """A cross-attention block (``cross``) never has a qkv bias."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), dtype, device=device),
        "wk": dense_init(gen, (d, cfg.num_kv_heads * hd), dtype, device=device),
        "wv": dense_init(gen, (d, cfg.num_kv_heads * hd), dtype, device=device),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), dtype, device=device),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                        ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Slots per KV cache: the sliding window if set (capped at
    ``max_len``), else ``max_len``."""
    return min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> dict:
    w = cache_width(cfg, max_len)
    hd = cfg.resolved_head_dim
    shape = (batch, w, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, w), -1, dtype=torch.int32,
                              device=device)}


# ------------------------------------------------------------------ helpers
def _project_qkv(cfg: ModelConfig, params, x):
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, t, cfg.num_heads, hd),
            k.reshape(b, t, cfg.num_kv_heads, hd),
            v.reshape(b, t, cfg.num_kv_heads, hd))


def _sqrt_hd(q):
    """sqrt(head_dim) rounded to q's dtype, as the reference divides by."""
    hd = q.shape[-1]
    return torch.tensor(float(hd), dtype=torch.float32).sqrt().to(q.dtype).to(q.device)


def _gqa_scores(cfg: ModelConfig, q, k):
    """q: (B,T,H,hd)  k: (B,S,K,hd)  ->  (B,K,G,T,S) with H = K*G."""
    b, t, h, hd = q.shape
    g = h // cfg.num_kv_heads
    qg = q.reshape(b, t, cfg.num_kv_heads, g, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k) / _sqrt_hd(q)
    if cfg.logit_soft_cap:
        s = cfg.logit_soft_cap * torch.tanh(s / cfg.logit_soft_cap)
    return s


def _gqa_out(cfg: ModelConfig, probs, v, params):
    b, k, g, t, s = probs.shape
    o = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return o.reshape(b, t, k * g * v.shape[-1]) @ params["wo"]


# ---------------------------------------------------------------- full-seq
def attn_seq(cfg: ModelConfig, params, x, positions, *, causal: bool = True,
             window: int = 0):
    """Full-sequence attention (prefill).  The key axis is padded to its
    pow2 bucket before the softmax, as in the reference, so a prompt and
    its bucket-padded twin reduce over identical shapes.  Sequences past
    ``BLOCKWISE_THRESHOLD`` take :func:`attn_seq_blockwise`, so the T x S
    score matrix is never materialized."""
    if x.shape[1] > BLOCKWISE_THRESHOLD:
        return attn_seq_blockwise(cfg, params, x, positions, causal=causal, window=window)
    q, k, v = _project_qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    scores = _gqa_scores(cfg, q, k).float()
    qi = positions[:, None, None, :, None]
    kj = positions[:, None, None, None, :]
    mask = torch.ones(scores.shape[-2:], dtype=torch.bool,
                      device=x.device)[None, None, None]
    if causal:
        mask = mask & (kj <= qi)
    if window:
        mask = mask & (qi - kj < window)
    scores = torch.where(mask, scores, NEG_INF)
    s_len = scores.shape[-1]
    s_pad = seq_bucket(s_len) - s_len
    if s_pad:
        scores = F.pad(scores, (0, s_pad), value=NEG_INF)
        v = F.pad(v, (0, 0, 0, 0, 0, s_pad))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(cfg, probs, v, params)


def attn_seq_blockwise(cfg: ModelConfig, params, x, positions, *, causal: bool = True,
                       window: int = 0, q_block: int = 512, kv_block: int = 512):
    """Online-softmax blockwise attention, O(T) activation memory: the
    reference's recurrence in plain PyTorch (``repro.models.attention.
    attn_seq_blockwise``), a loop over query blocks and, inside it, over
    KV blocks with the (m, l, acc) update.

    Rows and keys past T pad with position ``P_INVALID`` and are masked;
    masked scores are the finite ``NEG_INF``, never -inf.  Every KV block
    runs, fully masked ones too: once a row's m is finite, such a block
    gives p = 0 and corr = 1 exactly and changes no bit, so a prompt
    padded to its bucket gives its real rows the bits of the unpadded
    one.  A row whose first blocks a window masks keeps m = NEG_INF and
    p = 1 on them until its first real block, whose corr of exactly 0
    washes them out, as in the reference."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    g = cfg.num_heads // kv
    q, k, v = _project_qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    qb, kb = min(q_block, t), min(kv_block, t)
    pad_q, pad_k = (-t) % qb, (-t) % kb
    qpos = F.pad(positions, (0, pad_q), value=P_INVALID)
    kpos = F.pad(positions, (0, pad_k), value=P_INVALID)
    nq, nk = (t + pad_q) // qb, (t + pad_k) // kb
    # (B, nq, qb, kv, g, hd) query blocks, scaled first; (B, nk, kb, kv, hd) kv blocks
    qblocks = F.pad(q, (0, 0, 0, 0, 0, pad_q)).reshape(b, nq, qb, kv, g, hd) / _sqrt_hd(q)
    kblocks = F.pad(k, (0, 0, 0, 0, 0, pad_k)).reshape(b, nk, kb, kv, hd)
    vblocks = F.pad(v, (0, 0, 0, 0, 0, pad_k)).reshape(b, nk, kb, kv, hd)
    qpos, kpos = qpos.reshape(b, nq, qb), kpos.reshape(b, nk, kb)
    outs = []
    for i in range(nq):
        qi, qv = qblocks[:, i], qpos[:, i, None, None, :, None]
        m = torch.full((b, kv, g, qb), NEG_INF, dtype=torch.float32, device=x.device)
        l = torch.zeros((b, kv, g, qb), dtype=torch.float32, device=x.device)
        acc = torch.zeros((b, kv, g, qb, hd), dtype=torch.float32, device=x.device)
        for j in range(nk):
            vi, kp = vblocks[:, j], kpos[:, j, None, None, None, :]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kblocks[:, j]).float()
            if cfg.logit_soft_cap:
                s = cfg.logit_soft_cap * torch.tanh(s / cfg.logit_soft_cap)
            mask = (kp > P_INVALID) & (qv > P_INVALID)
            if causal:
                mask = mask & (kp <= qv)
            if window:
                mask = mask & (qv - kp < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vi.dtype), vi).float()
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(x.dtype))   # (B,kv,g,qb,hd)
    o = torch.stack(outs, dim=3).reshape(b, kv, g, nq * qb, hd)[:, :, :, :t]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, kv * g * hd) @ params["wo"]


def seed_cache(cfg: ModelConfig, params, x, positions, max_len: int) -> dict:
    """Build a KV cache from a processed prompt (prefill -> decode)."""
    b, t, _ = x.shape
    _, k, v = _project_qkv(cfg, params, x)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    cache = init_cache(cfg, b, max_len, x.dtype, x.device)
    w = cache["k"].shape[1]
    take = min(t, w)
    slots = positions[:, -take:] % w
    b_idx = torch.arange(b, device=x.device)[:, None]
    cache["k"][b_idx, slots] = k[:, -take:]
    cache["v"][b_idx, slots] = v[:, -take:]
    cache["pos"][b_idx, slots] = positions[:, -take:].to(torch.int32)
    return cache


# ------------------------------------------------------------------- decode
def decode_qkv(cfg: ModelConfig, params, x, pos):
    """The projections of a decode step: q, k, v of the rows ``x``
    (R,1,d) at positions ``pos`` (R,), RoPE applied, in fixed row blocks
    (``rows.row_blocks``), so a row's bits do not depend on R."""
    def qkv(h, p):
        q, k, v = _project_qkv(cfg, params, h)
        return (apply_rope(q, p[:, None], cfg.rope_theta, cfg.rope_fraction),
                apply_rope(k, p[:, None], cfg.rope_theta, cfg.rope_fraction), v)

    return row_blocks(qkv, x, pos)


def decode_attend(cfg: ModelConfig, params, q, cache, pos, dtype, window: int = None):
    """The core and output projection of a decode step: each row's query
    against its own cache row through ``flash_decode``, rounded once to
    ``dtype``, then ``wo`` in fixed row blocks.  ``window`` defaults to the
    cache's rule (its width under a sliding window, else none)."""
    w = cache["k"].shape[1]
    if window is None:
        window = w if cfg.sliding_window else 0
    b, _, h, hd = q.shape
    qg = q[:, 0].reshape(b, cfg.num_kv_heads, h // cfg.num_kv_heads, hd).contiguous()
    o = flash_decode(qg, cache["k"], cache["v"], cache["pos"], pos.to(torch.int32),
                     window=window, soft_cap=cfg.logit_soft_cap or 0.0)
    return row_blocks(lambda t: t @ params["wo"], o.to(dtype).reshape(b, 1, h * hd))


def attn_decode(cfg: ModelConfig, params, x, cache, pos) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B,1,d); pos: (B,) absolute position.
    Writes slot ``pos % W`` of a copy of the cache and returns it.  The
    projections run in fixed row blocks (``decode_qkv``), so a row's bits
    do not depend on B.

    The score/mask/softmax/PV core is ``kernels.flash_decode.flash_decode``
    on both devices (the hand-written kernel on the card, its plain
    version on the host), with head ``h = k*G + g`` as in
    :func:`_gqa_scores`.  It computes in fp32 and rounds once, to the
    model dtype, before ``wo``; the reference rounds its scale and its
    probabilities to the model dtype first, so the two agree exactly in
    semantics only at fp32.  The card has no soft cap: a config with
    ``logit_soft_cap`` raises there.  A speculative verify wave
    (``core.specdecode.spec_attn_decode``) runs the same two steps."""
    q, k, v = decode_qkv(cfg, params, x, pos)
    w = cache["k"].shape[1]
    slot = pos.long() % w
    b_idx = torch.arange(x.shape[0], device=x.device)
    cache = {name: t.clone() for name, t in cache.items()}
    cache["k"][b_idx, slot] = k[:, 0]
    cache["v"][b_idx, slot] = v[:, 0]
    cache["pos"][b_idx, slot] = pos.to(torch.int32)
    return decode_attend(cfg, params, q, cache, pos, x.dtype), cache


# -------------------------------------------------------------- cross-attn
def cross_attn_memory(cfg: ModelConfig, params, enc_out) -> dict:
    """K/V over the encoder output, computed once per request."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    return {"k": (enc_out @ params["wk"]).reshape(b, s, cfg.num_kv_heads, hd),
            "v": (enc_out @ params["wv"]).reshape(b, s, cfg.num_kv_heads, hd)}


def cross_attn(cfg: ModelConfig, params, x, memory, memory_mask=None):
    """x: (B,T,d) attends over the memory K/V (no RoPE, no causal mask,
    no padding of the key axis, as in the reference); ``memory_mask``
    (B,S) bool hides frames."""
    b, t, _ = x.shape
    q = (x @ params["wq"]).reshape(b, t, cfg.num_heads, cfg.resolved_head_dim)
    scores = _gqa_scores(cfg, q, memory["k"]).float()
    if memory_mask is not None:
        scores = torch.where(memory_mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(cfg, probs, memory["v"], params)


def cross_attn_decode(cfg: ModelConfig, params, x, memory, pos, memory_mask=None):
    """One decoder row per batch row (x: (B,1,d), at positions ``pos``)
    over the memory, through ``flash_decode`` with the memory K/V as the
    cache: every frame's slot position is 0 (-1 where ``memory_mask``
    hides it), so the kernel's ``0 <= kpos <= pos`` admits every frame.
    It computes in fp32 and rounds once, to the model dtype, before ``wo``,
    as ``attn_decode`` does; the reference's ``cross_attn`` rounds its
    scale and probabilities first, so the two agree exactly in semantics
    only at fp32.  The query projection runs in fixed row blocks."""
    b, s = memory["k"].shape[:2]
    q = row_blocks(lambda t: t @ params["wq"], x).reshape(b, 1, cfg.num_heads,
                                                          cfg.resolved_head_dim)
    kpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    if memory_mask is not None:
        kpos = torch.where(memory_mask, kpos, -1)
    cache = {"k": memory["k"], "v": memory["v"], "pos": kpos}
    return decode_attend(cfg, params, q, cache, pos, x.dtype, window=0)
