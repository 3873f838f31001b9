"""Decoder-only LM assembled from blocks; a VLM's projected modality
embeddings are prepended to its token embeddings.

Layers are grouped into the smallest repeating pattern (period P) and
its repeats (R = L / P); the parameters of each pattern position are
stacked along a leading R axis, exactly as in ``repro.models.transformer``
(where the model runs as ``lax.scan`` over R).  The port keeps that
layout so parameters bridge leaf for leaf, and so leaf-wide operations
(the SEP shadow's int8 scales, taken over every axis but the last of a
stacked leaf) see the same tensors; it runs the layers as a Python loop
over views of the stacked leaves.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.rows import row_blocks

from .blocks import block_decode, block_seq, init_block
from .config import MOE_FF, ModelConfig
from .layers import apply_norm, dense_init, embed, unembed


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_stack(trees):
    """Stack same-shaped trees leaf by leaf along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_stack([t[i] for t in trees])
                            for i in range(len(first)))
    return torch.stack(trees)


def stack_made(make, reps: int):
    """``tree_stack([make() for _ in range(reps)])`` one repeat at a time:
    each made tree is copied into preallocated stacked leaves and dropped,
    so a full-size model's init holds its stack and one layer, not every
    layer twice.  ``make`` is called ``reps`` times in order (the same
    random draws as the list form)."""
    made = make()
    out = tree_map(lambda a: a.new_empty((reps,) + tuple(a.shape)), made)
    for r in range(reps):
        if r:
            made = make()
        for dst, src in zip(tree_leaves(out), tree_leaves(made)):
            dst[r].copy_(src)
        made = None         # this repeat's tree goes before the next is made
    return out


def tree_concat(trees, dim: int = 0):
    """Concatenate same-structured trees leaf by leaf along ``dim``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_concat([t[k] for t in trees], dim) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_concat([t[i] for t in trees], dim)
                            for i in range(len(first)))
    return torch.cat(trees, dim=dim)


def tree_unstack(tree, reps: int) -> list:
    """The ``reps`` per-repeat trees of a stacked tree, from one ``unbind``
    of each leaf: views equal to ``a[r]``, whose gradients autograd stacks
    once into the leaf's, where ``a[r]`` per repeat would sum ``reps``
    zero-filled leaf-sized buffers."""
    if isinstance(tree, dict):
        parts = {k: tree_unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(reps)]
    if isinstance(tree, (tuple, list)):
        parts = [tree_unstack(v, reps) for v in tree]
        return [type(tree)(p[r] for p in parts) for r in range(reps)]
    return list(tree.unbind(0))


def run_block(remat: bool, *args, **kw):
    """``block_seq(*args, **kw)``, under per-block activation
    rematerialisation when ``remat`` (``torch.utils.checkpoint``, the
    counterpart of the reference's checkpointed scan body): backward
    recomputes the block from its input instead of keeping its
    activations."""
    if remat:
        return checkpoint(block_seq, *args, use_reentrant=False, **kw)
    return block_seq(*args, **kw)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# --------------------------------------------------------------------- init
def init_lm(gen, cfg: ModelConfig, dtype, device) -> dict:
    pattern, reps = cfg.pattern()
    params = {
        "embed": {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                      scale=1.0, device=device)},
        "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                          dtype, device=device)}
    if cfg.frontend:
        params["frontend_proj"] = frontend_proj(gen, cfg, dtype, device)
    params["layers"] = tuple(
        stack_made(lambda: init_block(gen, cfg, kinds, dtype, device), reps)
        for kinds in pattern)
    return params


def frontend_proj(gen, cfg: ModelConfig, dtype, device) -> dict:
    """The projection of modality embeddings (``frontend_dim``) into the
    model width."""
    fd = cfg.frontend_dim or cfg.d_model
    return {"w": dense_init(gen, (fd, cfg.d_model), dtype, device=device),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def project_frontend(params, embeds):
    """``embeds @ w + b`` in the promoted dtype of the embeddings and the
    projection, as the reference's mixed-dtype product computes it."""
    proj = params["frontend_proj"]
    dt = torch.promote_types(embeds.dtype, proj["w"].dtype)
    return embeds.to(dt) @ proj["w"].to(dt) + proj["b"].to(dt)


def layer_params(cfg: ModelConfig, params, layer_idx: int):
    """Parameters of one layer: views into the stacked leaves."""
    pattern, _ = cfg.pattern()
    pos, rep = layer_idx % len(pattern), layer_idx // len(pattern)
    return tree_map(lambda a: a[rep], params["layers"][pos])


def logits_from_hidden(cfg: ModelConfig, params, x):
    x = apply_norm(cfg, x, params["final_norm"])
    if cfg.tie_embeddings:
        return unembed(x, params["embed"])
    return x @ params["head"]["w"]


def decode_logits(cfg: ModelConfig, params, x):
    """(B,1,d) hidden -> (B,V) logits of a decode step, in fixed row
    blocks (``rows.row_blocks``)."""
    return row_blocks(lambda t: logits_from_hidden(cfg, params, t), x)[:, 0]


# ------------------------------------------------------------------ embeds
def input_embeddings(cfg: ModelConfig, params, tokens, frontend_embeds=None):
    """Token embeddings, with the projected modality embeddings (B, N, fd)
    prepended.  Returns (x, n_front)."""
    x = embed(tokens, params["embed"])
    if not (cfg.frontend and frontend_embeds is not None):
        return x, 0
    fx = project_frontend(params, frontend_embeds.to(x.device))
    return torch.cat([fx.to(x.dtype), x], dim=1), frontend_embeds.shape[1]


# ---------------------------------------------------------------- sequence
def lm_seq(cfg: ModelConfig, params, tokens, *, frontend_embeds=None,
           make_cache: bool = False, max_cache_len: int = 0, moe_method="scatter",
           remat: bool = False):
    """Full-sequence forward.  Returns (logits (B,N+T,V), aux, caches):
    ``aux`` holds the summed ``load_balance_loss``, ``topk`` (a tuple per
    MoE pattern position of (R, B, N+T, k) routing decisions) and
    ``n_front``, the N modality positions prepended; caches is a tuple per
    pattern position of KV dicts stacked over repeats (or None without
    ``make_cache``).  ``remat`` rematerialises each block in backward
    (training)."""
    pattern, reps = cfg.pattern()
    x, n_front = input_embeddings(cfg, params, tokens, frontend_embeds)
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    layers = [tree_unstack(stacked, reps) for stacked in params["layers"]]
    caches = [[] for _ in pattern]
    auxs = [[] for _ in pattern]
    for r in range(reps):
        for i, kinds in enumerate(pattern):
            x, aux, cache = run_block(remat, cfg, layers[i][r], kinds, x, positions,
                                      moe_method=moe_method, make_cache=make_cache,
                                      max_cache_len=max_cache_len)
            auxs[i].append(aux)
            caches[i].append(cache)
    logits = logits_from_hidden(cfg, params, x)
    moe = [i for i, kinds in enumerate(pattern) if kinds[1] == MOE_FF]
    lb = sum(a["load_balance_loss"] for i in moe for a in auxs[i])
    aux = {"load_balance_loss": lb,
           "topk": tuple(torch.stack([a["topk_idx"] for a in auxs[i]]) for i in moe),
           "n_front": n_front}
    return logits, aux, (tuple(tree_stack(c) for c in caches) if make_cache else None)


# ------------------------------------------------------------------ decode
def lm_decode(cfg: ModelConfig, params, token, caches, pos, moe_method="grouped"
              ) -> Tuple[torch.Tensor, tuple, dict]:
    """One-token decode.  token: (B,) int; pos: (B,) absolute position.

    Returns (logits (B,V), new_caches, aux) with ``aux["topk"]`` a tuple
    per MoE pattern position of (R, B, 1, k) routing decisions."""
    pattern, reps = cfg.pattern()
    x = embed(token[:, None], params["embed"])
    new_caches = [[] for _ in pattern]
    topk = [[] for _ in pattern]
    for r in range(reps):
        for i, kinds in enumerate(pattern):
            lp = tree_map(lambda a: a[r], params["layers"][i])
            lc = tree_map(lambda a: a[r], caches[i])
            x, c, idx = block_decode(cfg, lp, kinds, x, lc, pos, moe_method=moe_method)
            new_caches[i].append(c)
            topk[i].append(idx)
    logits = decode_logits(cfg, params, x)
    aux = {"topk": tuple(torch.stack(topk[i]) for i, kinds in enumerate(pattern)
                         if kinds[1] == MOE_FF)}
    return logits, tuple(tree_stack(c) for c in new_caches), aux
