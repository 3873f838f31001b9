"""Model API: init / loss / prefill / decode / greedy generation, one
family dispatch for every architecture (dense, MoE, SSM, hybrid, VLM and
encoder-decoder audio):

    params         = init_params(cfg, seed, device)
    loss, metrics  = loss_fn(cfg, params, batch)
    logits, state  = prefill(cfg, params, batch, max_cache_len)
    logits, state  = decode_step(cfg, params, token, state)
    tokens         = greedy_generate(cfg, params, batch, num_tokens)

``state`` bundles the stacked KV caches (an encoder-decoder's cross
memories too) and the next position.  MoE layers take ``moe_method``
with the reference's defaults: ``scatter`` for ``loss_fn`` and
``prefill``, ``grouped`` (the expert-FFN hot path shared with the OD-MoE
engine) for ``decode_step`` and ``greedy_generate``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from . import encdec as encdec_lib
from . import transformer as tf_lib
from .attention import cache_width, seq_bucket
from .config import ATTN, ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), laid out like ``repro.models.init_params``.  The
    generator is not JAX's, so parity tests bridge JAX's parameters
    with :func:`from_numpy` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = encdec_lib.init_encdec if cfg.is_encoder_decoder else tf_lib.init_lm
    with torch.no_grad():
        return init(gen, cfg, getattr(torch, cfg.dtype), dev)


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)     # writable, owned
    if arr.dtype.name == "bfloat16":            # ml_dtypes.bfloat16
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_numpy(tree, device="cuda"):
    """Bridge a parameter tree whose leaves are numpy arrays (e.g. the
    JAX package's params through ``np.asarray``) to tensors on
    ``device``, leaf for leaf, keeping the stacked ``(R, ...)`` layout."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, dev) for v in tree)
    return _to_tensor(tree, dev)


def _params_device(params) -> torch.device:
    return params["embed"]["table"].device


# -------------------------------------------------------------------- train
def loss_fn(cfg: ModelConfig, params, batch, moe_method="scatter", remat: bool = False):
    """Next-token cross-entropy plus ``router_aux_weight`` times the MoE
    load-balance loss.  ``batch``: ``{"tokens": (B,T) int, "loss_mask":
    (B,T) optional, "frontend_embeds": (B,N,fd) for VLM and audio}``; a
    VLM's logits over its N modality positions are left out.  Returns
    ``(loss, {"ce", "load_balance_loss", "loss"})``.  ``remat``
    rematerialises every block in backward.  Not under ``no_grad``: a
    training step differentiates it.  On the card the SSD scan kernel has
    a backward (the same scan in reverse); the expert-FFN kernel has none,
    so ``grouped`` raises under grad there, and training runs ``scatter``
    as the reference's does."""
    dev = _params_device(params)
    tokens = batch["tokens"].to(dev)
    if cfg.is_encoder_decoder:
        logits, aux = encdec_lib.encdec_seq(cfg, params, batch["frontend_embeds"], tokens,
                                            remat=remat)
    else:
        logits, aux, _ = tf_lib.lm_seq(cfg, params, tokens,
                                       frontend_embeds=batch.get("frontend_embeds"),
                                       moe_method=moe_method, remat=remat)
        logits = logits[:, aux["n_front"]:]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(dev)[:, 1:].to(nll.dtype)
    ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    lb = aux.get("load_balance_loss", 0.0)
    loss = ce + cfg.router_aux_weight * lb
    return loss, {"ce": ce, "load_balance_loss": lb, "loss": loss}


# ------------------------------------------------------------------ serving
def _bucketed_prefill_ok(cfg: ModelConfig, batch, t: int, bucket: int,
                         max_cache_len: int) -> bool:
    """Padding the prompt to its pow2 bucket is inert only for a
    decoder-only model fed tokens alone, when every mixer is attention,
    the prompt fits the cache, and no sliding window is narrower than the
    bucket (``seed_cache`` keeps the LAST ``window`` positions, which would
    be pads)."""
    if cfg.is_encoder_decoder or batch.get("frontend_embeds") is not None:
        return False
    if any(mixer != ATTN for mixer, _ in cfg.layer_kinds()):
        return False
    if t > max_cache_len:
        return False
    return not (cfg.sliding_window and cfg.sliding_window < bucket)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, max_cache_len: int, moe_method="scatter"):
    """Process the prompt; return (last-token logits, decode state).

    A token-only prompt of an attention-only decoder pads to its pow2
    bucket; pad slots' cache entries are marked empty (``pos = -1``).  A
    cache narrower than the bucket is seeded at the bucket's width and cut
    to its own (the prompt's positions sit in the first slots), so a
    prompt's prefill runs at the same shapes whatever the cache length: a
    request served with the loop's window prefills as its solo decode
    does.  (The reference takes the unpadded path there; the two agree
    within fp32 tolerance.)  A prompt with ``frontend_embeds`` and an
    encoder-decoder's take the unpadded path; a VLM's next position is
    ``T + N``, past its N modality positions.  An encoder-decoder encodes
    ``frontend_embeds``, builds every layer's cross memory and keeps it in
    the state."""
    dev = _params_device(params)
    tokens = batch["tokens"].to(dev)
    b, t = tokens.shape
    if cfg.is_encoder_decoder:
        enc_out = encdec_lib.encode(cfg, params, batch["frontend_embeds"])
        memories = encdec_lib.build_memories(cfg, params, enc_out)
        logits, caches = encdec_lib.decoder_seq(cfg, params, tokens, memories,
                                                make_cache=True, max_cache_len=max_cache_len)
        pos = torch.full((b,), t, dtype=torch.int32, device=dev)
        return logits[:, -1], {"caches": caches, "memories": memories, "pos": pos}
    bucket = seq_bucket(t)
    if _bucketed_prefill_ok(cfg, batch, t, bucket, max_cache_len):
        logits, _, caches = tf_lib.lm_seq(cfg, params, F.pad(tokens, (0, bucket - t)),
                                          make_cache=True,
                                          max_cache_len=max(max_cache_len, bucket),
                                          moe_method=moe_method)
        w = cache_width(cfg, max_cache_len)
        caches = tuple({"k": c["k"][:, :, :w].contiguous(), "v": c["v"][:, :, :w].contiguous(),
                        "pos": torch.where(c["pos"][:, :, :w] >= t, -1,
                                           c["pos"][:, :, :w]).contiguous()}
                       for c in caches)
    else:
        logits, aux, caches = tf_lib.lm_seq(cfg, params, tokens,
                                            frontend_embeds=batch.get("frontend_embeds"),
                                            make_cache=True, max_cache_len=max_cache_len,
                                            moe_method=moe_method)
        t += aux["n_front"]
    pos = torch.full((b,), t, dtype=torch.int32, device=dev)
    return logits[:, t - 1], {"caches": caches, "pos": pos}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, state, moe_method="grouped"):
    """One greedy-decode step.  token: (B,) int."""
    pos = state["pos"]
    if cfg.is_encoder_decoder:
        logits, caches = encdec_lib.encdec_decode(cfg, params, token, state["caches"],
                                                  state["memories"], pos)
    else:
        logits, caches, _ = tf_lib.lm_decode(cfg, params, token, state["caches"], pos,
                                             moe_method=moe_method)
    return logits, dict(state, caches=caches, pos=pos + 1)


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, batch, num_tokens: int,
                    max_cache_len: int = 0, moe_method="grouped", transport=None):
    """Reference autoregressive generation (prefill + decode loop).

    ``transport`` (a ``repro_torch.quant`` policy or scheme name)
    round-trips every expert weight through the codec the OD-MoE store
    ships with, so the engine must match this output token for token
    under the same policy.  The cache defaults to prompt + ``num_tokens``
    slots, as in the reference: a VLM's N modality positions do not count,
    so with that default the ring buffer keeps only the last of the N + T
    prompt positions and the image leaves the decode context; pass
    ``max_cache_len`` >= N + T + ``num_tokens`` to keep it."""
    if transport is not None:
        from repro_torch.quant.transport import transport_params
        params = transport_params(cfg, params, transport)
    max_cache_len = max_cache_len or (batch["tokens"].shape[1] + num_tokens)
    logits, state = prefill(cfg, params, batch, max_cache_len, moe_method=moe_method)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    for _ in range(num_tokens - 1):
        logits, state = decode_step(cfg, params, token, state, moe_method=moe_method)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)
