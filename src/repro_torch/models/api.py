"""Model API: init / prefill / decode / greedy generation.

    params         = init_params(cfg, seed, device)
    logits, state  = prefill(cfg, params, batch, max_cache_len)
    logits, state  = decode_step(cfg, params, token, state)
    tokens         = greedy_generate(cfg, params, batch, num_tokens)

``state`` bundles the stacked KV caches and the next position.  MoE
layers always run the ``grouped`` dispatch, the expert-FFN hot path
shared with the OD-MoE engine.  Decoder-only models with attention,
Mamba2 or hybrid layer patterns are ported; encoder-decoder and modality
frontends wait.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from . import transformer as tf_lib
from .attention import cache_width, seq_bucket
from .config import ATTN, ModelConfig


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend models are not "
            "ported yet (ROADMAP.md queue 1)")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), laid out like ``repro.models.init_params``.  The
    generator is not JAX's, so parity tests bridge JAX's parameters
    with :func:`from_numpy` instead."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return tf_lib.init_lm(gen, cfg, getattr(torch, cfg.dtype), dev)


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


# ------------------------------------------------------------------ serving
def _bucketed_prefill_ok(cfg: ModelConfig, t: int, bucket: int, max_cache_len: int) -> bool:
    """Padding the prompt to its pow2 bucket is inert only when every
    mixer is attention, the prompt fits the cache, and no sliding window
    is narrower than the bucket (``seed_cache`` keeps the LAST ``window``
    positions, which would be pads)."""
    if any(mixer != ATTN for mixer, _ in cfg.layer_kinds()):
        return False
    if t > max_cache_len:
        return False
    return not (cfg.sliding_window and cfg.sliding_window < bucket)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, max_cache_len: int):
    """Process the prompt; return (last-token logits, decode state).

    The prompt pads to its pow2 bucket where that is inert; pad slots'
    cache entries are marked empty (``pos = -1``).  A cache narrower than
    the bucket is seeded at the bucket's width and cut to its own (the
    prompt's positions sit in the first slots), so a prompt's prefill
    runs at the same shapes whatever the cache length: a request served
    with the loop's window prefills as its solo decode does.  (The
    reference takes the unpadded path there; the two agree within fp32
    tolerance.)"""
    _require_ported(cfg)
    tokens = batch["tokens"].to(_params_device(params))
    b, t = tokens.shape
    bucket = seq_bucket(t)
    if _bucketed_prefill_ok(cfg, t, bucket, max_cache_len):
        logits, caches = tf_lib.lm_seq(cfg, params, F.pad(tokens, (0, bucket - t)),
                                       make_cache=True,
                                       max_cache_len=max(max_cache_len, bucket))
        w = cache_width(cfg, max_cache_len)
        caches = tuple({"k": c["k"][:, :, :w].contiguous(), "v": c["v"][:, :, :w].contiguous(),
                        "pos": torch.where(c["pos"][:, :, :w] >= t, -1,
                                           c["pos"][:, :, :w]).contiguous()}
                       for c in caches)
    else:
        logits, caches = tf_lib.lm_seq(cfg, params, tokens, make_cache=True,
                                       max_cache_len=max_cache_len)
    pos = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
    return logits[:, t - 1], {"caches": caches, "pos": pos}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, state):
    """One greedy-decode step.  token: (B,) int."""
    logits, caches, _ = tf_lib.lm_decode(cfg, params, token, state["caches"],
                                         state["pos"])
    return logits, dict(state, caches=caches, pos=state["pos"] + 1)


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, batch, num_tokens: int,
                    max_cache_len: int = 0, transport=None):
    """Reference autoregressive generation (prefill + decode loop).

    ``transport`` (a ``repro_torch.quant`` policy or scheme name)
    round-trips every expert weight through the codec the OD-MoE store
    ships with, so the engine must match this output token for token
    under the same policy."""
    if transport is not None:
        from repro_torch.quant.transport import transport_params
        params = transport_params(cfg, params, transport)
    max_cache_len = max_cache_len or (batch["tokens"].shape[1] + num_tokens)
    logits, state = prefill(cfg, params, batch, max_cache_len)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    for _ in range(num_tokens - 1):
        logits, state = decode_step(cfg, params, token, state)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)
