"""Primitive layers: norms, rotary embeddings, SwiGLU MLP, embedding tables.

Plain functions on tensors; parameter trees are dicts shaped exactly
like ``repro.models.layers``' so the stacked leaves bridge one to one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig


# --------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Normal init scaled by ``shape[0] ** -0.5`` (the reference's
    ``_dense_init`` rule, drawn from a torch generator)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


# -------------------------------------------------------------------- apply
def rms_norm(x, params, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * params["scale"]


def layer_norm(x, params, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * params["scale"]


def apply_norm(cfg: ModelConfig, x, params):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params, cfg.norm_eps)
    return rms_norm(x, params, cfg.norm_eps)


def swiglu_mlp(x, params):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def embed(tokens, params):
    return params["table"][tokens.long()]


def unembed(x, params):
    return x @ params["table"].T


# ------------------------------------------------------------------- rotary
def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """Rotary embedding on the last dim of ``x``: (..., seq, heads, head_dim).

    ``fraction < 1`` rotates only the first ``fraction * head_dim``
    channels (ChatGLM-style partial rotary); the rest pass through.
    ``positions``: (..., seq) absolute positions.
    """
    head_dim = x.shape[-1]
    inv_freq, rot = rope_frequencies(head_dim, theta, fraction, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv_freq            # (..., seq, rot/2)
    cos = torch.cos(ang)[..., None, :]                        # over heads
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < head_dim else out
