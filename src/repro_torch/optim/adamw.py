"""AdamW + cosine schedule + global-norm clipping: the port of
``repro.optim.adamw``, with its arithmetic (clip, bias corrections in
fp32, decay of every leaf with ``ndim >= 2``, the update in fp32 cast back
to the parameter dtype).

The update runs in place, leaf by leaf, over chunks of each leaf's leading
axis (``_chunks``): the parameters and the ``mu`` / ``nu`` moments are
overwritten, as the reference's command line donates them to its jitted
step, and a stacked expert leaf never materialises a full fp32 copy of
itself (granite-moe's is 1.2 G elements, 4.8 GB in fp32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map

# elements of one chunk of a leaf's leading axis: each fp32 temporary of
# the update is at most 64 MB (one whole slice where a slice is larger)
CHUNK_ELEMENTS = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_opt_state(params) -> dict:
    """fp32 ``mu`` and ``nu`` shaped like ``params`` (on its devices) and
    an int32 ``step``."""
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr`` (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cos


def _chunks(t: torch.Tensor):
    """Views of ``t`` over chunks of its leading axis, each of at most
    ``CHUNK_ELEMENTS`` elements (or one slice of it)."""
    if t.dim() == 0:
        return (t,)
    per_row = max(1, t[0].numel())
    return t.split(max(1, CHUNK_ELEMENTS // per_row))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (chunked, so a
    bf16 leaf is never copied whole to fp32)."""
    return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                          for x in tree_leaves(tree) for c in _chunks(x)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig) -> Tuple[dict, dict, dict]:
    """One AdamW step, in place on ``params`` and on ``state``'s moments.
    Returns (params, state, metrics) as the reference does."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.beta1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.beta2, step.to(torch.float32))
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        decay = p.dim() >= 2          # matrices only; a stacked (R, D) norm too
        for pc, gc, mc, nc in zip(*(_chunks(t) for t in (p, g, mu, nu))):
            g32 = gc.float() * scale
            mc.mul_(cfg.beta1).add_((1 - cfg.beta1) * g32)
            nc.mul_(cfg.beta2).add_((1 - cfg.beta2) * torch.square(g32))
            delta = (mc / b1c) / (torch.sqrt(nc / b2c) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * pc.float()
            pc.copy_((pc.float() - lr * delta).to(pc.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, metrics
