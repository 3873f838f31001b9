"""Step functions: train / prefill / decode (serve), the port of
``repro.launch.steps``.

These close over a ``ModelConfig`` and are what ``train.py`` runs.
Training differentiates ``loss_fn`` with autograd (per-block remat by
default) and accumulates gradients over microbatches in fp32, then takes
one AdamW step in place.  The reference's sharding hooks
(``layer_constraint``, ``microbatch_constraint``, ``residual_constraint``,
``grad_constraint``) wait for the port's mesh (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import decode_step, loss_fn, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update


def loss_and_grads(cfg: ModelConfig, params, batch, moe_method: str = "scatter",
                   remat: bool = True):
    """``loss_fn`` and its gradient in every parameter leaf: (loss,
    metrics, grads), detached, ``grads`` shaped like ``params`` and in each
    leaf's dtype (zeros where a leaf takes no part, as the reference's
    ``jax.grad`` gives)."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, ps, batch, moe_method=moe_method, remat=remat)
    leaves = tree_leaves(ps)
    grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    moe_method: str = "scatter", n_microbatches: int = 1,
                    remat: bool = True) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The step updates ``params`` and ``opt_state``'s moments in place and
    returns them (the reference's command line donates both to its jitted
    step).  With ``n_microbatches`` > 1 the batch splits along its leading
    axis, each microbatch's gradients add into fp32 accumulators, and the
    sums, the loss and every metric are averaged, as the reference's
    ``lax.scan`` accumulation does."""

    def train_step(params, opt_state, batch):
        if n_microbatches <= 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch, moe_method, remat)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_microbatches:
                raise ValueError(f"a batch of {b} rows does not split into "
                                 f"{n_microbatches} microbatches")
            rows = b // n_microbatches
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss, ms = 0.0, []
            for i in range(n_microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, m, g = loss_and_grads(cfg, params, mb, moe_method, remat)
                for a, gi in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(gi)
                del g
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda a: a.div_(n_microbatches), acc)
            loss = loss / n_microbatches
            metrics = {k: torch.stack([m[k].float() for m in ms]).mean(dim=0) for k in ms[0]}
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      moe_method: str = "scatter") -> Callable:
    """(params, batch) -> (first_token, logits, state)."""

    def prefill_step(params, batch):
        logits, state = prefill(cfg, params, batch, cache_len, moe_method=moe_method)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        return token, logits, state

    return prefill_step


def make_serve_step(cfg: ModelConfig, moe_method: str = "scatter") -> Callable:
    """(params, token, state) -> (next_token, logits, new_state): ONE
    decode step against the resident KV/SSM cache."""

    def serve_step(params, token, state):
        logits, new_state = decode_step(cfg, params, token, state, moe_method=moe_method)
        new_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return new_token, logits, new_state

    return serve_step
