"""Top-k routed Mixture-of-Experts FFN.

Routing is Mixtral-style: softmax over the top-k router logits only.
The one dispatch ported so far is ``grouped``: the routed experts' FFNs
run through ``repro_torch.kernels.moe_gemm.grouped_topk_contrib`` with
contributions gathered per (row, top-k rank) and summed in fixed rank
order by ``combine_topk`` — the same arithmetic the OD-MoE engine's
wave compute consumes from worker slots.  The ``dense``, ``scatter``
and ``einsum`` dispatches wait (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.moe_gemm import combine_topk, grouped_topk_contrib
from repro_torch.rows import row_blocks

from .config import ModelConfig
from .layers import dense_init


def init_moe(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Router has ``num_experts`` outputs; expert weights carry
    ``num_experts_padded`` rows (pad rows are never routed)."""
    d, f, e = cfg.d_model, cfg.d_expert_resolved, cfg.num_experts
    ep = cfg.num_experts_padded
    return {
        "router": dense_init(gen, (d, e), dtype, device=device),
        "w_gate": dense_init(gen, (ep, d, f), dtype, device=device),
        "w_up": dense_init(gen, (ep, d, f), dtype, device=device),
        "w_down": dense_init(gen, (ep, f, d), dtype, device=device),
    }


def top_k(x, k: int):
    """``jax.lax.top_k`` semantics: values descending, the lower index
    first among equal values (a stable sort pins the tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) -> (topk_idx (N,k) int64, topk_gate (N,k) fp32), in fixed
    row blocks (``rows.row_blocks``), so a row's gate does not depend on
    how many rows were routed with it."""
    def gate(t):
        logits = t.float() @ params["router"].float()
        topk_logits, topk_idx = top_k(logits, cfg.top_k)
        return topk_idx, torch.softmax(topk_logits, dim=-1)

    return row_blocks(gate, x)


def moe_grouped(cfg: ModelConfig, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped top-k dispatch through the shared expert-FFN hot path.

    Stacks ALL experts (the top-k indices are the slot map), so its
    FLOPs are dense; the OD-MoE engine feeds the same functions only a
    wave's slot-resident experts, and per-pair bits do not depend on
    what was stacked.  Returns ``(out (N, d), topk_idx (N, k))``."""
    topk_idx, topk_gate = route(cfg, params, x)
    e = cfg.num_experts
    wg, wu, wd = (params[k][:e] for k in ("w_gate", "w_up", "w_down"))
    contrib = grouped_topk_contrib(x, wg, wu, wd, topk_idx, topk_gate)
    return combine_topk(contrib).to(x.dtype), topk_idx
