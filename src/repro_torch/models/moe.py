"""Top-k routed Mixture-of-Experts FFN.

Routing is Mixtral-style: softmax over the top-k router logits only.
Four dispatches, selectable per call site (``moe_ff``):

  * ``dense``   — every expert computes every token, combined with the
                  (mostly zero) gate matrix.  Exact, no drops.
  * ``scatter`` — capacity-based gather/GEMM/scatter-add: each expert owns
                  ``C`` slots, tokens take them in order and the ones over
                  capacity fall through on the residual path.  The default
                  of ``loss_fn`` and ``prefill``.
  * ``einsum``  — GShard one-hot dispatch/combine einsums, the same
                  placement as ``scatter``.
  * ``grouped`` — the routed experts' FFNs run through
                  ``repro_torch.kernels.moe_gemm.grouped_topk_contrib``
                  with contributions gathered per (row, top-k rank) and
                  summed in fixed rank order by ``combine_topk``: the same
                  arithmetic the OD-MoE engine's wave compute consumes from
                  worker slots, and the decode default.

``dense``, ``scatter`` and ``einsum`` are plain PyTorch, as the reference
computes them outside any Pallas kernel; ``grouped`` reaches the
hand-written expert-FFN kernel on the card.  Each returns ``(out, aux)``
with the Switch load-balance loss and the top-k indices in ``aux``;
``scatter`` and ``einsum`` add ``drop_fraction`` and, beyond the
reference's aux, ``kept`` (N, k): the (token, rank) pairs that found a slot.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

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


def load_balance_loss(cfg: ModelConfig, params, x, topk_idx):
    """Switch-style load-balance loss ``E * sum_e f_e * p_e / k`` of the
    rows ``x`` (N, d) routed to ``topk_idx`` (N, k), from the full router
    logits over all N rows at once, as the reference's ``route`` aux.  Kept
    apart from :func:`route`, whose row-blocked bits the engine, the shadow
    and serving depend on."""
    logits = x.float() @ params["router"].float()
    e = cfg.num_experts
    f_e = F.one_hot(topk_idx.long(), e).float().sum(dim=1).mean(dim=0)
    p_e = torch.softmax(logits, dim=-1).mean(dim=0)
    return e * (f_e * p_e).sum() / cfg.top_k


def _route_aux(cfg: ModelConfig, params, x):
    """Routing and the aux every dispatch returns."""
    topk_idx, topk_gate = route(cfg, params, x)
    aux = {"load_balance_loss": load_balance_loss(cfg, params, x, topk_idx),
           "topk_idx": topk_idx}
    return topk_idx, topk_gate, aux


def capacity(cfg: ModelConfig, n_tokens: int, factor: float = None) -> int:
    """Slots per expert for ``n_tokens`` rows: ``ceil(k * N / E * factor)``,
    at least 1 (``factor`` defaults to the config's ``capacity_factor``)."""
    factor = cfg.capacity_factor if factor is None else factor
    return max(int(math.ceil(cfg.top_k * n_tokens / cfg.num_experts * factor)), 1)


def _swiglu_experts(xd, params):
    """(E, C, d) rows through every expert's SwiGLU FFN (plain PyTorch)."""
    h = torch.einsum("ecd,edf->ecf", xd, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xd, params["w_up"])
    return torch.einsum("ecf,efd->ecd", F.silu(h) * u, params["w_down"])


# ----------------------------------------------------------------- dispatch
def moe_dense(cfg: ModelConfig, params, x) -> Tuple[torch.Tensor, dict]:
    """Exact dense dispatch.  x: (N, d)."""
    topk_idx, topk_gate, aux = _route_aux(cfg, params, x)
    n, e = x.shape[0], cfg.num_experts
    gates = torch.zeros((n, e), dtype=x.dtype, device=x.device)
    gates[torch.arange(n, device=x.device)[:, None], topk_idx] = topk_gate.to(x.dtype)
    wg, wu, wd = (params[k][:e] for k in ("w_gate", "w_up", "w_down"))
    h = torch.einsum("nd,edf->enf", x, wg)
    u = torch.einsum("nd,edf->enf", x, wu)
    y = torch.einsum("enf,efd->end", F.silu(h) * u, wd)
    return torch.einsum("end,ne->nd", y, gates), aux


def _slot_assignment(cfg: ModelConfig, topk_idx, topk_gate, cap: int):
    """(token -> slot) placement under per-expert capacity ``cap``: the
    (token, rank) pairs take their expert's slots in token-major order.

    Returns flat ``slot_token`` (Ep*C,) token index feeding each slot,
    ``slot_gate`` / ``slot_valid`` (Ep*C,) and per-(token, rank) ``kept``
    (N*k,).  Slots of padded experts (index >= num_experts) stay empty."""
    n, k = topk_idx.shape
    e, ep = cfg.num_experts, cfg.num_experts_padded
    dev = topk_idx.device
    flat_expert = topk_idx.reshape(-1).long()                            # (N*k,)
    onehot = F.one_hot(flat_expert, e)                                   # (N*k, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1        # 0-based
    kept = pos < cap
    slot = torch.where(kept, flat_expert * cap + pos, ep * cap)          # ep*cap: dropped
    token_of = torch.arange(n, device=dev).repeat_interleave(k)
    slot_token = torch.zeros((ep * cap + 1,), dtype=torch.int32, device=dev)
    slot_gate = torch.zeros((ep * cap + 1,), dtype=topk_gate.dtype, device=dev)
    slot_valid = torch.zeros((ep * cap + 1,), dtype=torch.bool, device=dev)
    slot_token[slot] = token_of.to(torch.int32)
    slot_gate[slot] = topk_gate.reshape(-1)
    slot_valid[slot] = True
    return slot_token[:-1], slot_gate[:-1], slot_valid[:-1], kept


def moe_scatter(cfg: ModelConfig, params, x, cap_factor: float = None
                ) -> Tuple[torch.Tensor, dict]:
    """Capacity-based gather/GEMM/scatter dispatch.  x: (N, d)."""
    n, d = x.shape
    topk_idx, topk_gate, aux = _route_aux(cfg, params, x)
    cap = capacity(cfg, n, cap_factor)
    ep = cfg.num_experts_padded
    slot_token, slot_gate, slot_valid, kept = _slot_assignment(cfg, topk_idx, topk_gate, cap)
    valid = slot_valid[:, None].to(x.dtype)
    xd = (x[slot_token.long()] * valid).reshape(ep, cap, d)
    y = _swiglu_experts(xd, params).reshape(ep * cap, d) * slot_gate[:, None].to(x.dtype)
    out = torch.zeros_like(x).index_add_(0, slot_token.long(), y * valid)
    aux["drop_fraction"] = 1.0 - kept.float().mean()
    aux["kept"] = kept.reshape(n, cfg.top_k)
    return out, aux


def moe_einsum(cfg: ModelConfig, params, x, cap_factor: float = None
               ) -> Tuple[torch.Tensor, dict]:
    """GShard one-hot dispatch/combine einsums.  x: (N, d).  The combine
    tensor is (N, E, C): the reference's arithmetic, kept as it is."""
    n, d = x.shape
    topk_idx, topk_gate, aux = _route_aux(cfg, params, x)
    cap = capacity(cfg, n, cap_factor)
    ep, k = cfg.num_experts_padded, cfg.top_k
    expert_oh = F.one_hot(topk_idx.long(), ep).float()                   # (N, k, E)
    pos = torch.cumsum(expert_oh.reshape(n * k, ep), dim=0).reshape(n, k, ep)
    pos = (pos - 1.0) * expert_oh                                        # 0-based
    kept = (pos < cap) & (expert_oh > 0)
    sel = expert_oh * kept.float()
    # over-capacity pairs index slot 0 here; ``sel`` zeroes them, where the
    # reference's one_hot of an index past C is a zero row
    pos_oh = F.one_hot(torch.where(kept, pos, 0.0).long(), cap).float()   # (N, k, E, C)
    dispatch = torch.einsum("nke,nkec->nec", sel, pos_oh)
    combine = torch.einsum("nk,nke,nkec->nec", topk_gate.float(), sel, pos_oh)
    xd = torch.einsum("nd,nec->ecd", x.float(), dispatch).to(x.dtype)
    y = _swiglu_experts(xd, params)
    out = torch.einsum("ecd,nec->nd", y.float(), combine).to(x.dtype)
    aux["drop_fraction"] = 1.0 - (kept.sum(dim=(1, 2)).float() / k).mean()
    aux["kept"] = kept.any(dim=-1)
    return out, aux


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


def _moe_grouped_aux(cfg: ModelConfig, params, x) -> Tuple[torch.Tensor, dict]:
    out, topk_idx = moe_grouped(cfg, params, x)
    return out, {"load_balance_loss": load_balance_loss(cfg, params, x, topk_idx),
                 "topk_idx": topk_idx}


DISPATCH = {"dense": moe_dense, "scatter": moe_scatter, "einsum": moe_einsum,
            "grouped": _moe_grouped_aux}


def moe_ff(cfg: ModelConfig, params, x2d, method="scatter",
           cap_factor: float = None) -> Tuple[torch.Tensor, dict]:
    """``method`` is a dispatch name or a callable ``(cfg, params, x2d) ->
    (out, aux)``; ``cap_factor`` reaches ``scatter`` and ``einsum`` only."""
    if callable(method):
        return method(cfg, params, x2d)
    if method in ("scatter", "einsum"):
        return DISPATCH[method](cfg, params, x2d, cap_factor)
    return DISPATCH[method](cfg, params, x2d)
