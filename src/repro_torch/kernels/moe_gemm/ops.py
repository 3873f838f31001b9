"""Public wrappers for the grouped expert FFN.

``moe_ffn`` is the raw (E, C, D) -> (E, C, D) grouped GEMM and
``moe_ffn_packed`` its twin on wire-format weights: the CUDA kernel for
tensors on the card, the plain PyTorch version for tensors on the host.
There is no fallback between them: a CUDA tensor goes through the
kernel or the call raises.

``grouped_topk_contrib`` / ``combine_topk`` are the port's one expert-FFN
hot path: the OD-MoE engine's wave compute, the reference
``moe_grouped`` dispatch and the SEP shadow all reach the kernel
through them, so engine and reference consume identical arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import moe_ffn_kernel
from .packed import moe_ffn_packed_kernel, moe_ffn_packed_ref
from .ref import moe_ffn_ref


def moe_ffn(xd, w_gate, w_up, w_down):
    """Grouped expert FFN: kernel on CUDA tensors, plain version on CPU
    tensors."""
    if xd.device.type == "cuda":
        return moe_ffn_kernel(xd, w_gate, w_up, w_down)
    if xd.device.type == "cpu":
        return moe_ffn_ref(xd, w_gate, w_up, w_down)
    raise ValueError(f"no grouped FFN for device {xd.device}")


def moe_ffn_packed(xd, parts, *, scheme: str):
    """Grouped expert FFN on stacked wire-format parts (``parts`` maps
    w_gate/w_up/w_down to device-layout part tuples with a leading expert
    axis): the in-register-dequant kernel on CUDA tensors, dequantize +
    plain version on CPU tensors.  ``scheme == "fp32"`` parts are the
    full-width weights and go to :func:`moe_ffn`
    (``repro.kernels.moe_gemm.ops.moe_ffn_packed``)."""
    if scheme == "fp32":
        return moe_ffn(xd, parts["w_gate"][0], parts["w_up"][0], parts["w_down"][0])
    if xd.device.type == "cuda":
        return moe_ffn_packed_kernel(xd, parts, scheme=scheme)
    if xd.device.type == "cpu":
        return moe_ffn_packed_ref(xd, parts, scheme=scheme)
    raise ValueError(f"no packed grouped FFN for device {xd.device}")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_expert_axis(w, ep: int):
    es = w.shape[0]
    if ep == es:
        return w
    return torch.cat([w, w.new_zeros((ep - es,) + tuple(w.shape[1:]))])


def _gather_gated(h, y, slot, gates):
    """(Ep, N, d) expert outputs -> gate-weighted (N, k, d) contributions,
    exact zeros where ``slot`` is -1."""
    valid = slot >= 0
    safe = torch.where(valid, slot, torch.zeros_like(slot)).long()
    rows = torch.arange(slot.shape[0], device=h.device)[:, None]   # (N, 1)
    picked = y[safe, rows]                                         # (N, k, d)
    return torch.where(valid[..., None], gates.float()[..., None] * picked,
                       torch.zeros((), dtype=torch.float32, device=h.device))


def _broadcast_rows(h, ep: int):
    x32 = h.float()
    return x32.unsqueeze(0).expand((ep,) + tuple(x32.shape)).contiguous()


def _grouped_contrib(h, w_gate, w_up, w_down, slot, gates):
    """Body of :func:`grouped_topk_contrib` (rows already padded).

    The stacked-expert axis pads to its pow2 bucket here; padded
    experts are all-zero and never selected by ``slot``."""
    ep = _pow2(max(w_gate.shape[0], 1))
    w_gate, w_up, w_down = (_pad_expert_axis(w, ep) for w in (w_gate, w_up, w_down))
    y = moe_ffn(_broadcast_rows(h, ep), w_gate, w_up, w_down)    # (Ep, N, d) fp32
    return _gather_gated(h, y, slot, gates)


def _grouped_contrib_packed(h, parts, slot, gates, *, scheme: str):
    """Packed twin of :func:`_grouped_contrib`: the same pad, gather, mask
    and gate arithmetic around :func:`moe_ffn_packed`.  Zero-padded
    experts dequantize to zero weights and are never selected."""
    ep = _pow2(max(parts["w_gate"][0].shape[0], 1))
    parts = {name: tuple(_pad_expert_axis(p, ep) for p in ps) for name, ps in parts.items()}
    y = moe_ffn_packed(_broadcast_rows(h, ep), parts, scheme=scheme)
    return _gather_gated(h, y, slot, gates)


# Expert-rows per grouped-FFN call.  Every (padded) expert runs every row
# of a call, and the kernel's workspace grows with experts x rows.  On fp32
# weights (and the packed kernel, which shares their passes) that is hu,
# 57 KB per expert-row at D=4096, F=14336, and at 16 rows or fewer the
# segment partials too, about 2.7 MB per expert-row: a longer row set runs
# in blocks of ``MAX_EXPERT_ROWS // experts`` rows (64 for 16 experts, 128
# for 8), and each further block reads every expert's weights again.  On
# bf16 weights the workspace holds only x's and hu's split terms, about 74 KB per
# expert-row at that width, so a block is ``MAX_EXPERT_ROWS_BF16 //
# experts`` rows (1024 for 16 experts: a Jamba prompt of up to 1024 tokens
# is one call, 1.2 GB of workspace).  A row's bits depend on neither the
# kernel's nor the plain version's row count, so the split changes no bit.
MAX_EXPERT_ROWS = 1024
MAX_EXPERT_ROWS_BF16 = 16384


def _row_budget(dtype) -> int:
    return MAX_EXPERT_ROWS_BF16 if dtype == torch.bfloat16 else MAX_EXPERT_ROWS


def _row_chunks(fn, h, slot, gates, experts: int, budget: int):
    """``fn(h, slot, gates)`` over blocks of at most ``budget //
    pow2(experts)`` rows."""
    n, step = slot.shape[0], max(1, budget // _pow2(max(experts, 1)))
    if n <= step:
        return fn(h, slot, gates)
    return torch.cat([fn(h[i:i + step], slot[i:i + step], gates[i:i + step])
                      for i in range(0, n, step)])


def _pad_rows(h, slot, gates):
    """Pad the row axis to its pow2 bucket (h/slot/gates only; padded
    rows are masked with slot -1)."""
    n = slot.shape[0]
    np_ = _pow2(max(n, 1))
    if np_ != n:
        h = F.pad(h, (0, 0, 0, np_ - n))
        slot = F.pad(slot, (0, 0, 0, np_ - n), value=-1)
        gates = F.pad(gates, (0, 0, 0, np_ - n))
    return h, slot, gates


def grouped_topk_contrib(h, w_gate, w_up, w_down, slot, gates):
    """Gate-weighted expert-FFN contributions for a routed top-k batch.

    ``h``: (N, d) rows; ``w_gate``/``w_up``: (Es, d, f) and ``w_down``:
    (Es, f, d) stacked expert weights; ``slot``: (N, k) integer index of
    each (row, rank) pair's expert in the stacked axis, ``-1`` when that
    expert is not part of this call; ``gates``: (N, k).  Returns
    (N, k, d) fp32 contributions, exact zeros at masked pairs.  Each
    pair's value does not depend on which other experts or rows rode
    along, so wave partitioning never changes a request's arithmetic.

    Rows run in blocks of at most ``MAX_EXPERT_ROWS // experts``
    (``MAX_EXPERT_ROWS_BF16`` for bf16 weights); a block's row axis pads
    to its pow2 bucket (cheap: h/slot/gates only); the expert axis pads
    inside ``_grouped_contrib``.
    """
    def block(h, slot, gates):
        n = slot.shape[0]
        h, slot, gates = _pad_rows(h, slot, gates)
        return _grouped_contrib(h, w_gate, w_up, w_down, slot, gates)[:n]
    return _row_chunks(block, h, slot, gates, w_gate.shape[0], _row_budget(w_gate.dtype))


def grouped_topk_contrib_packed(h, parts, slot, gates, *, scheme: str):
    """:func:`grouped_topk_contrib` on stacked wire-format parts (what
    ``WorkerSlots.gather_stack_packed`` gives): the same contract and row
    bucketing, and the same per-(row, rank) bits, because in-register
    dequantization is elementwise and exact.  ``scheme == "fp32"`` parts
    are full-width weights and take the full-width path
    (``repro.kernels.moe_gemm.ops.grouped_topk_contrib_packed``)."""
    if scheme == "fp32":
        return grouped_topk_contrib(h, parts["w_gate"][0], parts["w_up"][0],
                                    parts["w_down"][0], slot, gates)

    def block(h, slot, gates):
        n = slot.shape[0]
        h, slot, gates = _pad_rows(h, slot, gates)
        return _grouped_contrib_packed(h, parts, slot, gates, scheme=scheme)[:n]
    return _row_chunks(block, h, slot, gates, parts["w_gate"][0].shape[0], MAX_EXPERT_ROWS)


def combine_topk(contrib):
    """Reduce (N, k, d) contributions to (N, d) in fixed top-k rank
    order — the accumulation order every decode path shares."""
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y
