"""Public wrappers for the grouped expert FFN.

``moe_ffn`` is the raw (E, C, D) -> (E, C, D) grouped GEMM: the CUDA
kernel for tensors on the card, the plain PyTorch version for tensors
on the host.  There is no fallback between them: a CUDA tensor goes
through the kernel or the call raises.

``grouped_topk_contrib`` / ``combine_topk`` are the port's one expert-FFN
hot path: the OD-MoE engine's wave compute, the reference
``moe_grouped`` dispatch and the SEP shadow all reach the kernel
through them, so engine and reference consume identical arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import moe_ffn_kernel
from .ref import moe_ffn_ref


def moe_ffn(xd, w_gate, w_up, w_down):
    """Grouped expert FFN: kernel on CUDA tensors, plain version on CPU
    tensors."""
    if xd.device.type == "cuda":
        return moe_ffn_kernel(xd, w_gate, w_up, w_down)
    if xd.device.type == "cpu":
        return moe_ffn_ref(xd, w_gate, w_up, w_down)
    raise ValueError(f"no grouped FFN for device {xd.device}")


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


def _grouped_contrib(h, w_gate, w_up, w_down, slot, gates):
    """Body of :func:`grouped_topk_contrib` (rows already padded).

    The stacked-expert axis pads to its pow2 bucket here; padded
    experts are all-zero and never selected by ``slot``."""
    x32 = h.float()
    n = x32.shape[0]
    ep = _pow2(max(w_gate.shape[0], 1))
    w_gate, w_up, w_down = (_pad_expert_axis(w, ep) for w in (w_gate, w_up, w_down))
    xd = x32.unsqueeze(0).expand((ep,) + tuple(x32.shape)).contiguous()
    y = moe_ffn(xd, w_gate, w_up, w_down)              # (Ep, N, d) fp32
    valid = slot >= 0
    safe = torch.where(valid, slot, torch.zeros_like(slot)).long()
    rows = torch.arange(n, device=h.device)[:, None]   # (N, 1)
    picked = y[safe, rows]                             # (N, k, d)
    return torch.where(valid[..., None], gates.float()[..., None] * picked,
                       torch.zeros((), dtype=torch.float32, device=h.device))


def grouped_topk_contrib(h, w_gate, w_up, w_down, slot, gates):
    """Gate-weighted expert-FFN contributions for a routed top-k batch.

    ``h``: (N, d) rows; ``w_gate``/``w_up``: (Es, d, f) and ``w_down``:
    (Es, f, d) stacked expert weights; ``slot``: (N, k) integer index of
    each (row, rank) pair's expert in the stacked axis, ``-1`` when that
    expert is not part of this call; ``gates``: (N, k).  Returns
    (N, k, d) fp32 contributions, exact zeros at masked pairs.  Each
    pair's value does not depend on which other experts or rows rode
    along, so wave partitioning never changes a request's arithmetic.

    The row axis pads to its pow2 bucket here (cheap: h/slot/gates
    only); the expert axis pads inside ``_grouped_contrib``.
    """
    n = slot.shape[0]
    np_ = _pow2(max(n, 1))
    if np_ != n:
        h = F.pad(h, (0, 0, 0, np_ - n))
        slot = F.pad(slot, (0, 0, 0, np_ - n), value=-1)
        gates = F.pad(gates, (0, 0, 0, np_ - n))
    out = _grouped_contrib(h, w_gate, w_up, w_down, slot, gates)
    return out[:n] if np_ != n else out


def combine_topk(contrib):
    """Reduce (N, k, d) contributions to (N, d) in fixed top-k rank
    order — the accumulation order every decode path shares."""
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y
