"""Plain PyTorch version of the grouped expert FFN."""
import torch
import torch.nn.functional as F

from repro_torch.rows import row_blocks


def moe_ffn_ref(xd, w_gate, w_up, w_down):
    """xd: (E, C, D) -> (E, C, D) in fp32.

    One product per expert and per block of rows (``rows.row_blocks``),
    each of the same ``(ROW_BLOCK, D) @ (D, F)`` shape whatever ``E`` and
    ``C`` are: a product may pick another algorithm for another shape, and
    a (row, expert) output must not depend on how many experts or rows
    rode with it (engine waves stack one or two experts, the reference all
    of them; a composed decode batch has more rows than a solo one)."""
    x32 = xd.float()
    out = []
    for e in range(x32.shape[0]):
        wg, wu, wd = w_gate[e].float(), w_up[e].float(), w_down[e].float()
        out.append(row_blocks(lambda xb: (F.silu(xb @ wg) * (xb @ wu)) @ wd, x32[e]))
    return torch.stack(out)
