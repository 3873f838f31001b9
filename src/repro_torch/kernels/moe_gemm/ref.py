"""Plain PyTorch version of the grouped expert FFN."""
import torch
import torch.nn.functional as F


def moe_ffn_ref(xd, w_gate, w_up, w_down):
    """xd: (E, C, D) -> (E, C, D) in fp32.

    One product per expert, each of the same ``(C, D) @ (D, F)`` shape
    whatever ``E`` is: a batched product may pick another algorithm for
    another batch count, and an expert's output must not depend on how
    many experts were stacked beside it (engine waves stack one or two,
    the reference all of them)."""
    x32 = xd.float()
    out = []
    for e in range(x32.shape[0]):
        h = F.silu(x32[e] @ w_gate[e].float())
        u = x32[e] @ w_up[e].float()
        out.append((h * u) @ w_down[e].float())
    return torch.stack(out)
