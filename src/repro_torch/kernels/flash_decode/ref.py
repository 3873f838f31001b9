"""Plain PyTorch version of single-token GQA decode attention."""
import torch

NEG_INF = -1e30


def flash_decode_ref(q, k, v, kpos, pos, window: int = 0, soft_cap: float = 0.0):
    """q: (B,K,G,Hd); k/v: (B,W,K,Hd); kpos: (B,W); pos: (B,) -> (B,K,G,Hd) fp32.

    ``soft_cap`` (0 = none) caps the scores as ``models.attention`` does
    for configs that set ``logit_soft_cap``; the kernel has no cap."""
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bwkh->bkgw", q.float(),
                     k.float()) / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window:
        valid = valid & (pos[:, None] - kpos < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgw,bwkh->bkgh", p, v.float())
