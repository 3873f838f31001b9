"""Plain PyTorch version of the Mamba2 inter-chunk state recurrence."""
import torch


def ssd_scan_ref(s, decay, h0=None):
    """s: (B,NC,H,P,N); decay: (B,NC,H); h0: (B,H,P,N) or None (zeros)
    -> (h_in (B,NC,H,P,N), h_last (B,H,P,N)), fp32.

    ``h_in[:, c]`` is the state entering chunk ``c``; each step is
    ``decay * h + s``, two separately rounded operations."""
    s, decay = s.float(), decay.float()
    b, nc, h, p, n = s.shape
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=s.device)
             if h0 is None else h0.float())
    h_in = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=s.device)
    for c in range(nc):
        h_in[:, c] = state
        state = decay[:, c, :, None, None] * state + s[:, c]
    return h_in, state
