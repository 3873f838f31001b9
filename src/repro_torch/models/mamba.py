"""Mamba2 (SSD, state-space duality) mixer.  [arXiv:2405.21060]

The port of ``repro.models.mamba``, function for function, with the same
parameter names and state layout ``{"h": (B,H,P,N) fp32, "conv": (B,
d_conv-1, d_inner+2N)}``.  Sequence mode is the chunked dual form: an
attention-like intra-chunk term (plain products) plus the inter-chunk
recurrence over chunk states, which runs through
``kernels.ssd_scan.ssd_scan`` on both devices (the hand-written kernel on
the card, its plain version on the host).  Decode mode is the one-token
recurrence on the persistent state.

Projections are split (w_z / w_x / w_B / w_C / w_dt, one depthwise conv
each) and ngroups is 1, as in the reference.  The SSD runs in fp32; the
conv, ``y * silu(z)`` and the norm run in the model dtype, rounded where
the reference rounds.  Notation: H = ssm heads, P = head dim, N = ssm
state size, Q = chunk.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.rows import row_blocks

from .config import ModelConfig
from .layers import dense_init, rms_norm

NEG_INF = -1e30


# --------------------------------------------------------------------- init
def init_mamba(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    return {
        "w_z": dense_init(gen, (d, di), dtype, device=device),
        "w_x": dense_init(gen, (d, di), dtype, device=device),
        "w_B": dense_init(gen, (d, ns), dtype, device=device),
        "w_C": dense_init(gen, (d, ns), dtype, device=device),
        "w_dt": dense_init(gen, (d, nh), dtype, device=device),
        "conv_x_w": dense_init(gen, (k, di), dtype, scale=0.5, device=device),
        "conv_x_b": full(di, 0.0),
        "conv_B_w": dense_init(gen, (k, ns), dtype, scale=0.5, device=device),
        "conv_B_b": full(ns, 0.0),
        "conv_C_w": dense_init(gen, (k, ns), dtype, scale=0.5, device=device),
        "conv_C_b": full(ns, 0.0),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(dtype),
        "dt_bias": full(nh, -2.0),              # softplus(-2) ~ 0.13
        "D": full(nh, 1.0),
        "norm": {"scale": full(di, 1.0)},
        "out_proj": dense_init(gen, (di, d), dtype, device=device),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    nh, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {"h": torch.zeros((batch, nh, p, n), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                device=device)}


# ------------------------------------------------------------------ helpers
def _causal_conv(w, b, u):
    """Depthwise causal conv over (B, T, C), kernel size k, written as the
    reference writes it: a sum of k shifted products (no cuDNN, whose fp32
    convolutions run in TF32 by default)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + u.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _conv_step(w, b, state, u_t):
    """One-token causal conv.  state: (B, k-1, C); u_t: (B, C)."""
    window = torch.cat([state, u_t[:, None]], dim=1)           # (B,k,C)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return F.silu(out), window[:, 1:]


def _gates(cfg: ModelConfig, params, dt_raw):
    """dt (B,...,H) -> (dt, log_a) with a = exp(dt * -exp(A_log))."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    log_a = dt * (-torch.exp(params["A_log"].float()))
    return dt, log_a


def _split_conv_state(cfg: ModelConfig, conv):
    di, ns = cfg.d_inner, cfg.ssm_state
    return conv[..., :di], conv[..., di:di + ns], conv[..., di + ns:]


# --------------------------------------------------------------- sequence
def mamba_seq(cfg: ModelConfig, params, x, initial_state: dict = None
              ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence SSD.  x: (B, T, d); chunk padding handled.  As in the
    reference, ``initial_state`` seeds the scan's ``h`` only (the conv
    starts from zeros)."""
    b, t, _ = x.shape
    nh, p, n, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    q = min(q, t)
    pad = (-t) % q
    z = x @ params["w_z"]
    x_raw = x @ params["w_x"]
    B_raw = x @ params["w_B"]
    C_raw = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]
    xs = _causal_conv(params["conv_x_w"], params["conv_x_b"], x_raw)
    B = _causal_conv(params["conv_B_w"], params["conv_B_b"], B_raw)
    C = _causal_conv(params["conv_C_w"], params["conv_C_b"], C_raw)
    if pad:
        xs, B, C, dt_raw = (F.pad(v, (0, 0, 0, pad)) for v in (xs, B, C, dt_raw))
    tt = t + pad
    nc = tt // q
    xh = xs.reshape(b, nc, q, nh, p).float()
    Bc = B.reshape(b, nc, q, n).float()
    Cc = C.reshape(b, nc, q, n).float()
    dt, log_a = _gates(cfg, params, dt_raw.reshape(b, nc, q, nh))
    if pad:
        # padded steps are identity transitions (dt = 0 -> a = 1, nothing
        # injected); otherwise h_last would be corrupted
        step_valid = (torch.arange(tt, device=x.device) < t).reshape(1, nc, q, 1)
        dt = dt * step_valid
        log_a = log_a * step_valid
    seg = torch.cumsum(log_a, dim=2)                               # (B,nc,Q,H)

    # ---- intra-chunk (attention-like dual form)
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]            # (B,nc,Q,S,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], rel, NEG_INF))
    del rel
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    m = cb[..., None] * decay * dt[:, :, None, :, :]               # (B,nc,Q,S,H)
    del decay
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", m, xh)
    del m

    # ---- chunk boundary states
    tail = seg[:, :, -1:, :] - seg                                 # decay to end
    s_chunk = torch.einsum("bcsh,bcsn,bcshp->bchpn", dt * torch.exp(tail), Bc, xh)
    chunk_decay = torch.exp(seg[:, :, -1, :])                      # (B,nc,H)

    # ---- inter-chunk recurrence over the chunk index (the ssd_scan kernel)
    h0 = initial_state["h"].float().contiguous() if initial_state is not None else None
    h_in, h_last = ssd_scan(s_chunk.contiguous(), chunk_decay.contiguous(), h0)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_in) * torch.exp(seg)[..., None]

    y = (y_intra + y_inter).reshape(b, tt, nh * p)[:, :t]
    y = y + (params["D"].float()[None, None, :, None]
             * xh.reshape(b, tt, nh, p)[:, :t]).reshape(b, t, nh * p)
    y = rms_norm(y.to(x.dtype) * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    k = cfg.ssm_conv
    # conv state = the last k-1 pre-conv channel inputs (short prompts
    # left-padded with zeros)
    raw = torch.cat([x_raw, B_raw, C_raw], dim=-1)
    padded = F.pad(raw, (0, 0, k - 1, 0))
    conv_state = padded[:, padded.shape[1] - (k - 1):]
    return out, {"h": h_last, "conv": conv_state.to(x.dtype).contiguous()}


# ----------------------------------------------------------------- decode
def mamba_decode(cfg: ModelConfig, params, x, state: dict) -> Tuple[torch.Tensor, dict]:
    """One-token recurrence.  x: (B, 1, d).

    Every step of it is row-local, so it runs whole in fixed row blocks
    (``rows.row_blocks``) with the state tensors as extra inputs: the five
    projections, the conv step's reduction, the ``C . h`` reduction, the
    gated norm and ``out_proj`` then see the same shapes whatever B is,
    and a row's bits do not depend on the rows beside it."""
    nh, p = cfg.ssm_heads, cfg.ssm_head_dim

    def rows(x, h, conv):
        b = x.shape[0]
        x0 = x[:, 0]
        z = x0 @ params["w_z"]
        x_raw = x0 @ params["w_x"]
        B_raw = x0 @ params["w_B"]
        C_raw = x0 @ params["w_C"]
        dt_raw = x0 @ params["w_dt"]
        cx, cB, cC = _split_conv_state(cfg, conv)
        xs, cx = _conv_step(params["conv_x_w"], params["conv_x_b"], cx, x_raw)
        B, cB = _conv_step(params["conv_B_w"], params["conv_B_b"], cB, B_raw)
        C, cC = _conv_step(params["conv_C_w"], params["conv_C_b"], cC, C_raw)
        conv = torch.cat([cx, cB, cC], dim=-1)
        xh = xs.reshape(b, nh, p).float()
        dt, log_a = _gates(cfg, params, dt_raw)
        a = torch.exp(log_a)                                       # (B,H)
        h = h * a[..., None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, B.float(), xh)
        y = torch.einsum("bn,bhpn->bhp", C.float(), h)
        y = y + params["D"].float()[None, :, None] * xh
        y = y.reshape(b, nh * p).to(x.dtype) * F.silu(z)
        y = rms_norm(y, params["norm"], cfg.norm_eps)
        return (y @ params["out_proj"])[:, None], h, conv

    out, h, conv = row_blocks(rows, x, state["h"], state["conv"])
    return out, {"h": h, "conv": conv}
