"""Training entry point of the port: real steps on the card, or on the host
with ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
      --reduced --steps 50 --batch 4 --seq 128 [--device cpu]

``--reduced`` (the default) swaps in the architecture's smoke-scale
variant; ``--full`` trains the registry config at its published widths.
The flags and the printed lines are ``repro.launch.train``'s, plus
``--device`` (the card unless the caller names the CPU).  As there, the
step runs without remat and with one microbatch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticConfig, batch_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, init_opt_state


def build(arch: str, reduced: bool, batch: int, seq: int,
          lr: float, steps: int, moe_method: str):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    data_cfg = SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        frontend_tokens=(seq if cfg.is_encoder_decoder
                         else cfg.frontend_tokens) if cfg.frontend else 0,
        frontend_dim=(cfg.frontend_dim or cfg.d_model) if cfg.frontend else 0)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20), total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, moe_method=moe_method, n_microbatches=1,
                              remat=False)
    return cfg, data_cfg, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--moe-method", default="dense")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, data_cfg, step_fn = build(args.arch, args.reduced, args.batch,
                                   args.seq, args.lr, args.steps,
                                   args.moe_method)
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active), "
          f"batch={args.batch} seq={args.seq}")
    params = init_params(cfg, args.seed, dev)
    opt_state = init_opt_state(params)
    it = batch_iterator(data_cfg)
    losses = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))      # waits for the step
        if step % args.log_every == 0 or step == 1:
            dt = (time.time() - t0) / step
            print(f"  step {step:5d} loss={losses[-1]:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({dt*1e3:.0f} ms/step)")
    first = np.mean(losses[: max(1, len(losses) // 10)])
    last = np.mean(losses[-max(1, len(losses) // 10):])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt_state, args.steps)
        print(f"[train] checkpoint saved to {args.checkpoint}")
    return losses


if __name__ == "__main__":
    main()
