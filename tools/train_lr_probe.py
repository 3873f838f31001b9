"""Held-batch loss of a few AdamW steps at several learning rates, on the
card: how ``chip_smoke.py``'s train-ssm phase chose its rate.

For each rate in ``LRS`` it initialises mamba2-2.7b afresh (seed 0, bf16)
and takes that phase's steps (its batches, microbatches and AdamW
schedule; scatter, per-block remat), printing the loss on its held batch
before the first step and after each one, with each step's loss, grad norm
and time (host clock ending in a synchronize)::

    python3 tools/train_lr_probe.py

The last line is a JSON object of the held losses by rate.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LRS = (1e-3, 3e-4, 1e-4)


def main() -> None:
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state

    cs.phase_card()
    cfg = get_config("mamba2-2.7b")
    held, batches = cs.train_batches(cfg, cs.SSM_BATCH, cs.SSM_SEQ, seed=3)
    out = {}
    for lr in LRS:
        params = init_params(cfg, seed=0, device="cuda")
        opt = init_opt_state(params)
        step = make_train_step(cfg, AdamWConfig(lr=lr, **cs.TRAIN_OPT), moe_method="scatter",
                               n_microbatches=cs.SSM_MICROBATCHES)
        held_losses = [float(cs.held_loss(cfg, params, held))]
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            held_losses.append(float(cs.held_loss(cfg, params, held)))
            print(f"[lr-probe] {cfg.name} lr {lr:g} step {i + 1}: loss {float(m['loss']):.4f}, "
                  f"grad norm {float(m['grad_norm']):.4f}, {dt * 1e3:.1f} ms; held loss "
                  f"{held_losses[-2]:.4f} -> {held_losses[-1]:.4f}", flush=True)
        out[f"{lr:g}"] = held_losses
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"arch": cfg.name, "held_losses": out}))


if __name__ == "__main__":
    main()
