"""Serving entry point: the OD-MoE cacheless engine, single-stream mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --tokens 32 --predictor sep --shadow int8 --device cuda

Runs real prefill + decode through ``ODMoEEngine`` (prediction,
on-demand loading, alignment, eviction) on the registry config's
reduced variant, checks the tokens against the dense reference under
the same transport policy, and prints recall, loads, bytes moved,
memory and the measured wall time per decoded token.  Continuous
batching, cluster mode and the modelled decode speed wait (ROADMAP.md
queue 1).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import ODMoEEngine
from repro_torch.device import resolve_device
from repro_torch.kernels.moe_gemm import moe_ffn_kernel
from repro_torch.models import greedy_generate, init_params
from repro_torch.quant import UniformPolicy


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--tokens", type=int, default=24, help="decode length")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--predictor", default="sep",
                    choices=["sep", "nextgate", "multigate", "freq", "random",
                             "none"])
    ap.add_argument("--shadow", default="int8", choices=["fp16", "int8", "nf4"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--transport-precision", default="fp32",
                    choices=["fp32", "fp16", "int8", "nf4"],
                    help="on-demand expert wire precision")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_single(cfg, params, args) -> dict:
    """Decode one random prompt with the engine and with the dense
    reference; print the comparison and the engine's accounting.
    Returns the tokens, the engine, its trace and the kernel launches
    of each side."""
    device = params["embed"]["table"].device
    gen = torch.Generator().manual_seed(args.seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, args.prompt_len),
                                     generator=gen, dtype=torch.int32).to(device)}
    transport = UniformPolicy(args.transport_precision)
    launches0 = moe_ffn_kernel.launches
    eng = ODMoEEngine(cfg, params, n_workers=args.workers,
                      predictor=args.predictor, shadow_scheme=args.shadow,
                      seed=args.seed, transport=transport, device=device)
    _sync(device)
    t0 = time.perf_counter()
    toks, trace = eng.generate(batch, args.tokens)
    _sync(device)
    t_engine = time.perf_counter() - t0
    launches1 = moe_ffn_kernel.launches
    ref = greedy_generate(cfg, params, batch, args.tokens, transport=transport)
    launches2 = moe_ffn_kernel.launches
    exact = torch.equal(toks.cpu(), ref.cpu())
    print(f"  tokens == dense reference (same transport policy): {exact}")
    if not exact:
        raise AssertionError("engine output diverged from the reference")
    rec = trace.recall()
    print(f"  recall (Eq.3): {'n/a (no predictions)' if rec is None else f'{rec:.4f}'}"
          f"   reload fraction: {trace.reload_fraction():.4f}")
    print(f"  loads: {eng.slots.stats}")
    print(f"  bytes moved [{eng.transport.describe()}]: {eng.slots.bytes_moved} "
          f"({eng.slots.bytes_moved / 1e9:.3f} GB over "
          f"{eng.slots.stats['loads']} loads)")
    mem = eng.memory_report()
    print("  memory: " + ", ".join(f"{k}={v / 1e6:.2f}MB" for k, v in mem.items()
                                   if k.endswith("bytes")))
    steps = [r.seconds for r in trace.records]
    if steps:
        print(f"  measured wall time per decoded token on {device}: "
              f"mean {statistics.mean(steps) * 1e3:.3f} ms, median "
              f"{statistics.median(steps) * 1e3:.3f} ms over {len(steps)} tokens "
              f"(generate total {t_engine:.3f} s, prefill included)")
    print(f"  moe_ffn kernel launches: engine+shadow {launches1 - launches0}, "
          f"reference {launches2 - launches1}")
    return {"tokens": toks, "reference": ref, "engine": eng, "trace": trace,
            "launches_engine": launches1 - launches0,
            "launches_reference": launches2 - launches1,
            "step_seconds": steps}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if not cfg.num_experts:
        raise SystemExit(f"{args.arch} has no experts: OD-MoE loading does "
                         "not apply")
    params = init_params(cfg, seed=args.seed, device=device)
    print(f"[serve] {cfg.name} on {device}: E={cfg.num_experts} top{cfg.top_k}, "
          f"{args.workers} workers, predictor={args.predictor}"
          + (f"/{args.shadow}" if args.predictor == "sep" else "")
          + f", transport={args.transport_precision} — single stream")
    serve_single(cfg, params, args)


if __name__ == "__main__":
    main()
