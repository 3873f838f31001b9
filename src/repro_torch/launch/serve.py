"""Serving entry point: the OD-MoE cacheless engine, single-stream mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --tokens 32 --predictor sep --shadow int8 --device cuda

  PYTHONPATH=src python -m repro_torch.launch.serve --packed-slots \
      --transport-precision tiered

Runs real prefill + decode through ``ODMoEEngine`` (prediction,
on-demand loading, alignment, eviction) on the registry config's
reduced variant, checks the tokens against the dense reference under
the same transport policy, and prints recall, loads, bytes moved,
memory and the measured wall time per decoded token, then the decode
speed the timing model gives for the paper's testbed (a model, never a
measurement).  ``--packed-slots`` keeps wire-format experts in the
worker slots and computes them with the in-register-dequant kernel.
Continuous batching and cluster mode wait (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import RTX3090_EDGE, ODMoEEngine, simulate_cached, simulate_odmoe
from repro_torch.device import resolve_device
from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_packed_kernel
from repro_torch.models import greedy_generate, init_params
from repro_torch.quant import TieredPolicy, UniformPolicy


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
                    choices=["fp32", "fp16", "int8", "nf4", "tiered"],
                    help="on-demand expert wire precision; 'tiered' calibrates a "
                         "confidence-tiered fp16+int8 policy from a short decode")
    ap.add_argument("--packed-slots", action="store_true",
                    help="packed-resident worker slots: keep the wire-format codes "
                         "and scales resident and dequantize in registers inside "
                         "the grouped kernel (same tokens, smaller slots)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prompt(cfg, prompt_len: int, seed: int, device) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                                    dtype=torch.int32).to(device)}


def build_transport(cfg, params, args):
    """--transport-precision as a ``PrecisionPolicy``.  'tiered' runs a
    short calibration decode (prompt from seed + 1, no predictor) and
    tiers the experts by mean gate weight: low confidence ships int8,
    the rest fp16."""
    if args.transport_precision != "tiered":
        return UniformPolicy(args.transport_precision)
    device = params["embed"]["table"].device
    eng = ODMoEEngine(cfg, params, n_workers=args.workers, predictor="none",
                      device=device)
    _, trace = eng.generate(_prompt(cfg, args.prompt_len, args.seed + 1, device),
                            max(8, args.tokens // 2))
    del eng
    pol = TieredPolicy.from_trace(trace, low_fraction=0.5, num_experts=cfg.num_experts)
    print(f"  transport: calibrated {pol.describe()}")
    return pol


def print_transport_stats(eng) -> None:
    """Codec accounting from the load-event log: what crossed the links
    against the fp32 deployment payload of the same loads."""
    ev = eng.slots.events
    if not ev:
        return
    by_scheme = {}
    for e in ev:
        n, b = by_scheme.get(e.scheme, (0, 0))
        by_scheme[e.scheme] = (n + 1, b + e.bytes)
    fp32_equiv = len(ev) * eng.store.expert_bytes
    moved = eng.slots.bytes_moved
    print(f"  transport [{eng.transport.describe()}]: {moved / 1e6:.2f} MB moved vs "
          f"{fp32_equiv / 1e6:.2f} MB full width ({fp32_equiv / max(moved, 1):.2f}x "
          f"reduction)")
    print("  loads by scheme: " + ", ".join(
        f"{s}={n} ({b / 1e6:.2f} MB)" for s, (n, b) in sorted(by_scheme.items())))


def serve_single(cfg, params, args) -> dict:
    """Decode one random prompt with the engine and with the dense
    reference; print the comparison and the engine's accounting.
    Returns the tokens, the engine, its trace, the transport policy and
    the launches of each kernel on each side."""
    device = params["embed"]["table"].device
    batch = _prompt(cfg, args.prompt_len, args.seed, device)
    transport = build_transport(cfg, params, args)
    kernels = (moe_ffn_kernel, moe_ffn_packed_kernel)
    launches0 = [k.launches for k in kernels]
    eng = ODMoEEngine(cfg, params, n_workers=args.workers,
                      predictor=args.predictor, shadow_scheme=args.shadow,
                      seed=args.seed, transport=transport, device=device,
                      packed_slots=args.packed_slots)
    _sync(device)
    t0 = time.perf_counter()
    toks, trace = eng.generate(batch, args.tokens)
    _sync(device)
    t_engine = time.perf_counter() - t0
    launches1 = [k.launches for k in kernels]
    ref = greedy_generate(cfg, params, batch, args.tokens, transport=transport)
    launches2 = [k.launches for k in kernels]
    engine_launches = [b - a for a, b in zip(launches0, launches1)]
    reference_launches = [b - a for a, b in zip(launches1, launches2)]
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
    print_transport_stats(eng)
    mem = eng.memory_report()
    print("  memory: " + ", ".join(f"{k}={v / 1e6:.2f}MB" for k, v in mem.items()
                                   if k.endswith("bytes")))
    steps = [r.seconds for r in trace.records]
    if steps:
        print(f"  measured wall time per decoded token on {device}: "
              f"mean {statistics.mean(steps) * 1e3:.3f} ms, median "
              f"{statistics.median(steps) * 1e3:.3f} ms over {len(steps)} tokens "
              f"(generate total {t_engine:.3f} s, prefill included)")
    print(f"  moe_ffn kernel launches: engine+shadow {engine_launches[0]}, "
          f"reference {reference_launches[0]}")
    print(f"  moe_ffn_packed kernel launches: engine+shadow {engine_launches[1]}, "
          f"reference {reference_launches[1]}")
    timings = simulate_odmoe(cfg, trace, eng.sched, RTX3090_EDGE, shadow_scheme=args.shadow,
                             predictor=args.predictor, transport=transport)
    modelled = timings.tokens_per_s if trace.records else None
    if modelled is not None:
        line = (f"  modelled ({RTX3090_EDGE.name} profile, not measured): decode "
                f"{modelled:.2f} tok/s (fully-cached reference "
                f"{simulate_cached(cfg, RTX3090_EDGE):.2f})")
        if args.packed_slots:
            packed = simulate_odmoe(cfg, trace, eng.sched, RTX3090_EDGE,
                                    shadow_scheme=args.shadow, predictor=args.predictor,
                                    transport=transport, packed_compute=True)
            line += f"; with packed worker compute {packed.tokens_per_s:.2f} tok/s"
        print(line)
    return {"tokens": toks, "reference": ref, "engine": eng, "trace": trace,
            "transport": transport,
            "launches_engine": engine_launches[0],
            "launches_reference": reference_launches[0],
            "packed_launches_engine": engine_launches[1],
            "packed_launches_reference": reference_launches[1],
            "modelled_tok_s": modelled, "step_seconds": steps}


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
          + f", transport={args.transport_precision}"
          + (", packed slots" if args.packed_slots else "") + " — single stream")
    serve_single(cfg, params, args)


if __name__ == "__main__":
    main()
