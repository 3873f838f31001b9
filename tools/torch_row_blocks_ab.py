"""Time the port's dense decode work in one checkout, for an A/B of two trees.

The port's decode step runs its row-local dense work (norms, QKV, ``wo``,
router, dense FF, LM head) in zero-padded blocks of 8 rows, so that a row's
bits do not depend on the batch; ``api.prefill`` pads the prompt to its
pow2 bucket even when the cache is narrower.  This script measures what
that costs, on the card, at Mixtral-8x7B width (bf16, 4 layers,
``padded_experts`` 0, random weights from seed 0, as ``chip_smoke.py``'s
slice phase):

- the single-stream slice: ``serve_single`` with the slice phase's flags,
  TPOT median over the decoded tokens;
- ``decode_step`` alone at B = 1, 4, 16 (B=16 is two row blocks), and
  ``prefill`` at a prompt whose bucket fits the cache and one whose bucket
  is wider than the cache; host clock around work that ends in a
  synchronize, median of 20 after 3 warm-up calls;
- with ``--serve-batch N``, and only where the checkout has the serving
  loop: ``serve_traffic`` on 2N burst requests at max batch N, dense KV,
  and the median composed-step wall time by batch size.

It imports ``repro_torch`` from ``<root>/src`` and builds that checkout's
kernels into ``<root>/build``.  Both checkouts' ``prefill`` must take
``moe_method``: the script asks for the grouped dispatch, the engine's.
To compare two commits, unpack the older one with ``git archive`` into an
ignored directory and run, in one call on the card::

    for r in OLD . . OLD; do python3 tools/torch_row_blocks_ab.py --root $r; done

Add ``--serve-batch 16`` to the runs of the tree that has ``repro_torch.serve``.
``--device cpu --reduced --serve-batch 2`` checks the script on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time


def _median_ms(fn, sync, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose src/repro_torch to time")
    ap.add_argument("--serve-batch", type=int, default=0,
                    help="also serve 2N burst requests at max batch N (0: skip)")
    ap.add_argument("--reduced", action="store_true",
                    help="Mixtral's small fp32 variant (a host check)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, serve_single
    from repro_torch.models import decode_step, init_params, prefill
    if not repro_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {repro_torch.__file__}, not the checkout at {root}")
    dev = torch.device(a.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(cfg.reduced() if a.reduced else cfg, num_layers=4,
                              padded_experts=0)
    params = init_params(cfg, seed=0, device=a.device)
    sync()
    tag = f"[ab {os.path.basename(root) or root}]"
    out = {"root": root}

    flags = ["--prompt-len", "16", "--tokens", "8", "--predictor", "sep", "--shadow", "int8",
             "--transport-precision", "fp32", "--workers", "8", "--seed", "0"]
    if dev.type == "cpu":
        flags += ["--device", "cpu"]
    res = serve_single(cfg, params, build_parser().parse_args(flags))
    if not torch.equal(res["tokens"].cpu(), res["reference"].cpu()):
        raise SystemExit("engine tokens differ from greedy_generate")
    out["tpot_ms"] = statistics.median(res["step_seconds"]) * 1e3
    out["tokens"] = res["tokens"].cpu().tolist()[0]
    print(f"{tag} single stream: TPOT median {out['tpot_ms']:.3f} ms over "
          f"{len(res['step_seconds'])} tokens, loads {res['engine'].slots.stats['loads']}, "
          f"tokens {out['tokens']}", flush=True)
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(1)
    out["decode_step_ms"] = {}
    for b in (1, 4, 16):
        prompt = torch.randint(0, cfg.vocab_size, (b, 16), generator=gen).to(dev)
        _, state = prefill(cfg, params, {"tokens": prompt}, 24, moe_method="grouped")
        tok = prompt[:, -1].contiguous()
        ms = _median_ms(lambda: decode_step(cfg, params, tok, state), sync)
        out["decode_step_ms"][b] = ms
        print(f"{tag} decode_step B={b} (cache 24): {ms:.3f} ms", flush=True)
    out["prefill_ms"] = {}
    for t, cache in ((16, 24), (20, 28)):
        prompt = torch.randint(0, cfg.vocab_size, (1, t), generator=gen).to(dev)
        ms = _median_ms(lambda: prefill(cfg, params, {"tokens": prompt}, cache,
                                        moe_method="grouped"), sync)
        out["prefill_ms"][f"T={t},cache={cache}"] = ms
        print(f"{tag} prefill B=1 T={t} cache {cache}: {ms:.3f} ms", flush=True)

    if a.serve_batch:
        from repro_torch.launch.serve import serve_traffic
        n = a.serve_batch
        sflags = ["--requests", str(2 * n), "--arrival-rate", "0", "--prompt-len", "128",
                  "--tokens", "8", "--max-batch", str(n), "--compose", "overlap",
                  "--predictor", "sep", "--shadow", "int8", "--transport-precision", "fp32",
                  "--workers", "8", "--seed", "0"]
        if dev.type == "cpu":
            sflags += ["--device", "cpu", "--prompt-len", "16"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        served = serve_traffic(cfg, params, build_parser().parse_args(sflags))["result"]
        by_b = {}
        for s in served.steps:
            by_b.setdefault(len(s.request_ids), []).append(s.wall_s * 1e3)
        out["serve_step_ms"] = {b: statistics.median(v) for b, v in sorted(by_b.items())}
        out["serve_step_n"] = {b: len(v) for b, v in sorted(by_b.items())}
        out["serve_mean_batch"] = served.mean_batch
        print(f"{tag} serve {2 * n} burst requests at max batch {n}: every request == "
              f"solo greedy_generate; mean batch {served.mean_batch:.2f}; composed step "
              f"median by B " + ", ".join(f"B={b}: {ms:.3f} ms (n={out['serve_step_n'][b]})"
                                          for b, ms in out["serve_step_ms"].items()),
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
