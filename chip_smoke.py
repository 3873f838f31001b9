#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. card    — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile the hand-written grouped expert-FFN kernel
             (``src/repro_torch/csrc/moe_ffn.cu``) with nvcc.
3. kernel  — hold the kernel against its plain PyTorch version at the
             decode path's shapes (D=4096, F=14336, bf16 weights,
             E in {1,2,8}, C in {1,2,16}), check that per-(row, expert)
             outputs are bitwise equal across E and C, and time the
             kernel, its bound, the plain version and a torch.bmm formula.
4. small   — the port's model on the card against its plain CPU path on
             a small fp32 MoE config: logits close, tokens equal.
5. slice   — ``repro_torch.launch.serve.serve_single`` at Mixtral-8x7B
             width (4 layers, no expert padding), SEP int8 shadow, fp32
             transport: engine tokens must equal the port's
             ``greedy_generate`` and the kernel must have launched on both
             sides.  Then each part of a decoded token (one expert load,
             the shadow step, a dense decode step) is timed alone.

The last line is ``{"ok": true, "device": {...}}``; it is printed only
when every phase passed.  The script imports nothing of JAX or of the
JAX package ``repro``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet), used for the bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12          # fp32 outside the tensor cores
D_MODEL, D_EXPERT = 4096, 14336
KERNEL_TOL = 1e-4                 # max|k - p| / max|p|: fp32 sums in two orders


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(f"[card] {line}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from repro_torch.kernels.moe_gemm import kernel
    t0 = time.perf_counter()
    info = kernel.build()
    print(f"[build] {info['path']} built in {info['seconds']:.2f} s "
          f"(phase {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in info["report"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(e: int, c: int, weight_bytes: int) -> tuple:
    """Least time for the grouped FFN: each input read once (x fp32, three
    weight matrices), the output written once, against fp32 FMAs."""
    nbytes = 4 * e * c * D_MODEL * 2 + 3 * e * D_MODEL * D_EXPERT * weight_bytes
    flops = 2 * 3 * e * c * D_MODEL * D_EXPERT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def weight(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5
        return w.to(torch.bfloat16)

    x = torch.randn((16, D_MODEL), generator=gen, device=dev)
    wg = weight((8, D_MODEL, D_EXPERT), D_MODEL)
    wu = weight((8, D_MODEL, D_EXPERT), D_MODEL)
    wd = weight((8, D_EXPERT, D_MODEL), D_EXPERT)
    outs, errs = {}, {}
    for e in (1, 2, 8):
        for c in (1, 2, 16):
            xd = x[:c].expand(e, c, D_MODEL).contiguous()
            k = moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e])
            p = moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e])
            torch.cuda.synchronize()
            if not bool(torch.isfinite(k).all()):
                fail(f"kernel output not finite at E={e} C={c}")
            rel = float((k - p).abs().max() / p.abs().max())
            errs[(e, c)] = (float((k - p).abs().max()), rel)
            print(f"[kernel] E={e} C={c:2d}: max|k-p| = {errs[(e, c)][0]:.3e}, "
                  f"max|k-p|/max|p| = {rel:.3e} (tolerance {KERNEL_TOL:g})")
            if rel > KERNEL_TOL:
                fail(f"kernel disagrees with its plain version at E={e} C={c}")
            outs[(e, c)] = k
    full = outs[(8, 16)]
    for (e, c), k in outs.items():
        if not torch.equal(k, full[:e, :c]):
            fail(f"per-(row, expert) outputs at E={e} C={c} differ from E=8 C=16")
    print("[kernel] per-(row, expert) outputs bitwise equal across E in {1,2,8} "
          "and C in {1,2,16}")

    def library(xd, e):
        xb = xd.to(torch.bfloat16)
        hu = F.silu(torch.bmm(xb, wg[:e])) * torch.bmm(xb, wu[:e])
        return torch.bmm(hu, wd[:e])

    rows = {}
    for e, c in ((2, 1), (8, 1), (8, 16)):
        xd = x[:c].expand(e, c, D_MODEL).contiguous()
        t_k = time_ms(lambda: moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e]))
        t_p = time_ms(lambda: moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e]), iters=5)
        t_l = time_ms(lambda: library(xd, e))
        b_ms, b_by = bound_ms(e, c, 2)
        rows[(e, c)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=errs[(e, c)][0])
        print(f"[kernel] time E={e} C={c:2d}: kernel {t_k:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), plain {t_p:.4f} ms, torch.bmm bf16 formula {t_l:.4f} ms")
    moe_ffn_kernel.launches = 0         # comparison launches do not count
    del wg, wu, wd, outs
    torch.cuda.empty_cache()
    return rows


def phase_small():
    """A small fp32 MoE model: the CUDA path (kernel) against the plain
    CPU path on the same weights."""
    import torch
    from repro_torch.models import ModelConfig, decode_step, greedy_generate, prefill
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_map
    cfg = ModelConfig(name="smoke-moe", family="moe", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=0, d_expert=96,
                      vocab_size=97, num_experts=8, top_k=2)
    p_cpu = init_params(cfg, seed=1, device="cpu")
    p_gpu = tree_map(lambda t: t.to("cuda"), p_cpu)
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    worst = 0.0
    lc, sc = prefill(cfg, p_cpu, {"tokens": tokens}, 20)
    lg, sg = prefill(cfg, p_gpu, {"tokens": tokens.cuda()}, 20)
    for step in range(4):
        if not bool(torch.isfinite(lg).all()):
            fail("small model logits not finite on the card")
        err = float((lg.cpu() - lc).abs().max() / lc.abs().max())
        worst = max(worst, err)
        if err > 1e-4:
            fail(f"small model logits differ from the CPU path at step {step}: {err:.3e}")
        tok = torch.argmax(lc, dim=-1).to(torch.int32)
        lc, sc = decode_step(cfg, p_cpu, tok, sc)
        lg, sg = decode_step(cfg, p_gpu, tok.cuda(), sg)
    g_cpu = greedy_generate(cfg, p_cpu, {"tokens": tokens}, 8)
    g_gpu = greedy_generate(cfg, p_gpu, {"tokens": tokens.cuda()}, 8)
    if not torch.equal(g_cpu, g_gpu.cpu()):
        fail("small model greedy tokens differ between the card and the CPU path")
    print(f"[small] {cfg.name}: logits on the card within {worst:.3e} (relative) of "
          f"the plain CPU path over prefill + 3 steps; greedy tokens equal")


def phase_slice() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel
    from repro_torch.launch.serve import build_parser, serve_single
    from repro_torch.models import init_params
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, num_layers=4, padded_experts=0)
    print(f"[slice] {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, {cfg.num_experts} experts top-{cfg.top_k}, d_expert "
          f"{cfg.d_expert}, vocab {cfg.vocab_size}, {cfg.dtype}")
    print(f"[slice] cut: num_layers {full.num_layers} -> {cfg.num_layers}: the dense "
          f"reference stacks every expert on the card, and 32 layers of bf16 experts "
          f"are ~90 GB, more than the card's 80 GB")
    print(f"[slice] cut: padded_experts {full.padded_experts} -> 0: pad rows are never "
          f"routed and exist only to divide a TPU mesh axis; keeping them doubles "
          f"expert memory")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[slice] random bf16 parameters from seed 0: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    args = build_parser().parse_args(
        ["--prompt-len", "16", "--tokens", "8", "--predictor", "sep", "--shadow", "int8",
         "--transport-precision", "fp32", "--workers", "8", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    moe_ffn_kernel.launches = 0
    t0 = time.perf_counter()
    res = serve_single(cfg, params, args)
    launches = moe_ffn_kernel.launches
    print(f"[slice] serve_single took {time.perf_counter() - t0:.1f} s")
    toks = res["tokens"]
    if tuple(toks.shape) != (1, args.tokens):
        fail(f"engine tokens have shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail("engine tokens out of the vocabulary")
    if not torch.equal(toks.cpu(), res["reference"].cpu()):
        fail("engine tokens differ from greedy_generate")
    if res["launches_engine"] <= 0 or res["launches_reference"] <= 0:
        fail("the main path did not go through the moe_ffn kernel on both sides")
    eng = res["engine"]
    print(f"[slice] tokens {toks.cpu().tolist()[0]} == greedy_generate: True")
    print(f"[slice] kernel launches on the main path: {launches} "
          f"(engine+shadow {res['launches_engine']}, reference "
          f"{res['launches_reference']})")
    print(f"[slice] recall {eng_recall(res)}, loads {eng.slots.stats['loads']}, "
          f"bytes_moved {eng.slots.bytes_moved}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    phase_breakdown(cfg, params, eng, res)
    return {"launches": launches}


def _median_ms(fn, reps: int = 5) -> float:
    import statistics
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_breakdown(cfg, params, eng, res):
    """Where a decoded token's time goes: the parts of one engine step,
    each timed alone on the slice's own tensors (host clock around work
    that ends in a synchronize; median of 5)."""
    import torch
    from repro_torch.models import decode_step, prefill
    layer = eng.moe_layers[0]
    load_ms = _median_ms(lambda: eng.store.unpack_shard(layer, 0))
    nbytes = eng.store.packed_bytes(layer, 0)
    token = res["tokens"][:, -1].contiguous()
    shadow_ms = _median_ms(lambda: eng.shadow.step_state(eng.shadow.state, token))
    batch = {"tokens": res["tokens"]}
    _, state = prefill(cfg, params, batch, 16)
    ref_ms = _median_ms(lambda: decode_step(cfg, params, token, state))
    loads_per_token = eng.slots.stats["loads"] / max(len(res["step_seconds"]), 1)
    print(f"[breakdown] one expert load (pinned host -> card, {nbytes} bytes): "
          f"{load_ms:.3f} ms = {nbytes / load_ms / 1e6:.2f} GB/s")
    print(f"[breakdown] loads per decoded token: {loads_per_token:.3f}")
    print(f"[breakdown] SEP shadow step (4 layers, all 8 experts per layer): "
          f"{shadow_ms:.3f} ms")
    print(f"[breakdown] reference decode_step (4 layers, all 8 experts per layer): "
          f"{ref_ms:.3f} ms")


def eng_recall(res) -> str:
    r = res["trace"].recall()
    return "n/a" if r is None else f"{r:.4f}"


def main():
    t_start = time.perf_counter()
    smi_line = phase_card()
    import torch
    phase_build()
    rows = phase_kernel()
    phase_small()
    moe = phase_slice()
    row = rows[(2, 1)]
    kernels = [{
        "name": "moe_ffn", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_ffn.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:61",
        "launches": moe["launches"], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": f"E=2 C=1 D={D_MODEL} F={D_EXPERT} bf16 weights (engine wave)",
    }]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
