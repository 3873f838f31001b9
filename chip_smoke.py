#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. card    — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile the three hand-written kernels with nvcc, in
             parallel: the grouped expert FFN
             (``src/repro_torch/csrc/moe_ffn.cu``), its packed-weight twin
             (``moe_ffn_packed.cu``) and flash-decode attention
             (``flash_decode.cu``); print ptxas's register and spill lines.
3. kernel  — hold the grouped FFN against its plain PyTorch version at the
             decode path's shapes (D=4096, F=14336, bf16 weights,
             E in {1,2,8}, C in {1,2,16}), check that per-(row, expert)
             outputs are bitwise equal across E and C, and time the
             kernel, its bound, the plain version and a torch.bmm formula.
4. packed  — the packed kernel on fp16, int8 and nf4 parts at the same
             shapes: bitwise equal to the grouped FFN on the dequantized
             weights, within tolerance of its plain version, bitwise
             equal across E and C; timed beside its bytes bound, its
             plain version and a torch.bmm formula on the dequantized
             weights.
5. flash   — the flash-decode kernel against its plain version at
             Mixtral's attention shapes (K=8, G=4, Hd=128; bf16 and fp32;
             B in {1,4,16}; W in {32, 4096, 32768}; unfilled slots, ring
             wrap, window in {0, W/2}): within tolerance, each row bitwise
             equal to its own B=1 launch, and bitwise equal when W grows by
             two chunks of masked slots; timed beside its bytes bound, its
             plain version and ``scaled_dot_product_attention``.
6. small   — the port's model on the card against its plain CPU path on
             a small fp32 MoE config: logits close, tokens equal.
7. slice   — ``repro_torch.launch.serve.serve_single`` at Mixtral-8x7B
             width (4 layers, no expert padding), SEP int8 shadow, fp32
             transport: engine tokens must equal the port's
             ``greedy_generate`` and the kernel must have launched on both
             sides.  Then each part of a decoded token (one expert load,
             the shadow step, a dense decode step) is timed alone.
8. serve   — ``repro_torch.launch.serve.serve_traffic`` on the slice's
             parameters: 8 burst requests (prompts 64-128, up to 8 new
             tokens), max batch 4, overlap composition, a KV pool of 16-slot
             pages at half the dense footprint of 4 windows.  Every
             request's tokens must equal its solo ``greedy_generate``, the
             mean batch must exceed 1, the pool must preempt and resume at
             least once, and flash-decode and the expert kernel must have
             launched on the serving and the reference side.
9. packed slice — ``serve_single`` with ``--packed-slots`` at Mixtral-8x7B
             width in fp32 (2 layers), transport int8, nf4 and tiered in
             turn: engine tokens equal ``greedy_generate`` under the same
             policy, the packed kernel launched, and the per-worker bytes
             are the packed payload of the largest resident shard.

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
N_KV, GROUP, HEAD_DIM = 8, 4, 128  # Mixtral-8x7B attention: 8 kv heads, 32 query heads
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
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_decode import kernel as flash
    from repro_torch.kernels.moe_gemm import kernel, packed
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:        # one nvcc per source, together
        infos = list(pool.map(lambda m: m.LIBRARY.build(), (kernel, packed, flash)))
    for info in infos:
        print(f"[build] {info['path']} built in {info['seconds']:.2f} s", flush=True)
        for line in info["report"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")
    print(f"[build] phase {time.perf_counter() - t0:.2f} s", flush=True)


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


PACKED_SCHEMES = ("fp16", "int8", "nf4")


def phase_packed_kernel() -> dict:
    """The packed kernel against kernel 1 on the dequantized weights
    (bitwise), its plain version (tolerance) and itself across E and C
    (bitwise), then timed at the engine's wave shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gemm import (moe_ffn_kernel, moe_ffn_packed_kernel,
                                              moe_ffn_packed_ref)
    from repro_torch.quant import dequantize_tiles, device_layout, get_codec
    dev = torch.device("cuda")
    names = ("w_gate", "w_up", "w_down")
    shapes = {"w_gate": (D_MODEL, D_EXPERT), "w_up": (D_MODEL, D_EXPERT),
              "w_down": (D_EXPERT, D_MODEL)}
    x = torch.randn((16, D_MODEL), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    rows = {}
    for scheme in PACKED_SCHEMES:
        gen = torch.Generator(device=dev).manual_seed(2)
        parts = {}
        for name in names:        # one expert at a time: pack on the card, keep the parts
            per = []
            for _ in range(8):
                w = torch.randn(shapes[name], generator=gen, device=dev)
                per.append(device_layout(get_codec(scheme).pack(w * shapes[name][0] ** -0.5)))
                del w
            parts[name] = tuple(torch.stack([p[j] for p in per]) for j in range(len(per[0])))
            del per
        full = [dequantize_tiles(scheme, parts[n]).contiguous() for n in names]

        def sub(e):
            return {n: tuple(p[:e] for p in ps) for n, ps in parts.items()}

        outs, errs = {}, {}
        for e in (1, 2, 8):
            for c in (1, 2, 16):
                xd = x[:c].expand(e, c, D_MODEL).contiguous()
                k = moe_ffn_packed_kernel(xd, sub(e), scheme=scheme)
                k1 = moe_ffn_kernel(xd, *(w[:e] for w in full))
                p = moe_ffn_packed_ref(xd, sub(e), scheme=scheme)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(k).all()):
                    fail(f"packed kernel output not finite ({scheme}, E={e}, C={c})")
                if not torch.equal(k, k1):
                    fail(f"packed kernel differs from moe_ffn on the dequantized weights "
                         f"({scheme}, E={e}, C={c}): max|diff| "
                         f"{float((k - k1).abs().max()):.3e}")
                rel = float((k - p).abs().max() / p.abs().max())
                errs[(e, c)] = float((k - p).abs().max())
                print(f"[packed] {scheme} E={e} C={c:2d}: == moe_ffn on dequantized weights; "
                      f"max|k-p| = {errs[(e, c)]:.3e}, max|k-p|/max|p| = {rel:.3e} "
                      f"(tolerance {KERNEL_TOL:g})")
                if rel > KERNEL_TOL:
                    fail(f"packed kernel disagrees with its plain version ({scheme}, E={e}, "
                         f"C={c})")
                outs[(e, c)] = k
        for (e, c), k in outs.items():
            if not torch.equal(k, outs[(8, 16)][:e, :c]):
                fail(f"packed per-(row, expert) outputs at E={e} C={c} differ from E=8 C=16 "
                     f"({scheme})")
        print(f"[packed] {scheme}: per-(row, expert) outputs bitwise equal across E in "
              f"{{1,2,8}} and C in {{1,2,16}}")
        del outs

        def formula(xd, e):
            hu = F.silu(torch.bmm(xd, full[0][:e])) * torch.bmm(xd, full[1][:e])
            return torch.bmm(hu, full[2][:e])

        for e, c in ((2, 1), (8, 1)):
            xd = x[:c].expand(e, c, D_MODEL).contiguous()
            pe = sub(e)
            t_k = time_ms(lambda: moe_ffn_packed_kernel(xd, pe, scheme=scheme))
            t_k1 = time_ms(lambda: moe_ffn_kernel(xd, *(w[:e] for w in full)))
            t_p = time_ms(lambda: moe_ffn_packed_ref(xd, pe, scheme=scheme), iters=5)
            t_l = time_ms(lambda: formula(xd, e))
            nbytes = (2 * xd.numel() * 4 + sum(t.numel() * t.element_size()
                                               for ps in pe.values() for t in ps)
                      + (64 if scheme == "nf4" else 0))
            ops = 2 * 3 * e * c * D_MODEL * D_EXPERT + (3 * e * D_MODEL * D_EXPERT
                                                        if scheme != "fp16" else 0)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
            b_ms, b_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                     else "operations")
            rows[(scheme, e, c)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                                        bound_by=b_by, max_abs_err=errs[(e, c)],
                                        nbytes=nbytes, moe_ffn_fp32_ms=t_k1)
            print(f"[packed] time {scheme} E={e} C={c}: kernel {t_k:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}, {nbytes} bytes), plain {t_p:.4f} ms, "
                  f"torch.bmm fp32 formula on dequantized weights {t_l:.4f} ms, moe_ffn on "
                  f"the same fp32 weights {t_k1:.4f} ms", flush=True)
        del parts, full
        torch.cuda.empty_cache()
    moe_ffn_packed_kernel.launches = 0     # comparison launches do not count
    moe_ffn_kernel.launches = 0
    return rows


def median_ms(fn, iters: int = 25, warmup: int = 3, device_only: bool = True) -> float:
    """Median time of single launches, CUDA events around each.  With
    ``device_only`` a sleep kernel first holds the stream, so the whole call
    is queued before the start event fires and the events see device time
    alone; without it they also see the host's time to launch it."""
    import statistics
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_inputs(b, w, dtype, seed, fill=0.8):
    """Ring-buffer caches at Mixtral's attention shapes: each row's position
    is past the window for most rows (ring wrap); slot s holds the latest
    position congruent to s, some slots are unfilled (kpos = -1), and the
    slot of ``pos`` itself is always valid, as on the decode path."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, N_KV, GROUP, HEAD_DIM), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, w, N_KV, HEAD_DIM), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, w, N_KV, HEAD_DIM), generator=gen, device=dev).to(dtype)
    pos = torch.randint(w // 2, 3 * w, (b,), generator=gen, device=dev, dtype=torch.int32)
    slots = torch.arange(w, device=dev)
    kpos = pos[:, None] - (pos[:, None] - slots[None]) % w
    kpos = torch.where(kpos < 0, -1, kpos)
    drop = torch.rand((b, w), generator=gen, device=dev) > fill
    kpos = torch.where(drop, -1, kpos).to(torch.int32)
    kpos[torch.arange(b, device=dev), (pos % w).long()] = pos
    return q, k, v, kpos.contiguous(), pos


def flash_bound_ms(b, w, itemsize) -> tuple:
    """Least time for flash decode: the K and V caches and kpos read once
    (q and the output are under 0.1% of it), against fp32 FMAs."""
    nbytes = 2 * b * w * N_KV * HEAD_DIM * itemsize + 4 * b * w
    flops = 2 * 2 * b * w * N_KV * GROUP * HEAD_DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_flash() -> dict:
    """Flash decode against its plain version, row and tail invariance,
    then timed at long windows and at the serve phase's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode_kernel, flash_decode_ref
    from repro_torch.kernels.flash_decode import kernel as flash
    chunk = flash.LIBRARY.lib.flash_decode_chunk()
    worst = 0.0
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 4, 16):
            for w in (32, 4096, 32768):
                q, k, v, kpos, pos = flash_inputs(b, w, dtype, seed=b * 7 + w)
                for window in (0, w // 2):
                    o = flash_decode_kernel(q, k, v, kpos, pos, window=window)
                    p = flash_decode_ref(q, k, v, kpos, pos, window=window)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(o).all()):
                        fail(f"flash output not finite ({dtype}, B={b}, W={w})")
                    err = float((o - p).abs().max())
                    rel = err / float(p.abs().max())
                    worst = max(worst, rel)
                    errs[(dtype, b, w, window)] = err
                    if rel > KERNEL_TOL:
                        fail(f"flash kernel disagrees with its plain version ({dtype}, B={b}, "
                             f"W={w}, window={window}): {rel:.3e}")
                    for i in range(b):
                        one = flash_decode_kernel(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                  kpos[i:i + 1], pos[i:i + 1], window=window)
                        if not torch.equal(one, o[i:i + 1]):
                            fail(f"flash row {i} differs from its own B=1 launch ({dtype}, "
                                 f"B={b}, W={w}, window={window})")
                    ext = 2 * chunk
                    noise = torch.randn((b, ext, N_KV, HEAD_DIM), device="cuda").to(dtype)
                    k2 = torch.cat([k, noise], 1)
                    v2 = torch.cat([v, noise], 1)
                    kp2 = torch.cat([kpos, torch.full((b, ext), -1, dtype=torch.int32,
                                                      device="cuda")], 1)
                    if not torch.equal(flash_decode_kernel(q, k2, v2, kp2, pos, window=window), o):
                        fail(f"flash output changed when W grew by {ext} masked slots "
                             f"({dtype}, B={b}, W={w}, window={window})")
                    del k2, v2, kp2, noise
                print(f"[flash] {str(dtype)[6:]} B={b:2d} W={w:5d}: max|k-p| "
                      f"{errs[(dtype, b, w, 0)]:.3e} / {errs[(dtype, b, w, w // 2)]:.3e} "
                      f"(window 0 / W/2); rows == own B=1 launch; W -> W+{2 * chunk} "
                      f"masked: bitwise equal", flush=True)
                del q, k, v, kpos, pos
    print(f"[flash] worst max|k-p|/max|p| {worst:.3e} (tolerance {KERNEL_TOL:g})")
    torch.cuda.empty_cache()
    rows = {}
    for b, w in ((4, 144), (1, 4096), (4, 32768), (16, 32768)):
        q, k, v, kpos, pos = flash_inputs(b, w, torch.bfloat16, seed=3)
        qs = q.reshape(b, N_KV * GROUP, 1, HEAD_DIM)
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = ((kpos >= 0) & (kpos <= pos[:, None]))[:, None, None, :]
        t_k = median_ms(lambda: flash_decode_kernel(q, k, v, kpos, pos))
        t_host = median_ms(lambda: flash_decode_kernel(q, k, v, kpos, pos), device_only=False)
        t_p = median_ms(lambda: flash_decode_ref(q, k, v, kpos, pos), iters=20)
        t_l = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                               enable_gqa=True))
        b_ms, b_by, nbytes = flash_bound_ms(b, w, 2)
        o = flash_decode_kernel(q, k, v, kpos, pos)
        p = flash_decode_ref(q, k, v, kpos, pos)
        torch.cuda.synchronize()
        rows[(b, w)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                            max_abs_err=float((o - p).abs().max()), nbytes=nbytes,
                            host_ms=t_host)
        print(f"[flash] time bf16 B={b:2d} W={w:5d}: kernel {t_k:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {nbytes} bytes, {b_ms / t_k:.1%} of it), plain {t_p:.4f} ms, "
              f"scaled_dot_product_attention {t_l:.4f} ms (device time, median of 25 / 20 / 25 "
              f"launches); kernel with the host's launch time {t_host:.4f} ms", flush=True)
        del q, k, v, kpos, pos, qs, ks, vs, mask
    flash_pass_profile(4, 32768)
    flash_decode_kernel.launches = 0       # comparison launches do not count
    torch.cuda.empty_cache()
    return rows


def flash_pass_profile(b, w):
    """Device time of the kernel's two passes (chunk partials, combine) at
    one shape, from ``torch.profiler``'s CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_decode import flash_decode_kernel
    q, k, v, kpos, pos = flash_inputs(b, w, torch.bfloat16, seed=3)
    flash_decode_kernel(q, k, v, kpos, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flash_decode_kernel(q, k, v, kpos, pos)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        name = "chunk" if "chunk_kernel" in e.key else "combine" if "combine_kernel" in e.key \
            else None
        if name:
            parts.append(f"{name} {e.device_time / 1e3:.4f} ms")
    print(f"[flash] passes at bf16 B={b} W={w} (torch.profiler, mean of 10): "
          + ", ".join(parts))


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
    print(f"[slice] kernel launches on the main path (engine+shadow): "
          f"{res['launches_engine']}; in the greedy_generate check: "
          f"{res['launches_reference']} (all {launches})")
    print(f"[slice] recall {eng_recall(res)}, loads {eng.slots.stats['loads']}, "
          f"bytes_moved {eng.slots.bytes_moved}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    phase_breakdown(cfg, params, eng, res)
    return {"launches": res["launches_engine"], "cfg": cfg, "params": params}


SERVE_SEED = 4     # the first make_traffic seed whose burst makes the half-dense pool preempt


def phase_serve(cfg, params) -> dict:
    """``serve_traffic`` at Mixtral-8x7B width on the slice's parameters:
    8 burst requests through a half-dense KV pool."""
    import math
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_kernel
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_packed_kernel
    from repro_torch.launch.serve import build_parser, serve_traffic
    from repro_torch.serve import make_traffic
    max_batch, page_tokens = 4, 16
    reqs = make_traffic(cfg, 8, 0.0, prompt_len=128, max_new=8, seed=SERVE_SEED)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pages = math.ceil(window / page_tokens) * max_batch // 2
    print(f"[serve] {len(reqs)} requests at t=0 (make_traffic seed {SERVE_SEED}): prompts "
          f"{[len(r.prompt) for r in reqs]}, budgets {[r.max_new_tokens for r in reqs]}; "
          f"window {window} slots; KV pool {pages} pages x {page_tokens} slots = half the "
          f"dense footprint of {max_batch} windows", flush=True)
    args = build_parser().parse_args(
        ["--requests", "8", "--arrival-rate", "0", "--prompt-len", "128", "--tokens", "8",
         "--max-batch", str(max_batch), "--compose", "overlap", "--predictor", "sep",
         "--shadow", "int8", "--transport-precision", "fp32", "--workers", "8",
         "--seed", str(SERVE_SEED), "--kv-pages", str(pages),
         "--page-tokens", str(page_tokens)])
    torch.cuda.reset_peak_memory_stats()
    for kern in (moe_ffn_kernel, moe_ffn_packed_kernel, flash_decode_kernel):
        kern.launches = 0
    t0 = time.perf_counter()
    out = serve_traffic(cfg, params, args)       # raises unless every request == solo
    launches = {"moe_ffn": moe_ffn_kernel.launches,
                "flash_decode": flash_decode_kernel.launches}
    if launches != {k: out["launches_serving"][k] + out["launches_reference"][k]
                    for k in launches}:
        fail(f"launch counts {launches} are not the serving and reference counts summed")
    res = out["result"]
    print(f"[serve] serve_traffic took {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if len(res.outputs) != len(reqs):
        fail("not every request was served")
    for r in reqs:
        toks = res.outputs[r.rid]
        if len(toks) != r.max_new_tokens or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size:
            fail(f"request {r.rid}: {len(toks)} tokens, out of budget or vocabulary")
    st = res.kv_stats
    if res.mean_batch <= 1.0:
        fail(f"mean batch {res.mean_batch:.2f}: no composed step")
    if st["preemptions"] < 1 or st["resumes"] < 1:
        fail(f"the half-dense pool did not preempt and resume ({st})")
    for name in ("moe_ffn", "flash_decode"):
        if out["launches_serving"][name] <= 0 or out["launches_reference"][name] <= 0:
            fail(f"{name} did not launch on both the serving and the reference side")
    steps = res.steps
    print(f"[serve] tokens of all {len(reqs)} requests == solo greedy_generate; mean batch "
          f"{res.mean_batch:.2f} over {len(steps)} composed steps; preemptions "
          f"{st['preemptions']}, resumes {st['resumes']}, deferred admissions "
          f"{st['deferred_admissions']}; kernel launches on the main path (engine+shadow) "
          f"{out['launches_serving']}; in the solo greedy_generate check "
          f"{out['launches_reference']} (all {launches})")
    return {"launches": out["launches_serving"]}


# Per-worker bytes a packed-resident slot must hold at Mixtral-8x7B width:
# the packed payload of one expert (codes and scales).
PACKED_SLOT_BYTES = {"int8": 176_291_840, "nf4": 99_090_432}
PACKED_SLICE_LAYERS = 2


def phase_packed_slice() -> dict:
    """``serve_single --packed-slots`` at Mixtral-8x7B width in fp32,
    transport int8, nf4 and tiered in turn."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_packed_kernel
    from repro_torch.launch.serve import build_parser, serve_single
    from repro_torch.models import init_params
    from repro_torch.quant.transport import transport_expert_bytes
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, num_layers=PACKED_SLICE_LAYERS, padded_experts=0,
                              dtype="float32")
    expert_gb = transport_expert_bytes(cfg, "fp32") * cfg.num_experts / 1e9
    print(f"[packed-slice] {cfg.name}: d_model {cfg.d_model}, {cfg.num_experts} experts "
          f"top-{cfg.top_k}, d_expert {cfg.d_expert}, {cfg.dtype}")
    print(f"[packed-slice] cut: dtype {full.dtype} -> float32: a packed-resident slot "
          f"needs an fp32 deployment (the kernel dequantizes to fp32; a bf16 expert falls "
          f"back to a full-width slot, as in the JAX package)")
    print(f"[packed-slice] cut: num_layers {full.num_layers} -> {cfg.num_layers}: one "
          f"layer's 8 fp32 experts are {expert_gb:.2f} GB and serve_single holds about 4 "
          f"copies (parameters, the engine's and the reference's round-tripped trees, the "
          f"shadow's), so 2 layers need ~{8 * expert_gb + 2:.0f} GB and 3 ~"
          f"{12 * expert_gb + 2:.0f} GB of the card's 80 GB")
    print(f"[packed-slice] cut: padded_experts {full.padded_experts} -> 0 (as in the slice "
          f"phase)")
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[packed-slice] random fp32 parameters from seed 0: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card", flush=True)
    out = {"launches": 0, "runs": {}}
    for precision in ("int8", "nf4", "tiered"):
        args = build_parser().parse_args(
            ["--prompt-len", "16", "--tokens", "8", "--predictor", "sep", "--shadow", "int8",
             "--transport-precision", precision, "--workers", "8", "--seed", "0",
             "--packed-slots"])
        torch.cuda.reset_peak_memory_stats()
        moe_ffn_kernel.launches = 0
        moe_ffn_packed_kernel.launches = 0
        t0 = time.perf_counter()
        res = serve_single(cfg, params, args)
        launches = moe_ffn_packed_kernel.launches
        print(f"[packed-slice] {precision}: serve_single took {time.perf_counter() - t0:.1f} s")
        toks, eng = res["tokens"], res["engine"]
        if tuple(toks.shape) != (1, args.tokens):
            fail(f"engine tokens have shape {tuple(toks.shape)}")
        if not torch.equal(toks.cpu(), res["reference"].cpu()):
            fail(f"packed engine tokens differ from greedy_generate ({precision})")
        if res["packed_launches_engine"] <= 0:
            fail(f"the packed engine did not launch the packed kernel ({precision})")
        mem = eng.memory_report()
        want = PACKED_SLOT_BYTES.get(precision)
        slot_max = max(eng.store.resident_nbytes(li, e) for li in eng.moe_layers
                       for e in range(cfg.num_experts))
        if mem["per_worker_bytes"] != (want if want is not None else slot_max):
            fail(f"per_worker_bytes {mem['per_worker_bytes']} is not the packed payload "
                 f"{want if want is not None else slot_max} ({precision})")
        steps = res["step_seconds"]
        tpot = statistics.median(steps) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[packed-slice] {precision} [{eng.transport.describe()}]: tokens "
              f"{toks.cpu().tolist()[0]} == greedy_generate: True; packed kernel launches "
              f"{launches} (engine {res['packed_launches_engine']}, reference "
              f"{res['packed_launches_reference']}), moe_ffn launches "
              f"{moe_ffn_kernel.launches}")
        print(f"[packed-slice] {precision}: TPOT median {tpot:.3f} ms over {len(steps)} tokens, "
              f"loads {eng.slots.stats['loads']}, bytes_moved {eng.slots.bytes_moved}, "
              f"per_worker_bytes {mem['per_worker_bytes']}, peak device memory {peak:.2f} GB, "
              f"modelled (rtx3090-edge profile) {res['modelled_tok_s']:.3f} tok/s", flush=True)
        layer = eng.moe_layers[0]
        load_ms = _median_ms(lambda: eng.store.device_shard(layer, 0))
        nbytes = eng.store.packed_bytes(layer, 0)
        token = toks[:, -1].contiguous()
        shadow_ms = _median_ms(lambda: eng.shadow.step_state(eng.shadow.state, token))
        print(f"[packed-breakdown] {precision}: one packed-resident load (expert 0 of layer "
              f"{layer}, {eng.store.scheme_of(layer, 0)}, {nbytes} bytes, pinned host -> "
              f"card): {load_ms:.3f} ms = {nbytes / load_ms / 1e6:.2f} GB/s; loads per decoded "
              f"token {eng.slots.stats['loads'] / max(len(steps), 1):.3f}; SEP shadow step "
              f"({cfg.num_layers} fp32 layers, all {cfg.num_experts} experts per layer): "
              f"{shadow_ms:.3f} ms",
              flush=True)
        out["launches"] += res["packed_launches_engine"]
        out["runs"][precision] = dict(tpot_ms=tpot, per_worker=mem["per_worker_bytes"])
        del res, eng, toks
        torch.cuda.empty_cache()
    return out


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
    prows = phase_packed_kernel()
    frows = phase_flash()
    phase_small()
    moe = phase_slice()
    serve = phase_serve(moe.pop("cfg"), moe.pop("params"))
    torch.cuda.empty_cache()
    packed = phase_packed_slice()
    row, prow, frow = rows[(2, 1)], prows[("int8", 2, 1)], frows[(4, 144)]
    kernels = [{
        "name": "moe_ffn", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_ffn.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:61",
        "launches": moe["launches"], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": f"E=2 C=1 D={D_MODEL} F={D_EXPERT} bf16 weights (engine wave)",
    }, {
        "name": "moe_ffn_packed", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_ffn_packed.cu",
        "replaces": "src/repro/kernels/moe_gemm/packed.py:147",
        "launches": packed["launches"], "max_abs_err": prow["max_abs_err"],
        "ms": prow["ms"], "plain_ms": prow["plain_ms"], "bound_ms": prow["bound_ms"],
        "bound_by": prow["bound_by"], "library_ms": None,
        "yardstick_ms": prow["library_ms"],
        "yardstick": "torch.bmm fp32 formula on the dequantized weights (no PyTorch call "
                     "dequantizes inside its product)",
        "shape": f"E=2 C=1 D={D_MODEL} F={D_EXPERT} int8 codes + scales (engine wave)",
    }, {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/kernel.py:74",
        "launches": serve["launches"]["flash_decode"], "max_abs_err": frow["max_abs_err"],
        "ms": frow["ms"], "plain_ms": frow["plain_ms"], "bound_ms": frow["bound_ms"],
        "bound_by": frow["bound_by"], "library_ms": frow["library_ms"],
        "shape": f"B=4 W=144 K={N_KV} G={GROUP} Hd={HEAD_DIM} bf16 (serve phase's composed "
                 "step)",
    }]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
