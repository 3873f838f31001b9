#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. card    — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile the five hand-written kernels with nvcc, in
             parallel: the grouped expert FFN
             (``src/repro_torch/csrc/moe_ffn.cu``), its packed-weight twin
             (``moe_ffn_packed.cu``), flash-decode attention
             (``flash_decode.cu``), the SSD inter-chunk scan
             (``ssd_scan.cu``) and the w8a16 matmul (``int8_matmul.cu``);
             print ptxas's register and spill lines.
3. kernel  — hold the grouped FFN against its plain PyTorch version at the
             decode and prefill paths' shapes (D=4096, F=14336, bf16
             weights, on tensor cores, E in {1,2,8,16}, C in {1,2,16,64}),
             check that per-(row, expert) outputs are bitwise equal across
             E and C, time a prefill's row blocks at three expert-row
             budgets (the largest the bf16 default), time the kernel at
             E/C = 2/1, 8/1, 8/16 and 16/64 beside its bound (bytes against
             fp32 FMAs, and against the bf16 tensor rate for the MMAs it
             issues), the plain version and a torch.bmm formula, and
             profile its passes.  Then the same kernel on fp32 weights (the
             packed slice's dtype, its shadow and its reference): within
             tolerance of its plain version and bitwise equal across E in
             {1,2,8} and C in {1,2,16}, timed at E/C = 2/1, 8/1 and 8/16
             beside its bound, its plain version and the torch.bmm fp32
             formula (back to back, as every kernel time here; device
             times alone, single calls queued behind a sleep kernel,
             beside them), its two launches profiled against each one's
             bound.
4. packed  — the packed kernel on fp16, int8 and nf4 parts at the same
             shapes: bitwise equal to the grouped FFN on the dequantized
             weights, within tolerance of its plain version, bitwise
             equal across E and C; timed beside its bytes bound, its
             plain version and a torch.bmm formula on the dequantized
             weights (device times alone beside them, as above); its int8
             launches profiled at E=2 C=1.
5. flash   — the flash-decode kernel against its plain version at
             Mixtral's attention shapes (K=8, G=4, Hd=128; bf16 and fp32;
             B in {1,4,16}; W in {32, 1008, 1040, 4096, 32768}, 1008
             and 1040 being the Jamba phases' widths; unfilled slots, ring
             wrap, window in {0, W/2}): within tolerance, each row bitwise
             equal to its own B=1 launch, and bitwise equal when W grows by
             two chunks of masked slots; timed at the serve steps' B=4 and
             B=16 W=144 and at long windows beside its bytes bound, its
             plain version and ``scaled_dot_product_attention``; its one
             launch profiled.
6. small   — the port's model on the card against its plain CPU path on
             a small fp32 MoE config: logits close, tokens equal.
7. slice   — ``repro_torch.launch.serve.serve_single`` at Mixtral-8x7B
             width (4 layers, no expert padding), SEP int8 shadow, fp32
             transport: engine tokens must equal the port's
             ``greedy_generate`` and the kernel must have launched on both
             sides.  Then the engine's prefill and each part of a decoded
             token (one expert load, the shadow step, a dense decode step)
             are timed alone.
8. serve   — ``repro_torch.launch.serve.serve_traffic`` on the slice's
             parameters: 8 burst requests (prompts 64-128, up to 8 new
             tokens), max batch 4, overlap composition, a KV pool of 16-slot
             pages at half the dense footprint of 4 windows.  Every
             request's tokens must equal its solo ``greedy_generate``, the
             mean batch must exceed 1, the pool must preempt and resume at
             least once, and flash-decode and the expert kernel must have
             launched on the serving and the reference side.
8a. prefetch — engines on the slice's parameters (prompt 16, 8 tokens),
             sharing one expert store: no prefetch, ``prefetch="sync"``,
             ``"thread"``, a ``ChaosExecutor`` for seeds 1 and 2, and
             ``"sync"`` and ``"thread"`` with ``residency="lru"`` and with
             ``"gate"``.  Every engine's tokens equal ``greedy_generate``;
             every executor's load events and bytes equal those of the
             first engine of its residency (no prefetch, or sync).  Prints
             each run's TPOT median, prefetch counters, peak memory while
             decoding, and the host's copy rate; one more decode of the
             first three under ``torch.profiler`` gives copy/kernel overlap.
8b. prefetch-serve — the serve phase's traffic through ``serve_traffic``
             with ``prefetch="thread"`` and ``residency="lru"``: every
             request equals its solo decode; composed-step times by B beside
             the synchronous serve phase's, the prefetch counters, and the
             peak memory while serving beside the serve phase's.
8c. spec   — speculative decoding on the slice's parameters:
             ``serve_single`` with a 16-token prompt and 9 tokens at
             ``--speculate 1`` (the yardstick), 2 and 4 under per-step
             alignment and 4 free-running (``--token-period 0 --kv-period
             0``, so drafts get rejected).  Each run's tokens equal
             ``greedy_generate`` and its waves commit 8 tokens; moe_ffn and
             flash_decode launch on the spec path.  Prints waves,
             acceptance, rejected rows, loads, bytes and decode wall time per
             committed token.  Then a verify wave of B=1, S=4 at W=25 on the
             first attention layer: each row equals the one-token
             ``attn_decode`` row, and its cache sequential decode's, bit for
             bit through the kernel; flash decode timed at that shape beside
             its bound, plain version and ``scaled_dot_product_attention``.
8d. spec-serve — the serve phase's traffic with ``--speculate 2``: every
             request equals its solo decode and commits ``max_new_tokens -
             1`` in waves; composed-step times by B beside the serve phase's.
8e. fleet  — the slice's model and prompt on a heterogeneous fleet
             (workers 0-3: two slots on 24 GB/s links, workers 4-7: one
             slot on 12 GB/s links, groups of 2) under a fault script: the
             worker taking MoE layer 1's first predicted expert dies right
             after that load at step 2 (stranding it) and recovers at step
             5, and worker 6's link is throttled to a quarter at step 3.
             The synchronous engine, the synchronous engine with LRU
             residency and ``prefetch="thread"`` with LRU residency, on one
             expert store: tokens equal the slice's ``greedy_generate``; the
             threaded run's load events and stats equal the synchronous
             LRU run's; one failure and one recovery, and (synchronous
             engine) at least one dropped resident and one reload at the
             kill step; no load lands on a worker while the script has it
             dead.  Prints wall TPOT on healthy and degraded steps, loads
             and reloads per token, bytes moved and slot bytes per worker,
             peak memory and the modelled ``degraded_report``.
8f. fleet-serve — the serve phase's traffic and pool through
             ``ServingLoop`` on a uniform 8-worker fleet that loses worker 2
             at global step 3 and, mid-layer at step 6, the worker taking
             MoE layer 0's first predicted expert (right after that load,
             stranding it), and gets worker 2 back at step 9: every request
             equals the serve phase's output for it (its solo decode),
             ``StepRecord.alive_workers`` follows the script (8, 7, 6, 7),
             the mid-layer kill dropped at least one resident and at least
             one expert reloaded at step 6, and no load landed on a worker
             while the script had it dead.  Prints
             ``degraded_report()``, composed-step times by B and the
             kernels' launches.
8g. placement — a ``GateStatsRecorder`` calibrated on the slice prompt
             (``gate_stats=``, 8 tokens), ``optimize_placement`` for 8 workers in
             groups of 2, then the prompt decoded on ``FleetSchedule(8, 2,
             plan=plan)`` synchronously and with ``prefetch="thread"``: tokens
             equal ``greedy_generate``, the threaded run's load events equal
             the synchronous run's, every predicted load whose planned worker
             had a free slot lands on it, and at least one lands outside its
             modulo home group.  Prints ``expected_t_maxload`` of the plan and
             of ``modulo_plan`` (modelled), TPOT beside the slice's and loads
             per token.
8h. cvs    — ``compute_vs_ship=True`` (42 GB/s) with no predictor on 8
             uniform workers in groups of 2, links at 24 GB/s (every cold
             expert hosted: no reload, no byte moved, 2 hosted per MoE layer
             per token) and at 100 GB/s (every expert ships): tokens equal
             ``greedy_generate``; the hosted run's peak memory is at most one
             layer's stack of 2 experts above the shipped run's.  Prints TPOT
             on the card and modelled, and peak memory, of both.
8i. cluster — ``make_cluster`` with 2 replicas on the serve phase's traffic
             (dense KV, max batch 4): least-loaded with a shared gate-statistics
             recorder, then round-robin under the placement phase's plan with
             compute-vs-ship on 24 GB/s links.  Every request equals the
             serve phase's output (its solo decode), both replicas serve, the
             replicas share one store and one schedule, and the second run
             hosts at least one expert.  Prints the modelled cluster report,
             each replica's requests and mean batch, composed-step times by B
             beside the serve phase's, launches and peak memory.
8j. long   — ``serve_single`` on the slice's parameters with a 3000-token
             prompt (its 4096 bucket: every attention prefill runs the
             blockwise online-softmax path) and 8 tokens: engine tokens equal
             ``greedy_generate``, moe_ffn and flash_decode launched on both
             sides.  Prints TPOT, the engine's prefill, flash decode at
             W=3008 beside its bound, plain version and
             ``scaled_dot_product_attention``, and one attention layer's
             prefill blockwise at T=4096 beside the full path at T=2048.
9. packed slice — ``serve_single`` with ``--packed-slots`` at Mixtral-8x7B
             width in fp32 (2 layers), transport int8, nf4 and tiered in
             turn: engine tokens equal ``greedy_generate`` under the same
             policy, the packed kernel launched, and the per-worker bytes
             are the packed payload of the largest resident shard.
10. ssd    — the SSD inter-chunk scan kernel against its plain version at
             Jamba's Mamba shape (H=128, P=64, N=128; B in {1,4}, NC in
             {1,4,8,12}; zero start and a given h0) and at an odd shape (a
             ragged float4 tail): bitwise equal, each batch row equal to
             its own B=1 launch; P*N not a multiple of 4 and a misaligned
             pointer must be refused; timed beside its bytes bound and its
             plain version.
11. jamba-slice — ``serve_single`` at Jamba-v0.1 width (6 layers: Mamba at
             0-3 and 5, attention at 4, MoE at 1, 3 and 5), bf16, SEP int8
             shadow, fp32 transport, a 1000-token prompt (4 chunks, the last
             padded by 24) and 8 new tokens: engine tokens equal the port's
             ``greedy_generate``, and ssd_scan, moe_ffn and flash_decode
             launched on both sides; then the engine's prefill and the
             parts of a decoded token.
12. jamba-serve — ``serve_traffic`` on the same parameters: 4 burst
             requests (prompts 512-1023), max batch 4, overlap composition, a
             KV pool of 16-slot pages at half the dense footprint of 4
             windows over the one attention layer; every request equals its
             solo ``greedy_generate``, the pool preempts and resumes, the
             three kernels launched on both sides.
12a. jamba-long — the jamba-slice parameters with a 3000-token prompt (a
             hybrid never pads: attention blockwise at 3000, the SSD scan
             over 12 chunks) and 8 tokens: engine tokens equal
             ``greedy_generate``; the three kernels launched on both sides.
12b. qwen3 — qwen3-moe-30b-a3b at full width (128 experts top-8, D=2048,
             F=768, 32/4 heads of 128), 8 of 48 layers, bf16, SEP int8
             shadow, 16 workers (two groups of 8), prompt 16, 8 tokens:
             engine tokens equal ``greedy_generate``.  Prints TPOT, the parts
             of a token, the prefill, the modelled OD-MoE, fully-cached,
             offload-cache (LRU and LFU, a third of the experts cached) and CPU
             tokens/s on the phase's own trace, and kernel 1 at qwen3's widths
             (E/C 8/1, 128/1, 128/16) beside its bound.
12c. qwen3-serve — the serve phase's traffic (seed 4, 8 requests at t=0,
             prompts 64-127, max batch 4) on the qwen3 parameters, dense KV,
             16 workers: every request equals its solo decode; composed-step
             times by B, and flash decode at B=4 W=144 with G=8.
12d. granite — granite-moe-3b-a800m at full width and depth (32 layers, 40
             experts in 48 padded rows, top-8, D=1536, F=512, 24/8 heads of
             64, tied embeddings), 16 workers, prompt 16, 8 tokens: engine
             tokens equal ``greedy_generate`` and the store holds the 40
             routed experts only.  Prints TPOT, the parts of a token, the
             prefill, flash decode at G=3 Hd=64 and kernel 1 at granite's
             widths (E/C 8/1, 64/1, 64/16).
12e. dispatch — granite-moe's ``loss_fn`` (the granite phase's bf16
             parameters, B=2 T=512: 1024 rows a MoE layer) under the four MoE
             dispatches, ``grouped`` (kernel 1; its launches counted) the main
             path.  In every MoE layer, on the same rows: ``grouped`` and the
             ``cap_factor = E / k`` runs of ``scatter`` and ``einsum`` against
             ``dense``, and at the config's 1.25 and at 0.5 (where pairs
             drop) the two against each other (same kept (token, rank)
             pairs), each layer's output within its pair's tolerance and its
             load-balance term bitwise equal; under ``grouped`` kernel 1
             against its plain version on each layer's rows, within 1e-4;
             nothing drops at E/k.  Prints each dispatch's loss,
             ``loss_fn`` time and peak memory.  The same on the parameters
             in fp32.  Losses agree within 1e-3 in fp32 and 2.5e-2 in bf16
             (at 0.5 a flipped tie moves later layers' slots: printed only).
12e1. train — training at granite-moe's full width and depth on the
             dispatch phase's bf16 parameters: ``loss_fn`` under ``grouped``
             with grad enabled refuses (``ValueError``, kernel 1 has no
             backward) before launching; then ``make_train_step`` (scatter,
             per-block remat, AdamW with fp32 moments) for 3 steps on B=2
             T=512 from ``batch_iterator``.  Gates: every loss finite; every
             parameter leaf's gradient non-zero at step 1 (its ``mu``); the
             loss on a held batch falls; no hand-written kernel launches; a
             checkpoint of the trained parameters (``build/``, removed after)
             loads into freshly initialised ones bit for bit, with a bitwise
             equal held loss (deterministic algorithms on for both).  Prints
             the step time (median of steps 2-3), peak memory and the
             checkpoint's save and load times.
12e2. train-ssm — first the SSD scan's ``autograd.Function`` (kernel
             forward, kernel reverse scan) against autograd through its plain
             version at a mamba2-2.7b layer's shape (B=1 NC=4 H=80 P=64
             N=128): ``ds`` and ``dh0`` bitwise, ``d(decay)`` within 1e-5;
             then mamba2-2.7b at full width and depth (64 layers, d_model
             2560) through the train phase's steps and gates with B=2 T=1024
             in 2 microbatches: ``ssd_scan`` launches exactly 3 x 64 x 2 a
             step (forward, remat recompute, reverse scan).
12f. encdec — seamless-m4t-large-v2 at full width and depth (24 encoder and
             24 decoder layers, d_model 1024, 16 heads of 64, vocab 256206),
             B=2, 256 frames, prompt 16, 8 tokens.  fp32 gate: ``greedy_generate``
             equals ``prefill``/``decode_step``'s argmax and the teacher-forced
             ``encdec_seq``'s, each step's logits within 1e-4 of it, flash
             decode launched for self and cross attention in every layer.  bf16
             run: TPOT, prefill, peak memory, launches; flash decode at the
             self (W=24, G=1 Hd=64) and cross (W=256, every kpos 0) layouts.
12g. vlm   — internvl2-26b at full width (d_model 6144, 48/8 heads of 128,
             d_ff 16384, 256 patches of 3200), prompt 16, 8 tokens, a cache of
             280 keeping the image: the fp32 gate at 4 layers against the
             teacher-forced ``lm_seq(frontend_embeds=)``, the bf16 run at all 48
             layers; flash decode at B=1 W=280 G=6.
13. int8   — the w8a16 matmul kernel against its plain version at the JAX
             tests' shapes (32x128x64, 64x256x96, ragged 13x70x33) and the
             Mixtral-8x7B expert matrices (4096x14336, 14336x4096) with M in
             {1, 4, 8}, fp32 and bf16 x, each with its plan (segments, the
             cluster fold, tiles); repeated launches bitwise equal; each row
             of M=13 and M=8 calls bitwise equal to its own M=1 launch and
             bf16 x to the same values in fp32; no int-to-float conversion
             (I2F) in its SASS (``cuobjdump``); timed at M in {1, 4, 8} with
             L2 warm and flushed, beside its bytes bound, and at M=4 beside
             its plain version and cuBLAS on weights dequantized beforehand
             (fp32 and bf16).  No path of the port calls it, as in the JAX
             package.  Its one-launch-a-call gate (``torch.profiler`` over 5
             calls at M=4) runs right after the build, as the process's
             first profiler session.

The last line is ``{"ok": true, "device": {...}}``; it is printed only
when every phase passed.  The script imports nothing of JAX or of the
JAX package ``repro``.
"""
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet), used for the bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12          # fp32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12      # bf16 tensor cores, dense
D_MODEL, D_EXPERT = 4096, 14336
N_KV, GROUP, HEAD_DIM = 8, 4, 128  # Mixtral-8x7B attention: 8 kv heads, 32 query heads
KERNEL_TOL = 1e-4                 # max|k - p| / max|p|: fp32 sums in two orders
INT8_TOL = 1e-5                   # the same for the w8a16 matmul (scaled after its sum)
SSD_TOL = 1e-6                    # the scan's second check, after bitwise equality
LONG_PROMPT, LONG_TOKENS = 3000, 8   # past the 2048-token threshold: blockwise attention
JAMBA_LONG_CHUNKS = -(-LONG_PROMPT // 256)   # the SSD scan's chunks at Jamba's chunk of 256


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
    from repro_torch.kernels.int8_matmul import kernel as int8
    from repro_torch.kernels.moe_gemm import kernel, packed
    from repro_torch.kernels.ssd_scan import kernel as ssd
    t0 = time.perf_counter()
    mods = (kernel, packed, flash, ssd, int8)
    with ThreadPoolExecutor(len(mods)) as pool:        # one nvcc per source, together
        infos = list(pool.map(lambda m: m.LIBRARY.build(), mods))
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


def bound_ms(e: int, c: int, weight_bytes: int, d: int = D_MODEL, f: int = D_EXPERT) -> tuple:
    """Least time for the grouped FFN: each input read once (x fp32, three
    weight matrices), the output written once, against fp32 FMAs."""
    nbytes = 4 * e * c * d * 2 + 3 * e * d * f * weight_bytes
    flops = 2 * 3 * e * c * d * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound_tc_ms(e: int, c: int, issued: bool) -> tuple:
    """The grouped FFN's bytes against the bf16 tensor rate: for the
    function's own products (one per product, C rows), or, with ``issued``,
    for the MMAs the bf16 design issues (rows padded to its row tile of 8,
    16, 32 or 64, two MMAs per product: x, and hu, split into two bf16
    terms).  Printed only; the kernels line carries ``bound_ms``."""
    tile = 8 if c <= 8 else 16 if c <= 16 else 32 if c <= 32 else 64
    rows, mmas = (-(-c // tile) * tile, 2) if issued else (c, 1)
    nbytes = 4 * e * c * D_MODEL * 2 + 3 * e * D_MODEL * D_EXPERT * 2
    flops = 2 * mmas * 3 * e * rows * D_MODEL * D_EXPERT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS_PER_S
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

    # E up to 16 (Jamba's experts, all of them in its shadow and reference)
    # and C up to 64 (the rows of one of Jamba's prefill blocks, see
    # moe_gemm/ops.py MAX_EXPERT_ROWS); D and F are Mixtral's and Jamba's
    x = torch.randn((1024, D_MODEL), generator=gen, device=dev)
    wg = weight((16, D_MODEL, D_EXPERT), D_MODEL)
    wu = weight((16, D_MODEL, D_EXPERT), D_MODEL)
    wd = weight((16, D_EXPERT, D_MODEL), D_EXPERT)
    outs, errs = {}, {}
    for e in (1, 2, 8, 16):
        for c in (1, 2, 16, 64):
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
    full = outs[(16, 64)]
    for (e, c), k in outs.items():
        if not torch.equal(k, full[:e, :c]):
            fail(f"per-(row, expert) outputs at E={e} C={c} differ from E=16 C=64")
    print("[kernel] per-(row, expert) outputs bitwise equal across E in {1,2,8,16} "
          "and C in {1,2,16,64}")
    row_block_times(x, wg, wu, wd)

    def library(xd, e):
        xb = xd.to(torch.bfloat16)
        hu = F.silu(torch.bmm(xb, wg[:e])) * torch.bmm(xb, wu[:e])
        return torch.bmm(hu, wd[:e])

    rows = {}
    for e, c in ((2, 1), (8, 1), (8, 16), (16, 64)):
        xd = x[:c].expand(e, c, D_MODEL).contiguous()
        t_k = time_ms(lambda: moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e]))
        t_p = time_ms(lambda: moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e]), iters=5)
        t_l = time_ms(lambda: library(xd, e))
        t_k2 = time_ms(lambda: moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e]))
        b_ms, b_by = bound_ms(e, c, 2)
        fn_ms, fn_by = bound_tc_ms(e, c, issued=False)
        tc_ms, tc_by = bound_tc_ms(e, c, issued=True)
        rows[(e, c)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=errs[(e, c)][0])
        print(f"[kernel] time E={e:2d} C={c:2d}: kernel {t_k:.4f} ms (again after the "
              f"formula: {t_k2:.4f} ms), torch.bmm bf16 formula {t_l:.4f} ms, plain "
              f"{t_p:.4f} ms; bound {b_ms:.4f} ms ({b_by}; its operations at the fp32 FMA "
              f"rate, which this tensor-core path does not run on, so no share of it is "
              f"given); at the bf16 tensor rate: the function's products {fn_ms:.4f} ms "
              f"({fn_by}, {fn_ms / t_k:.1%} of the kernel's time), the MMAs the design "
              f"issues (rows padded to the row tile, two per product) {tc_ms:.4f} ms "
              f"({tc_by}, {tc_ms / t_k:.1%})", flush=True)
    kernel_pass_profile(x, wg, wu, wd)
    del wg, wu, wd, outs
    torch.cuda.empty_cache()
    rows.update(kernel_fp32(x))
    moe_ffn_kernel.launches = 0         # comparison launches do not count
    return rows


def row_block_times(x, wg, wu, wd) -> None:
    """The cost of the grouped FFN's row blocks: one prefill's expert FFN
    (Jamba's 1000 rows over 16 experts, a Mixtral serve prompt's 127 rows
    over 8) at three expert-row budgets for bf16 weights, the largest the
    default (``MAX_EXPERT_ROWS_BF16``).  A smaller budget means more calls,
    each of which reads every expert's weights again; a larger one a larger
    workspace."""
    import torch
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    saved = ops.MAX_EXPERT_ROWS_BF16
    for e, n in ((16, JAMBA_PROMPT), (8, 127)):
        h = x[:n]
        slot = torch.stack([torch.randperm(e, generator=gen, device="cuda")[:2]
                            for _ in range(n)]).int()
        gates = torch.rand((n, 2), generator=gen, device="cuda")
        ref = None
        for budget in (1024, 4096, saved):
            ops.MAX_EXPERT_ROWS_BF16 = budget
            rows = min(budget // e, 1 << (n - 1).bit_length())
            ws = moe_kernel.workspace_bytes(e, rows, D_MODEL, D_EXPERT, torch.bfloat16)
            out = ops.grouped_topk_contrib(h, wg[:e], wu[:e], wd[:e], slot, gates)
            if ref is None:
                ref = out
            elif not torch.equal(out, ref):
                fail(f"the grouped FFN's output changed with its row blocks (E={e} N={n})")
            t_ms = median_ms(lambda: ops.grouped_topk_contrib(h, wg[:e], wu[:e], wd[:e],
                                                              slot, gates),
                             iters=3, warmup=1, device_only=False)
            print(f"[kernel] row blocks E={e} N={n}: budget {budget} expert-rows"
                  f"{' (the default)' if budget == saved else ''} -> {-(-n // rows)} call(s) of "
                  f"{rows} rows, workspace {ws / 1e9:.3f} GB a call, {t_ms:.3f} ms (CUDA "
                  f"events, host launches included, median of 3); output bitwise equal across "
                  f"budgets", flush=True)
            del out
        torch.cuda.empty_cache()
    ops.MAX_EXPERT_ROWS_BF16 = saved


def kernel_pass_profile(x, wg, wu, wd):
    """Device time of each launch of the bf16 grouped FFN (split x, gate/up
    with SwiGLU, down) at a decode wave's and a prefill block's shape."""
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel
    for e, c in ((2, 1), (16, 64)):
        xd = x[:c].expand(e, c, D_MODEL).contiguous()
        pass_profile(f"passes at E={e} C={c}",
                     lambda: moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e]))


def pass_bounds_ms(e: int, c: int, gate_up_bytes: int, down_bytes: int) -> dict:
    """Bytes bound of each launch of the CUDA-core passes: gate/up reads x and
    two weight matrices (``gate_up_bytes``) and writes hu; down reads hu and
    one matrix (``down_bytes``) and writes y.  Keyed by the launch's NMAT."""
    act = 4 * e * c * (D_MODEL + D_EXPERT)
    return {2: (gate_up_bytes + act) / HBM_BYTES_PER_S * 1e3,
            1: (down_bytes + act) / HBM_BYTES_PER_S * 1e3}


def pass_profile(label: str, call, bounds: dict = None) -> None:
    """Device time of each launch of one call (``torch.profiler``'s CUDA
    activity, mean of 5 calls); with ``bounds`` (NMAT -> ms), each
    ``ffn_pass`` launch's share of the call and of its own bytes bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    events = [(_kernel_name(ev.key), ev.device_time / 1e3) for ev in prof.key_averages()
              if ev.device_time > 0]
    total = sum(t for _, t in events)
    parts = []
    for name, t in events:
        part = f"{name} {t:.4f} ms"
        if bounds and name.startswith("fpass::ffn_pass<"):
            nmat = int(name.split("<", 1)[1].split(",")[1])
            part += (f" ({t / total:.1%} of the call; bound {bounds[nmat]:.4f} ms, "
                     f"{bounds[nmat] / t:.1%} of it)")
        parts.append(part)
    print(f"[kernel] {label} (torch.profiler, mean of 5): " + "; ".join(parts), flush=True)


def kernel_fp32(x) -> dict:
    """Kernel 1 on fp32 weights at Mixtral widths: against its plain version
    (tolerance), bitwise across E and C, timed beside its bound, its plain
    version and the torch.bmm fp32 formula, its launches profiled."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_ref
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(3)
    wg = torch.randn((8, D_MODEL, D_EXPERT), generator=gen, device=dev) * D_MODEL ** -0.5
    wu = torch.randn((8, D_MODEL, D_EXPERT), generator=gen, device=dev) * D_MODEL ** -0.5
    wd = torch.randn((8, D_EXPERT, D_MODEL), generator=gen, device=dev) * D_EXPERT ** -0.5
    outs, errs = {}, {}
    for e in (1, 2, 8):
        for c in (1, 2, 16):
            xd = x[:c].expand(e, c, D_MODEL).contiguous()
            k = moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e])
            p = moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e])
            torch.cuda.synchronize()
            if not bool(torch.isfinite(k).all()):
                fail(f"fp32 kernel output not finite at E={e} C={c}")
            rel = float((k - p).abs().max() / p.abs().max())
            errs[(e, c)] = float((k - p).abs().max())
            print(f"[kernel] fp32 E={e} C={c:2d}: max|k-p| = {errs[(e, c)]:.3e}, "
                  f"max|k-p|/max|p| = {rel:.3e} (tolerance {KERNEL_TOL:g})")
            if rel > KERNEL_TOL:
                fail(f"fp32 kernel disagrees with its plain version at E={e} C={c}")
            outs[(e, c)] = k
    for (e, c), k in outs.items():
        if not torch.equal(k, outs[(8, 16)][:e, :c]):
            fail(f"fp32 per-(row, expert) outputs at E={e} C={c} differ from E=8 C=16")
    print("[kernel] fp32: per-(row, expert) outputs bitwise equal across E in {1,2,8} and C "
          "in {1,2,16}")

    def formula(xd, e):
        hu = F.silu(torch.bmm(xd, wg[:e])) * torch.bmm(xd, wu[:e])
        return torch.bmm(hu, wd[:e])

    rows = {}
    for e, c in ((2, 1), (8, 1), (8, 16)):
        xd = x[:c].expand(e, c, D_MODEL).contiguous()

        def kern():
            return moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e])

        t_k = time_ms(kern)
        t_p = time_ms(lambda: moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e]), iters=5)
        t_l = time_ms(lambda: formula(xd, e))
        t_k2 = time_ms(kern)
        d_k, d_l = median_ms(kern), median_ms(lambda: formula(xd, e))
        b_ms, b_by = bound_ms(e, c, 4)
        rows[("fp32", e, c)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                                    bound_by=b_by, max_abs_err=errs[(e, c)], device_ms=d_k,
                                    library_device_ms=d_l)
        print(f"[kernel] fp32 time E={e} C={c:2d}: kernel {t_k:.4f} ms (again after the "
              f"formula: {t_k2:.4f} ms), torch.bmm fp32 formula {t_l:.4f} ms ({t_k / t_l:.3f}x), "
              f"plain {t_p:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {b_ms / t_k:.1%} of the "
              f"kernel's time); device time alone (median of 25 single calls queued behind a "
              f"sleep kernel): kernel {d_k:.4f} ms, formula {d_l:.4f} ms ({d_k / d_l:.3f}x)",
              flush=True)
    xd = x[:1].expand(2, 1, D_MODEL).contiguous()
    pass_profile("fp32 passes at E=2 C=1", lambda: moe_ffn_kernel(xd, wg[:2], wu[:2], wd[:2]),
                 pass_bounds_ms(2, 1, 2 * 2 * D_MODEL * D_EXPERT * 4,
                                2 * D_MODEL * D_EXPERT * 4))
    del wg, wu, wd, outs
    torch.cuda.empty_cache()
    return rows


def _kernel_name(key: str) -> str:
    """A profiler key without its return type, anonymous namespace and
    argument list."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0]


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
            d_k = median_ms(lambda: moe_ffn_packed_kernel(xd, pe, scheme=scheme))
            d_k1 = median_ms(lambda: moe_ffn_kernel(xd, *(w[:e] for w in full)))
            d_l = median_ms(lambda: formula(xd, e))
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
                                        nbytes=nbytes, moe_ffn_fp32_ms=t_k1, device_ms=d_k)
            print(f"[packed] time {scheme} E={e} C={c}: kernel {t_k:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}, {nbytes} bytes, {b_ms / t_k:.1%} of the kernel's "
                  f"time), plain {t_p:.4f} ms, torch.bmm fp32 formula on dequantized weights "
                  f"{t_l:.4f} ms, moe_ffn on the same fp32 weights {t_k1:.4f} ms; device time "
                  f"alone (median of 25 single calls queued behind a sleep kernel): kernel "
                  f"{d_k:.4f} ms, formula {d_l:.4f} ms, moe_ffn {d_k1:.4f} ms", flush=True)
            if (scheme, e, c) == ("int8", 2, 1):
                codes = D_MODEL * D_EXPERT                   # a matrix's codes, then scales
                pass_profile("packed int8 passes at E=2 C=1",
                             lambda: moe_ffn_packed_kernel(xd, pe, scheme=scheme),
                             pass_bounds_ms(e, c, 2 * e * (codes + 4 * D_EXPERT),
                                            e * (codes + 4 * D_MODEL)))
        del parts, full
        torch.cuda.empty_cache()
    moe_ffn_packed_kernel.launches = 0     # comparison launches do not count
    moe_ffn_kernel.launches = 0
    return rows


def median_ms(fn, iters: int = 25, warmup: int = 3, device_only: bool = True,
              before=None) -> float:
    """Median time of single launches, CUDA events around each.  With
    ``device_only`` a sleep kernel first holds the stream, so the whole call
    is queued before the start event fires and the events see device time
    alone; without it they also see the host's time to launch it.
    ``before``, if given, is queued before each start event (an L2 flush)."""
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
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_inputs(b, w, dtype, seed, fill=0.8, kh=N_KV, g=GROUP, hd=HEAD_DIM):
    """Ring-buffer caches at Mixtral's attention shapes (or the ``kh`` kv
    heads, ``g`` query heads each and head width ``hd`` given): each row's
    position is past the window for most rows (ring wrap); slot s holds the
    latest position congruent to s, some slots are unfilled (kpos = -1), and
    the slot of ``pos`` itself is always valid, as on the decode path."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, w, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, w, kh, hd), generator=gen, device=dev).to(dtype)
    pos = torch.randint(w // 2, 3 * w, (b,), generator=gen, device=dev, dtype=torch.int32)
    slots = torch.arange(w, device=dev)
    kpos = pos[:, None] - (pos[:, None] - slots[None]) % w
    kpos = torch.where(kpos < 0, -1, kpos)
    drop = torch.rand((b, w), generator=gen, device=dev) > fill
    kpos = torch.where(drop, -1, kpos).to(torch.int32)
    kpos[torch.arange(b, device=dev), (pos % w).long()] = pos
    return q, k, v, kpos.contiguous(), pos


def flash_bound_ms(b, w, itemsize, kh=N_KV, g=GROUP, hd=HEAD_DIM) -> tuple:
    """Least time for flash decode: the K and V caches and kpos read once
    (q and the output are under 0.1% of it), against fp32 FMAs."""
    nbytes = 2 * b * w * kh * hd * itemsize + 4 * b * w
    flops = 2 * 2 * b * w * kh * g * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


# cache widths held against the plain version: Jamba's slice (a 1000-token
# prompt and 8 new tokens) and its serve phase at most (prompts below 1024,
# 8 new tokens, 2 spare slots, in 16-slot pages), besides short and long ones
FLASH_WIDTHS = (32, 1008, 1040, 4096, 32768)


def phase_flash() -> dict:
    """Flash decode against its plain version, row and tail invariance,
    then timed at long windows and at the serve phase's shape."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_kernel, flash_decode_ref
    from repro_torch.kernels.flash_decode import kernel as flash
    chunk = flash.LIBRARY.lib.flash_decode_chunk()
    worst = 0.0
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 4, 16):
            for w in FLASH_WIDTHS:
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
    rows = {(b, w): flash_layout_row("flash", b, w, N_KV, GROUP, HEAD_DIM, seed=3)
            for b, w in ((4, 144), (16, 144), (1, 4096), (4, 32768), (16, 32768))}
    flash_pass_profile(4, 144)
    flash_pass_profile(4, 32768)
    flash_decode_kernel.launches = 0       # comparison launches do not count
    flash.release_scratch()                # the B=16 W=32768 workspace stays out of later peaks
    torch.cuda.empty_cache()
    return rows


def flash_pass_profile(b, w):
    """Device time of the kernel's launches (one since the combine joined
    the chunk pass) at one shape, from ``torch.profiler``'s CUDA activity."""
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
    parts = [f"{_kernel_name(e.key)} {e.device_time / 1e3:.4f} ms x {e.count // 10}"
             for e in prof.key_averages() if e.device_time > 0]
    print(f"[flash] launches at bf16 B={b} W={w} (torch.profiler, mean of 10; x launches a "
          f"call): " + ", ".join(parts))


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
    lc, sc = prefill(cfg, p_cpu, {"tokens": tokens}, 20, moe_method="grouped")
    lg, sg = prefill(cfg, p_gpu, {"tokens": tokens.cuda()}, 20, moe_method="grouped")
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
    from repro_torch.launch.serve import _prompt
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
    args = _single_args(16, 8)
    res = _run_single("slice", cfg, params, args, ("moe_ffn",))
    eng = res["engine"]
    phase_breakdown(cfg, params, eng, res)
    prefill = engine_prefill_ms(eng, cfg, args.prompt_len, args.tokens, args.seed)
    print(f"[slice] engine prefill of the {args.prompt_len}-token prompt (main model, then the "
          f"SEP shadow; CUDA-synchronized host clock, median of 3): {prefill:.3f} ms",
          flush=True)
    return {"launches": res["launches_engine"]["moe_ffn"], "cfg": cfg, "params": params,
            "prefill_ms": prefill, "reference": res["reference"], "tpot_ms": res["tpot_ms"],
            "batch": _prompt(cfg, args.prompt_len, args.seed, "cuda")}


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
    peak, built = out["serving_peak_bytes"] / 1e9, out["build_peak_bytes"] / 1e9
    print(f"[serve] serve_traffic took {time.perf_counter() - t0:.1f} s; peak device memory "
          f"while building the engine and pool {built:.2f} GB, while serving {peak:.2f} GB")
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
    return {"launches": out["launches_serving"], "steps_by_b": steps_by_b(res),
            "peak_gb": peak, "built_gb": built, "outputs": res.outputs}


def steps_by_b(res) -> dict:
    """Median measured composed-step time (ms) and count, by batch size."""
    import statistics
    by_b = {}
    for st in res.steps:
        by_b.setdefault(len(st.request_ids), []).append(st.wall_s * 1e3)
    return {b: (statistics.median(ts), len(ts)) for b, ts in sorted(by_b.items())}


def fmt_steps(by_b: dict) -> str:
    return " / ".join(f"B={b} {ms:.3f} ms (n={n})" for b, (ms, n) in by_b.items())


def host_copy_rate(store, layer) -> tuple:
    """One expert's pinned host -> card load, alone: (ms, GB/s)."""
    ms = _median_ms(lambda: store.unpack_shard(layer, 0))
    return ms, store.packed_bytes(layer, 0) / ms / 1e6


# (name, prefetch, residency), an int being a ChaosExecutor seed.  The
# first engine of each residency group sets the load events and bytes that
# the others in the group are held to.
PREFETCH_RUNS = (
    ("none", None, None), ("sync", "sync", None), ("thread", "thread", None),
    ("chaos-1", 1, None), ("chaos-2", 2, None),
    ("sync+lru", "sync", "lru"), ("thread+lru", "thread", "lru"),
    ("sync+gate", "sync", "gate"), ("thread+gate", "thread", "gate"))


def phase_prefetch(cfg, params) -> dict:
    """The slice's engine with each executor and residency policy: tokens
    equal greedy_generate, and every executor's load events and bytes equal
    the first engine's of the same residency policy.  The engines share one
    expert store, which packs the experts once."""
    import statistics
    import torch
    from repro_torch.core import ChaosExecutor, ExpertStore, ODMoEEngine
    from repro_torch.launch.serve import KERNELS
    from repro_torch.models import greedy_generate
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                                     dtype=torch.int32).cuda()}
    ref = greedy_generate(cfg, params, batch, 8)
    store = ExpertStore(cfg, params)
    copy_ms, copy_gbps = host_copy_rate(store, store.moe_layers[0])
    print(f"[prefetch] host copy rate: one expert ({store.packed_bytes(store.moe_layers[0], 0)} "
          f"bytes, pinned host -> card) {copy_ms:.3f} ms = {copy_gbps:.2f} GB/s", flush=True)
    out, base = {"runs": {}, "copy_gbps": copy_gbps, "launches": {}}, {}
    for name, prefetch, residency in PREFETCH_RUNS:
        executor = ChaosExecutor(prefetch) if isinstance(prefetch, int) else prefetch
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        eng = ODMoEEngine(cfg, params, n_workers=8, predictor="sep", shadow_scheme="int8",
                          device="cuda", prefetch=executor, residency=residency, store=store)
        built = torch.cuda.max_memory_allocated() / 1e9     # while the engine was built
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated() / 1e9
        toks, trace = eng.generate(batch, 8)
        eng.close()
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not torch.equal(toks, ref):
            fail(f"prefetch run {name}: engine tokens differ from greedy_generate")
        if launches["moe_ffn"] <= 0:
            fail(f"prefetch run {name}: the engine did not launch moe_ffn")
        events = [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes)
                  for e in eng.slots.events]
        if residency not in base:
            base[residency] = (events, eng.slots.bytes_moved)
        elif (events, eng.slots.bytes_moved) != base[residency]:
            fail(f"prefetch run {name}: load events or bytes differ from those of the first "
                 f"engine with residency {residency}")
        rep = eng.prefetch_report()
        tpot = statistics.median(r.seconds for r in trace.records) * 1e3
        out["runs"][name] = dict(tpot_ms=tpot, peak_gb=peak, built_gb=built, report=rep)
        out["launches"] = launches
        counters = {k: rep.get(f"prefetch_{k}") for k in ("prefetched", "inline",
                                                          "demand_fetches", "stale")}
        print(f"[prefetch] {name:11s}: tokens == greedy_generate, events/bytes == first: "
              f"True; TPOT median {tpot:.3f} ms; loads {eng.slots.stats['loads']}, "
              f"bytes_moved {eng.slots.bytes_moved}; prefetch {counters}; rehits "
              f"{rep['residency_rehits']}, rehit_rate {rep['rehit_rate']:.4f}; device memory: "
              f"peak while building the engine {built:.2f} GB, before decoding {resting:.2f} GB, "
              f"peak while decoding {peak:.2f} GB; moe_ffn launches {launches['moe_ffn']}",
              flush=True)
        if name in ("none", "sync", "thread"):
            copy_overlap_profile(name, eng, batch)
            eng.close()
        del eng, toks, trace
    del store
    return out


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(spans) -> float:
    return sum(b - a for a, b in spans)


def _intersection(xs, ys) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def copy_overlap_profile(name, eng, batch) -> None:
    """One more decode of the engine under ``torch.profiler``: how long the
    card copied host -> device, how long it ran kernels, how much of the
    copying overlapped kernels, and its idle share over the decode."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(batch, 8)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"[prefetch] {name}: torch.profiler recorded no device activity")
        return
    copies = _union([(e.time_range.start, e.time_range.end) for e in dev
                     if "HtoD" in e.name])
    kernels = _union([(e.time_range.start, e.time_range.end) for e in dev
                      if not e.name.startswith(("Memcpy", "Memset"))])
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    span = max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
    print(f"[prefetch] {name}: profile of one more decode (prefill included, torch.profiler): "
          f"host->device copies {_length(copies) / 1e3:.3f} ms, kernels "
          f"{_length(kernels) / 1e3:.3f} ms, copies overlapping kernels "
          f"{_intersection(copies, kernels) / 1e3:.3f} ms; device idle "
          f"{1 - _length(busy) / span:.1%} of {span / 1e3:.3f} ms", flush=True)


def phase_prefetch_serve(cfg, params, sync_steps: dict) -> dict:
    """The serve phase's traffic with a threaded prefetch executor and LRU
    residency."""
    import math
    import torch
    from repro_torch.launch.serve import KERNELS, build_parser, serve_traffic
    from repro_torch.serve import make_traffic
    max_batch, page_tokens = 4, 16
    reqs = make_traffic(cfg, 8, 0.0, prompt_len=128, max_new=8, seed=SERVE_SEED)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pages = math.ceil(window / page_tokens) * max_batch // 2
    args = build_parser().parse_args(
        ["--requests", "8", "--arrival-rate", "0", "--prompt-len", "128", "--tokens", "8",
         "--max-batch", str(max_batch), "--compose", "overlap", "--predictor", "sep",
         "--shadow", "int8", "--transport-precision", "fp32", "--workers", "8",
         "--seed", str(SERVE_SEED), "--kv-pages", str(pages),
         "--page-tokens", str(page_tokens)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = serve_traffic(cfg, params, args, prefetch="thread", residency="lru")
    every = {name: k.launches for name, k in KERNELS.items()}
    res = out["result"]
    peak, built = out["serving_peak_bytes"] / 1e9, out["build_peak_bytes"] / 1e9
    for name in ("moe_ffn", "flash_decode"):
        if out["launches_serving"][name] <= 0:
            fail(f"prefetch-serve: {name} did not launch on the serving side")
    st = res.prefetch_stats
    if st is None or st["executor"] != "thread" or st["residency"] != "lru":
        fail(f"prefetch-serve: no threaded prefetch report ({st})")
    by_b = steps_by_b(res)
    print(f"[prefetch-serve] serve_traffic took {time.perf_counter() - t0:.1f} s; tokens of "
          f"all {len(reqs)} requests == solo greedy_generate; mean batch {res.mean_batch:.2f}; "
          f"peak device memory while building the engine and pool {built:.2f} GB, while "
          f"serving {peak:.2f} GB; launches (engine+shadow) "
          f"{out['launches_serving']} (all {every})")
    print(f"[prefetch-serve] composed step (thread+lru): {fmt_steps(by_b)}; synchronous serve "
          f"phase of this run: {fmt_steps(sync_steps)}")
    print(f"[prefetch-serve] prefetch_stats {st}", flush=True)
    return {"steps_by_b": by_b, "peak_gb": peak, "built_gb": built, "stats": st,
            "launches": out["launches_serving"]}


# (name, speculate, token period, kv period): the yardstick first, then
# per-step alignment at k = 2 and 4, then a free-running shadow, whose
# drafts the main model rejects
SPEC_RUNS = (("k=1", 1, 1, 1), ("k=2", 2, 1, 1), ("k=4", 4, 1, 1), ("k=4 free", 4, 0, 0))
SPEC_PROMPT, SPEC_TOKENS = 16, 9     # 8 decoded tokens: a multiple of neither width


def phase_spec(cfg, params) -> dict:
    """Speculative decoding through ``serve_single`` on the slice's
    parameters: every run's tokens equal ``greedy_generate`` and its waves
    commit ``tokens - 1``; the verify rows of a wave equal one-token rows
    bit for bit through the flash-decode kernel; the kernel timed at the
    verify shape."""
    import torch
    from repro_torch.launch.serve import KERNELS, build_parser, serve_single
    out = {"runs": {}, "launches": {name: 0 for name in KERNELS}}
    for name, k, tp, kp in SPEC_RUNS:
        args = build_parser().parse_args(
            ["--prompt-len", str(SPEC_PROMPT), "--tokens", str(SPEC_TOKENS), "--predictor",
             "sep", "--shadow", "int8", "--transport-precision", "fp32", "--workers", "8",
             "--seed", "0", "--speculate", str(k), "--token-period", str(tp),
             "--kv-period", str(kp)])
        gc.collect()
        torch.cuda.empty_cache()
        _reset_launches()
        res = serve_single(cfg, params, args)      # raises unless tokens == greedy_generate
        launches = res["launches_engine"]
        trace, eng = res["trace"], res["engine"]
        drafted = sum(r.spec_len for r in trace.records)
        committed = sum(r.committed for r in trace.records)
        if committed != SPEC_TOKENS - 1:
            fail(f"spec {name}: waves committed {committed} tokens, not {SPEC_TOKENS - 1}")
        if not torch.equal(res["tokens"].cpu(), res["reference"].cpu()):
            fail(f"spec {name}: engine tokens differ from greedy_generate")
        if k > 1:
            for kern in ("moe_ffn", "flash_decode"):
                if launches[kern] <= 0:
                    fail(f"spec {name}: {kern} did not launch on the spec path")
                out["launches"][kern] += launches[kern]
        wall = sum(r.seconds for r in trace.records)
        run = dict(waves=len(trace.records), drafted=drafted, committed=committed,
                   acceptance=committed / drafted, rejected=drafted - committed,
                   loads_per_token=eng.slots.stats["loads"] / committed,
                   bytes_per_token=eng.slots.bytes_moved / committed,
                   ms_per_token=wall / committed * 1e3, launches=launches)
        out["runs"][name] = run
        print(f"[spec] {name:8s}: tokens == greedy_generate; {run['waves']} waves, acceptance "
              f"{committed}/{drafted} = {run['acceptance']:.3f}, rejected rows "
              f"{run['rejected']}; per committed token: {run['loads_per_token']:.3f} loads, "
              f"{run['bytes_per_token'] / 1e9:.3f} GB, decode wall time "
              f"{run['ms_per_token']:.3f} ms; launches (engine+shadow) moe_ffn "
              f"{launches['moe_ffn']}, flash_decode {launches['flash_decode']}", flush=True)
        del res, trace, eng
    base = out["runs"]["k=1"]["ms_per_token"]
    print("[spec] decode wall time per committed token against k=1 in this call: "
          + ", ".join(f"{n} {r['ms_per_token'] / base:.3f}x" for n, r in out["runs"].items()))
    out.update(spec_verify_rows(cfg, params))
    return out


def spec_verify_rows(cfg, params) -> dict:
    """A verify wave of B=1, S=4 at W=25 (the spec runs' window) on the
    slice's first attention layer: each row equals ``attn_decode`` on the
    cache sequential decode holds, bit for bit, through the kernel; the
    kernel at that shape agrees with its plain version within
    ``KERNEL_TOL``; then it is timed beside its plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import spec_attn_decode
    from repro_torch.kernels.flash_decode import flash_decode_kernel, flash_decode_ref
    from repro_torch.models.attention import attn_decode, decode_qkv, init_cache
    from repro_torch.models.transformer import layer_params
    S, w, base = 4, SPEC_PROMPT + SPEC_TOKENS, SPEC_PROMPT
    mixer = layer_params(cfg, params, 0)["mixer"]
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((S, 1, cfg.d_model), generator=gen, device="cuda").to(dt)
    cache = init_cache(cfg, 1, w, dt, "cuda")
    cache["k"][0, :base] = torch.randn((base, N_KV, HEAD_DIM), generator=gen, device="cuda").to(dt)
    cache["v"][0, :base] = torch.randn((base, N_KV, HEAD_DIM), generator=gen, device="cuda").to(dt)
    cache["pos"][0, :base] = torch.arange(base, device="cuda", dtype=torch.int32)
    pos = torch.arange(base, base + S, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        before = flash_decode_kernel.launches
        out, wave = spec_attn_decode(cfg, mixer, x, cache, pos, S)
        if flash_decode_kernel.launches != before + 1:
            fail("the verify wave did not run as one flash-decode launch")
        seq = cache
        for s in range(S):
            one, seq = attn_decode(cfg, mixer, x[s:s + 1], seq, pos[s:s + 1])
            if not torch.equal(one, out[s:s + 1]):
                fail(f"verify row {s} differs from the one-token attn_decode row")
            for n in ("k", "v", "pos"):
                if not torch.equal(seq[n], wave[n][s:s + 1]):
                    fail(f"verify row {s}'s cache {n} differs from sequential decode's")
        q, _, _ = decode_qkv(cfg, mixer, x, pos)
    q = q[:, 0].reshape(S, N_KV, GROUP, HEAD_DIM).contiguous()
    k, v, kpos = wave["k"], wave["v"], wave["pos"]
    qs = q.reshape(S, N_KV * GROUP, 1, HEAD_DIM)
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = ((kpos >= 0) & (kpos <= pos[:, None]))[:, None, None, :]
    o = flash_decode_kernel(q, k, v, kpos, pos)
    p = flash_decode_ref(q, k, v, kpos, pos)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(o).all()):
        fail(f"flash output not finite at the verify shape (B*S={S}, W={w})")
    err = float((o - p).abs().max())
    rel = err / float(p.abs().max())
    if rel > KERNEL_TOL:
        fail(f"flash kernel disagrees with its plain version at the verify shape "
             f"(B*S={S}, W={w}): {rel:.3e}")
    t_k = median_ms(lambda: flash_decode_kernel(q, k, v, kpos, pos))
    t_p = median_ms(lambda: flash_decode_ref(q, k, v, kpos, pos), iters=20)
    t_l = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                           enable_gqa=True))
    b_ms, b_by, nbytes = flash_bound_ms(S, w, 2)
    print(f"[spec] verify wave B=1 S={S} W={w} ({cfg.dtype}, layer 0): every row == the "
          f"one-token attn_decode row and its cache == sequential decode's, bitwise, through "
          f"the kernel (one launch)")
    print(f"[spec] flash_decode at the verify shape (B*S={S} rows, W={w}, bf16): kernel "
          f"{t_k:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes} bytes), plain {t_p:.4f} ms, "
          f"scaled_dot_product_attention {t_l:.4f} ms (device time, median of 25 / 20 / 25 "
          f"launches); max|k-p| {err:.3e}, max|k-p|/max|p| {rel:.3e} (tolerance "
          f"{KERNEL_TOL:g})", flush=True)
    flash_decode_kernel.launches = 0         # comparison launches do not count
    return {"verify": dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=err)}


def phase_spec_serve(cfg, params, sync_steps: dict) -> dict:
    """The serve phase's traffic with ``--speculate 2``: every request
    equals its solo decode and commits ``max_new_tokens - 1`` in waves."""
    import math
    import torch
    from repro_torch.launch.serve import build_parser, serve_traffic
    from repro_torch.serve import make_traffic
    max_batch, page_tokens = 4, 16
    reqs = make_traffic(cfg, 8, 0.0, prompt_len=128, max_new=8, seed=SERVE_SEED)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pages = math.ceil(window / page_tokens) * max_batch // 2
    args = build_parser().parse_args(
        ["--requests", "8", "--arrival-rate", "0", "--prompt-len", "128", "--tokens", "8",
         "--max-batch", str(max_batch), "--compose", "overlap", "--predictor", "sep",
         "--shadow", "int8", "--transport-precision", "fp32", "--workers", "8",
         "--seed", str(SERVE_SEED), "--kv-pages", str(pages),
         "--page-tokens", str(page_tokens), "--speculate", "2"])
    gc.collect()
    torch.cuda.empty_cache()
    _reset_launches()
    t0 = time.perf_counter()
    out = serve_traffic(cfg, params, args)       # raises unless every request == solo
    res = out["result"]
    for name in ("moe_ffn", "flash_decode"):
        if out["launches_serving"][name] <= 0:
            fail(f"spec-serve: {name} did not launch on the serving side")
    ss = res.spec_stats
    if ss is None or ss["speculate"] != 2:
        fail(f"spec-serve: no speculation stats ({ss})")
    for r in reqs:
        if ss["per_request"][r.rid]["committed"] != r.max_new_tokens - 1:
            fail(f"spec-serve: request {r.rid} committed "
                 f"{ss['per_request'][r.rid]['committed']}, not {r.max_new_tokens - 1}")
    by_b = steps_by_b(res)
    st = res.kv_stats
    print(f"[spec-serve] serve_traffic took {time.perf_counter() - t0:.1f} s; tokens of all "
          f"{len(reqs)} requests == solo greedy_generate; each committed max_new_tokens - 1 in "
          f"waves; acceptance {ss['acceptance']:.3f} over {ss['waves']} request-waves; mean "
          f"batch {res.mean_batch:.2f} over {len(res.steps)} composed steps; preemptions "
          f"{st['preemptions']}; peak device memory while serving "
          f"{out['serving_peak_bytes'] / 1e9:.2f} GB; launches (engine+shadow) "
          f"{out['launches_serving']}")
    print(f"[spec-serve] composed step (k=2): {fmt_steps(by_b)}; synchronous serve phase of "
          f"this run: {fmt_steps(sync_steps)}", flush=True)
    return {"steps_by_b": by_b, "stats": ss, "launches": out["launches_serving"],
            "peak_gb": out["serving_peak_bytes"] / 1e9,
            "built_gb": out["build_peak_bytes"] / 1e9}


# The fleet phase's heterogeneous fleet: workers 0-3 hold two expert slots
# on 24 GB/s links, workers 4-7 one slot on 12 GB/s links (groups of 2).
FLEET_KILL_STEP, FLEET_RECOVER_STEP, FLEET_KILL_LAYER = 2, 5, 1
# (name, prefetch, residency): the synchronous engine, the synchronous
# engine with LRU residency, and the threaded executor held to the latter
FLEET_RUNS = (("sync", None, None), ("sync+lru", None, "lru"), ("thread+lru", "thread", "lru"))


def fleet_profiles():
    from repro_torch.fleet import WorkerProfile
    return tuple(WorkerProfile(w, link_gbps=24.0 if w < 4 else 12.0, capacity=2 if w < 4 else 1)
                 for w in range(8))


def alive_by_step(script, steps, n_workers: int) -> list:
    """Alive workers after each step's faults, replayed from the script
    alone (no engine): what ``StepRecord.alive_workers`` must read."""
    from repro_torch.fleet import FaultInjector, FleetState
    state, inj, out = FleetState.fresh(n_workers), FaultInjector(script), []
    for step in steps:
        inj.apply_step_all(step, state)
        out.append(state.n_alive)
    return out


def loads_on_dead_workers(events, script, moe_index_of: dict) -> list:
    """Load events that landed on a worker while it was dead, reckoned from
    the script and the event order alone.  Within a step, a step-scoped
    event fires before every load, a mid-layer kill after its layer's
    predicted loads and before its reloads."""
    # (step, MoE layer, phase): phase 0 predicted loads, 1 a mid-layer
    # event, 2 reloads; a step-scoped event comes before every layer
    marks = sorted(((ev.step, -1, 0) if ev.moe_index is None else (ev.step, ev.moe_index, 1),
                    ev.worker, ev.kind) for ev in script if ev.kind in ("kill", "recover"))
    bad = []
    for e in events:
        key = (e.token, moe_index_of[e.layer], 0 if e.predicted else 2)
        state = [kind for mark, w, kind in marks if w == e.worker and mark < key]
        if state and state[-1] == "kill":
            bad.append(e)
    return bad


def phase_fleet(cfg, params, slice_run: dict) -> dict:
    """The slice's model on a heterogeneous fleet under a fault script: a
    mid-layer kill that strands a predicted expert, its recovery and a
    throttle, through the synchronous engine, the synchronous engine with
    LRU residency and the threaded executor with LRU residency, all on one
    expert store."""
    import statistics
    import torch
    from repro_torch.core import (RTX3090_EDGE, ExpertStore, ODMoEEngine, degraded_tpot_report,
                                  simulate_odmoe)
    from repro_torch.fleet import FaultEvent, FaultInjector, FleetSchedule
    from repro_torch.launch.serve import KERNELS
    profiles = fleet_profiles()
    # the worker that takes MoE layer 1's first predicted expert: killed
    # right after that load, it strands the expert
    victim = FleetSchedule(8, 2, profiles=profiles).load_targets(FLEET_KILL_LAYER)[0]
    script = [FaultEvent(FLEET_KILL_STEP, victim, "kill", moe_index=FLEET_KILL_LAYER),
              FaultEvent(FLEET_RECOVER_STEP, victim, "recover"),
              FaultEvent(3, 6, "throttle", factor=0.25)]
    batch, ref = slice_run["batch"], slice_run["reference"]
    print(f"[fleet] profiles (worker, link GB/s, slots): "
          f"{[(p.worker, p.link_gbps, p.capacity) for p in profiles]}; groups of 2")
    print(f"[fleet] fault script: {script}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    store = ExpertStore(cfg, params)
    print(f"[fleet] expert store packed in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"runs": {}, "launches": {name: 0 for name in KERNELS}, "store": store}
    base_events = None
    for name, prefetch, residency in FLEET_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        eng = ODMoEEngine(cfg, params, n_workers=8, predictor="sep", shadow_scheme="int8",
                          device="cuda", prefetch=prefetch, residency=residency, store=store,
                          profiles=profiles, faults=FaultInjector(script))
        moe_index_of = {li: i for i, li in enumerate(eng.moe_layers)}
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        toks, trace = eng.generate(batch, 8)
        eng.close()
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        for n in launches:
            out["launches"][n] += launches[n]
        st = eng.slots.stats
        if not torch.equal(toks, ref):
            fail(f"fleet {name}: engine tokens differ from greedy_generate")
        if launches["moe_ffn"] <= 0:
            fail(f"fleet {name}: the engine did not launch moe_ffn")
        if (st["failures"], st["recoveries"]) != (1, 1):
            fail(f"fleet {name}: stats {st}, not one failure and one recovery")
        reloads_at_kill = sum(1 for e in eng.slots.events
                              if e.token == FLEET_KILL_STEP and not e.predicted)
        if name == "sync" and (st["failure_drops"] < 1 or reloads_at_kill < 1):
            fail(f"fleet {name}: the kill stranded nothing or nothing reloaded at step "
                 f"{FLEET_KILL_STEP} (stats {st})")
        dead = loads_on_dead_workers(eng.slots.events, script, moe_index_of)
        if dead:
            fail(f"fleet {name}: loads on a dead worker: {dead}")
        events = [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes, e.scheme)
                  for e in eng.slots.events]
        if name == "sync+lru":
            base_events = events
        elif name == "thread+lru" and events != base_events:
            fail("fleet thread+lru: load events differ from the synchronous engine's "
                 "(sync+lru)")
        steps = len(trace.records)
        alive = alive_by_step(script, [r.index for r in trace.records], 8)
        wall = degraded_tpot_report([r.seconds for r in trace.records], alive, 8)
        modelled = simulate_odmoe(cfg, trace, eng.sched, RTX3090_EDGE, shadow_scheme="int8",
                                  faults=FaultInjector(script)).degraded_report(8)
        moved = [0] * 8
        for e in eng.slots.events:
            moved[e.worker] += e.bytes
        slot_bytes = [eng.slots.slot_unit_bytes() * c for c in eng.slots.capacity]
        tpot = statistics.median(r.seconds for r in trace.records) * 1e3
        per_step = [(r.index, round(r.seconds * 1e3, 3), "degraded" if a < 8 else "healthy")
                    for r, a in zip(trace.records, alive)]
        run = dict(tpot_ms=tpot, per_step=per_step, healthy_ms=wall["tpot_healthy_s"] * 1e3,
                   degraded_ms=wall["tpot_degraded_s"] * 1e3,
                   degraded_steps=wall["degraded_steps"], loads_per_token=st["loads"] / steps,
                   reloads_per_token=st["reloads"] / steps, reloads_at_kill=reloads_at_kill,
                   peak_gb=peak, modelled=modelled, stats=dict(st), moved=moved,
                   per_worker_bytes=eng.memory_report()["per_worker_bytes"])
        out["runs"][name] = run
        print(f"[fleet] {name:10s}: tokens == greedy_generate: True; no load on a dead worker; "
              f"stats {st}; fired {len(eng.faults.applied)} events; alive after each step "
              f"{alive}", flush=True)
        print(f"[fleet] {name:10s}: TPOT (card's own wall time, mean) healthy "
              f"{run['healthy_ms']:.3f} ms over {steps - wall['degraded_steps']} steps, degraded "
              f"{run['degraded_ms']:.3f} ms over {wall['degraded_steps']} steps, median of all "
              f"{tpot:.3f} ms; per token {run['loads_per_token']:.3f} loads, "
              f"{run['reloads_per_token']:.3f} reloads ({reloads_at_kill} reloads at the kill "
              f"step {FLEET_KILL_STEP}); peak device memory while decoding {peak:.2f} GB; "
              f"moe_ffn launches {launches['moe_ffn']}", flush=True)
        print(f"[fleet] {name:10s}: per-step wall time (card's own, ms) {per_step}")
        print(f"[fleet] {name:10s}: bytes moved per worker {moved}; slot bytes provisioned per "
              f"worker {slot_bytes} (memory_report per_worker_bytes "
              f"{run['per_worker_bytes']})")
        print(f"[fleet] {name:10s}: modelled ({RTX3090_EDGE.name} profile, not measured) "
              f"degraded_report {modelled}", flush=True)
        del eng, toks, trace
    if out["runs"]["thread+lru"]["stats"] != out["runs"]["sync+lru"]["stats"]:
        fail("fleet thread+lru: slot stats differ from the synchronous engine's (sync+lru)")
    print("[fleet] thread+lru load events and stats == sync+lru's: True")
    return out


FLEET_SERVE_KILL_STEP = 6


def phase_fleet_serve(cfg, params, serve: dict, store) -> dict:
    """The serve phase's traffic and pool on a uniform 8-worker fleet that
    loses worker 2 at global step 3, and at step 6 the worker taking MoE
    layer 0's first predicted expert, right after that load; worker 2
    comes back at step 9.  Every request must equal the serve phase's
    output for it (which equalled its solo decode), and the mid-layer kill
    must strand an expert that then reloads."""
    import math
    import numpy as np
    import torch
    from repro_torch.core import ODMoEEngine
    from repro_torch.fleet import FaultEvent, FaultInjector, FleetSchedule
    from repro_torch.launch.serve import KERNELS
    from repro_torch.serve import BatchComposer, KVPool, ServingLoop, make_traffic
    max_batch, page_tokens = 4, 16
    reqs = make_traffic(cfg, 8, 0.0, prompt_len=128, max_new=8, seed=SERVE_SEED)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pages = math.ceil(window / page_tokens) * max_batch // 2
    # a step-scoped kill finds the cacheless engine's slots empty (it
    # evicts after each layer); only a kill between a layer's predicted
    # loads and its waves strands an expert
    victim = FleetSchedule(8, 2).load_targets(0)[0]
    script = [FaultEvent(3, 2, "kill"),
              FaultEvent(FLEET_SERVE_KILL_STEP, victim, "kill", moe_index=0),
              FaultEvent(9, 2, "recover")]
    print(f"[fleet-serve] fault script: {script}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ODMoEEngine(cfg, params, n_workers=8, predictor="sep", shadow_scheme="int8",
                      device="cuda", store=store, faults=FaultInjector(script))
    pool = KVPool(cfg, num_pages=pages, page_tokens=page_tokens, device="cuda")
    loop = ServingLoop(eng, max_batch=max_batch,
                       composer=BatchComposer(max_batch, "overlap", kv_pool=pool), kv_pool=pool)
    _reset_launches()
    t0 = time.perf_counter()
    res = loop.run(reqs)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in KERNELS.items()}
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs:
        if not np.array_equal(res.outputs[r.rid], serve["outputs"][r.rid]):
            fail(f"fleet-serve: request {r.rid} differs from its solo decode")
    alive = [s.alive_workers for s in res.steps]
    want = alive_by_step(script, [s.step for s in res.steps], 8)
    runs = [a for i, a in enumerate(alive) if i == 0 or a != alive[i - 1]]
    if alive != want or runs != [8, 7, 6, 7]:
        fail(f"fleet-serve: alive workers by step {alive}, the script gives {want}")
    for name in ("moe_ffn", "flash_decode"):
        if launches[name] <= 0:
            fail(f"fleet-serve: {name} did not launch")
    st = eng.slots.stats
    if (st["failures"], st["recoveries"]) != (2, 1):
        fail(f"fleet-serve: stats {st}, not two failures and one recovery")
    at_kill = [e for e in eng.slots.events if e.token == FLEET_SERVE_KILL_STEP]
    stranded = [e.expert for e in at_kill if e.predicted and e.worker == victim and e.layer ==
                eng.moe_layers[0]]
    reloads = [(e.layer, e.expert, e.worker) for e in at_kill if not e.predicted]
    dead = loads_on_dead_workers(eng.slots.events, script,
                                 {li: i for i, li in enumerate(eng.moe_layers)})
    if dead:
        fail(f"fleet-serve: loads on a dead worker: {dead}")
    if st["failure_drops"] < 1 or not reloads:
        fail(f"fleet-serve: the kill of worker {victim} at step {FLEET_SERVE_KILL_STEP} stranded "
             f"nothing or nothing reloaded then (stats {st})")
    by_b = steps_by_b(res)
    rep = res.degraded_report()
    print(f"[fleet-serve] ServingLoop.run took {took:.1f} s; tokens of all {len(reqs)} requests "
          f"== solo greedy_generate (the serve phase's outputs); mean batch "
          f"{res.mean_batch:.2f} over {len(res.steps)} composed steps; preemptions "
          f"{res.kv_stats['preemptions']}; alive workers by step {alive}; stats {st}; peak "
          f"device memory {peak:.2f} GB")
    print(f"[fleet-serve] step {FLEET_SERVE_KILL_STEP}: worker {victim} held experts {stranded} "
          f"of MoE layer 0 when it died; reloads then (layer, expert, worker) {reloads}")
    print(f"[fleet-serve] composed step (card's own wall time): {fmt_steps(by_b)}; serve phase "
          f"of this run: {fmt_steps(serve['steps_by_b'])}")
    print(f"[fleet-serve] modelled degraded_report() (rtx3090-edge profile, not measured): {rep}")
    print(f"[fleet-serve] launches (engine+shadow): moe_ffn {launches['moe_ffn']}, flash_decode "
          f"{launches['flash_decode']}", flush=True)
    return {"launches": launches, "steps_by_b": by_b, "report": rep, "peak_gb": peak}


def _decode_run(eng, batch, ref, label: str) -> dict:
    """Decode the slice prompt on ``eng`` (8 tokens), hold it to the slice's
    ``greedy_generate`` and return its trace, TPOT, peak memory and launches."""
    import statistics
    import torch
    from repro_torch.launch.serve import KERNELS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    toks, trace = eng.generate(batch, 8)
    eng.close()
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in KERNELS.items()}
    if not torch.equal(toks, ref):
        fail(f"{label}: engine tokens differ from greedy_generate")
    if launches["moe_ffn"] <= 0:
        fail(f"{label}: the engine did not launch moe_ffn")
    return {"trace": trace, "tpot_ms": statistics.median(r.seconds for r in trace.records) * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
            "loads_per_token": eng.slots.stats["loads"] / len(trace.records)}


def phase_placement(cfg, params, slice_run: dict, store) -> dict:
    """Gate-statistics placement: calibrate a ``GateStatsRecorder`` on the
    slice prompt, optimize a plan for 8 workers in groups of 2, and decode
    the prompt under it, synchronously and with the threaded executor."""
    from repro_torch.core import ODMoEEngine
    from repro_torch.fleet import (FleetSchedule, GateStatsRecorder, expected_t_maxload,
                                   modulo_plan, optimize_placement)
    batch, ref = slice_run["batch"], slice_run["reference"]
    rec = GateStatsRecorder()
    cal = ODMoEEngine(cfg, params, n_workers=8, predictor="sep", shadow_scheme="int8",
                      device="cuda", store=store, gate_stats=rec)
    _decode_run(cal, batch, ref, "placement calibration")
    del cal
    base = FleetSchedule(8, 2)
    kw = dict(num_experts=cfg.num_experts, n_moe=rec.n_layers)
    bkw = dict(kw, expert_bytes=store.expert_bytes)
    plan = optimize_placement(rec, base, **bkw)
    e_opt = expected_t_maxload(plan, rec, base, **bkw)
    e_mod = expected_t_maxload(modulo_plan(base, **kw), rec, base, **bkw)
    print(f"[placement] gate statistics of 8 tokens over {rec.n_layers} MoE layers: counts "
          f"{rec.counts}; plan orders {plan.orders}; expert -> worker {plan.expert_workers}")
    print(f"[placement] expected t_maxload (modelled, {base.link_gbps_of(0):g} GB/s links, "
          f"{store.expert_bytes} bytes an expert): plan {e_opt * 1e3:.4f} ms, modulo "
          f"{e_mod * 1e3:.4f} ms", flush=True)
    runs, launches = {}, 0
    for name, prefetch in (("sync", None), ("thread", "thread")):
        eng = ODMoEEngine(cfg, params, predictor="sep", shadow_scheme="int8", device="cuda",
                          store=store, prefetch=prefetch, sched=FleetSchedule(8, 2, plan=plan))
        run = _decode_run(eng, batch, ref, f"placement {name}")
        run["events"] = [(e.token, e.layer, e.expert, e.worker, e.predicted, e.bytes)
                         for e in eng.slots.events]
        launches += run["launches"]["moe_ffn"]
        runs[name] = run
        del eng
    if runs["thread"]["events"] != runs["sync"]["events"]:
        fail("placement: the threaded run's load events differ from the synchronous run's")
    moe_of = {li: i for i, li in enumerate(store.moe_layers)}
    pinned = outside = 0
    taken = {}
    for tok, layer, e, w, predicted, _ in runs["sync"]["events"]:
        if not predicted:
            continue
        m = moe_of[layer]
        used = taken.setdefault((tok, layer), set())
        want = plan.worker_of(m, e)
        if want not in used:            # the planned worker is alive with a free slot
            if w != want:
                fail(f"placement: step {tok} layer {layer} expert {e} loaded on worker {w}, "
                     f"the plan's worker {want} was free")
            pinned += 1
        used.add(w)
        if w not in base.workers_of_group(base.group_of(m)):
            outside += 1
    if outside < 1:
        fail("placement: no predicted load landed outside its modulo home group")
    for name, run in runs.items():
        print(f"[placement] {name:6s}: tokens == greedy_generate: True; TPOT median "
              f"{run['tpot_ms']:.3f} ms (slice phase, this call: {slice_run['tpot_ms']:.3f} ms); "
              f"{run['loads_per_token']:.3f} loads a token; peak device memory "
              f"{run['peak_bytes'] / 1e9:.2f} GB; moe_ffn launches {run['launches']['moe_ffn']}")
    print(f"[placement] thread events == sync events: True; {pinned} predicted loads on their "
          f"planned worker, {outside} outside their modulo home group", flush=True)
    return {"plan": plan, "launches": launches, "e_opt": e_opt, "e_mod": e_mod}


def phase_cvs(cfg, params, slice_run: dict, store) -> dict:
    """Compute-vs-ship with no predictor on 8 uniform workers in groups of 2:
    at 24 GB/s every cold expert is hosted (14.68 ms to ship, 8.39 ms from
    host memory at 42 GB/s); at 100 GB/s (3.52 ms) every expert ships."""
    from repro_torch.core import RTX3090_EDGE, ODMoEEngine, simulate_odmoe
    from repro_torch.fleet import WorkerProfile
    batch, ref = slice_run["batch"], slice_run["reference"]
    runs, launches = {}, 0
    for gbps in (24.0, 100.0):
        eng = ODMoEEngine(cfg, params, predictor="none", device="cuda", store=store,
                          compute_vs_ship=True,
                          profiles=[WorkerProfile(w, link_gbps=gbps) for w in range(8)])
        t_ship = eng.sched.t_load_s(0, store.packed_bytes(store.moe_layers[0], 0))
        t_host = store.expert_bytes / (eng.cvs_gbps * 1e9)
        run = _decode_run(eng, batch, ref, f"cvs {gbps:g} GB/s")
        trace = run["trace"]
        hosted = [len(lr.hosted) for r in trace.records for lr in r.layers]
        reloads = sum(lr.reloads for r in trace.records for lr in r.layers)
        if gbps == 24.0 and (reloads or eng.slots.bytes_moved or set(hosted) != {2}):
            fail(f"cvs 24 GB/s: reloads {reloads}, bytes_moved {eng.slots.bytes_moved}, hosted "
                 f"per layer {sorted(set(hosted))}: not every cold expert hosted")
        if gbps == 100.0 and (any(hosted) or reloads != 2 * len(hosted)):
            fail(f"cvs 100 GB/s: hosted {sum(hosted)}, reloads {reloads}: not every expert "
                 f"shipped")
        modelled = simulate_odmoe(cfg, trace, eng.sched, RTX3090_EDGE, predictor="none")
        run.update(hosted=sum(hosted), reloads=reloads, bytes_moved=eng.slots.bytes_moved,
                   t_ship=t_ship, t_host=t_host,
                   modelled_ms=sum(modelled.per_token_s) / len(modelled.per_token_s) * 1e3)
        launches += run["launches"]["moe_ffn"]
        runs[gbps] = run
        del eng
        print(f"[cvs] {gbps:5g} GB/s: t_ship {t_ship * 1e3:.2f} ms, t_host {t_host * 1e3:.2f} ms; "
              f"tokens == greedy_generate: True; hosted {run['hosted']}, reloads {reloads}, "
              f"bytes_moved {run['bytes_moved']}; TPOT median {run['tpot_ms']:.3f} ms (card); "
              f"modelled TPOT (rtx3090-edge profile, not measured) {run['modelled_ms']:.3f} ms; "
              f"peak device memory {run['peak_bytes'] / 1e9:.3f} GB; moe_ffn launches "
              f"{run['launches']['moe_ffn']}", flush=True)
    hosted, shipped = runs[24.0], runs[100.0]
    if hosted["peak_bytes"] > shipped["peak_bytes"] + 2 * store.expert_bytes:
        fail(f"cvs: hosted peak {hosted['peak_bytes']} exceeds the shipped run's "
             f"{shipped['peak_bytes']} by more than one layer's stack of 2 experts "
             f"({2 * store.expert_bytes} B)")
    print(f"[cvs] hosted / shipped on the card: TPOT {hosted['tpot_ms'] / shipped['tpot_ms']:.3f}x "
          f"(one card: a hosted stack crosses the same host link a slot load does); peak "
          f"{(hosted['peak_bytes'] - shipped['peak_bytes']) / 1e6:+.1f} MB; modelled "
          f"{hosted['modelled_ms'] / shipped['modelled_ms']:.3f}x", flush=True)
    return {"launches": launches, "runs": runs}


def phase_cluster(cfg, params, serve: dict, store, plan) -> dict:
    """Two replicas over one store and one fleet on the serve phase's
    traffic (dense KV, as the JAX package's ``serve_cluster``): least-loaded
    with a shared gate-statistics recorder, then round-robin under the
    placement phase's plan with compute-vs-ship on 24 GB/s links."""
    import torch
    import numpy as np
    from repro_torch.fleet import FleetSchedule, GateStatsRecorder, WorkerProfile
    from repro_torch.launch.serve import KERNELS
    from repro_torch.serve import make_cluster, make_traffic
    reqs = make_traffic(cfg, 8, 0.0, prompt_len=128, max_new=8, seed=SERVE_SEED)
    rec = GateStatsRecorder()
    links = [WorkerProfile(w, link_gbps=24.0) for w in range(8)]
    runs = {"least_loaded": dict(n_workers=8, gate_stats=rec),
            "round_robin": dict(sched=FleetSchedule(8, 2, profiles=links, plan=plan),
                                compute_vs_ship=True)}
    out = {"launches": {"moe_ffn": 0, "flash_decode": 0}, "runs": {}}
    for policy, kw in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated() / 1e9
        _reset_launches()
        t0 = time.perf_counter()
        router = make_cluster(cfg, params, replicas=2, policy=policy,
                              engine_kw=dict(kw, predictor="sep", shadow_scheme="int8",
                                             device="cuda", store=store),
                              loop_kw=dict(max_batch=4))
        res = router.run(reqs)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        for r in reqs:
            if not np.array_equal(res.outputs[r.rid], serve["outputs"][r.rid]):
                fail(f"cluster {policy}: request {r.rid} differs from its solo decode")
        engines = [l.engine for l in router.loops]
        if any(e.store is not store or e.sched is not engines[0].sched for e in engines):
            fail(f"cluster {policy}: the replicas do not share one store and one schedule")
        per = res.per_replica_report()
        if any(rr["requests"] < 1 for rr in per):
            fail(f"cluster {policy}: a replica served no request ({res.assignments})")
        for name in ("moe_ffn", "flash_decode"):
            if launches[name] <= 0:
                fail(f"cluster {policy}: {name} did not launch")
            out["launches"][name] += launches[name]
        hosted = sum(len(lr.hosted) for r in res.replicas for s in r.trace.records
                     for lr in s.layers)
        if policy == "round_robin" and hosted < 1:
            fail("cluster round_robin: compute-vs-ship on 24 GB/s links hosted no expert")
        by_b = {}
        for r in res.replicas:
            for st in r.steps:
                by_b.setdefault(len(st.request_ids), []).append(st.wall_s * 1e3)
        steps = {b: (float(np.median(ts)), len(ts)) for b, ts in sorted(by_b.items())}
        rep = res.report()
        loads = sum(len(e.slots.events) for e in engines)
        out["runs"][policy] = dict(report=rep, steps=steps, hosted=hosted, peak_gb=peak,
                                   launches=launches, loads=loads)
        print(f"[cluster] {policy}: make_cluster + run took {took:.1f} s; tokens of all "
              f"{len(reqs)} requests == solo greedy_generate (the serve phase's outputs); "
              f"assignments {res.assignments}; replicas share one store and one schedule: True",
              flush=True)
        print(f"[cluster] {policy}: per replica (requests, mean batch) "
              f"{[(rr['requests'], round(rr['mean_batch'], 3)) for rr in per]}; hosted experts "
              f"{hosted}; loads {loads}; device memory before building the replicas "
              f"{resting:.2f} GB, peak with two replicas' shadows and slots {peak:.2f} GB; launches (engines+shadows) moe_ffn {launches['moe_ffn']}, "
              f"flash_decode {launches['flash_decode']}")
        print(f"[cluster] {policy}: modelled (rtx3090-edge profile, not measured) TTFT mean "
              f"{rep['ttft_mean_s'] * 1e3:.3f} ms, TPOT mean {rep['tpot_mean_s'] * 1e3:.3f} ms, "
              f"throughput {rep['throughput_tok_s']:.3f} tok/s")
        print(f"[cluster] {policy}: composed step (card's own wall time, both replicas): "
              f"{fmt_steps(steps)}; serve phase of this call: {fmt_steps(serve['steps_by_b'])}",
              flush=True)
        del router, res, engines
    print(f"[cluster] pooled gate statistics (least_loaded): {rec.n_layers} MoE layers, "
          f"{sum(rec.rows.values())} routed rows")
    return out


INT8_SWEEP = ((32, 128, 64), (64, 256, 96), (13, 70, 33))   # tests/test_kernels.py's shapes
INT8_SHAPES = ((D_MODEL, D_EXPERT), (D_EXPERT, D_MODEL))      # a Mixtral-8x7B expert's matrices
INT8_TIME_ROWS = (1, 4, 8)
L2_FLUSH_BYTES = 256 << 20        # a write over it evicts the H100's 50 MB L2


def int8_inputs(m, k, n, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((n,), generator=gen, device="cuda") * 9e-3 + 1e-3
    return x, wq, sc


def int8_bound_ms(m, k, n, itemsize) -> tuple:
    """Least time for one call: codes, x, scale read once and y written once
    at 3.35 TB/s, against its fp32 FMAs at 67 TFLOP/s."""
    nbytes = k * n + m * k * itemsize + 4 * n + 4 * m * n
    ops = 2 * m * k * n + m * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes


def int8_times(kernel, label: str = "int8") -> dict:
    """Device time (``median_ms``) of ``kernel`` at M in INT8_TIME_ROWS on the
    Mixtral expert matrices, fp32 and bf16 x: repeated calls (part of the
    58.7 MB of codes may still sit in the 50 MB L2), then with a 256 MB
    write queued before each call (L2 flushed; the write leaves dirty lines
    that the call's reads evict).  Keyed (m, k, n, dtype)."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = {}
    for k, n in INT8_SHAPES:
        for m in INT8_TIME_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                x, wq, sc = int8_inputs(m, k, n, dtype, seed=1)
                t = median_ms(lambda: kernel(x, wq, sc))
                t_cold = median_ms(lambda: kernel(x, wq, sc), before=flush.zero_)
                b_ms, b_by, nbytes = int8_bound_ms(m, k, n, x.element_size())
                rows[(m, k, n, dtype)] = dict(ms=t, cold_ms=t_cold, bound_ms=b_ms, bound_by=b_by,
                                              nbytes=nbytes)
                print(f"[{label}] time M={m} K={k} N={n} {str(dtype)[6:]} x: {t:.4f} ms "
                      f"({b_ms / t:.1%} of its {b_ms:.4f} ms {b_by} bound, {nbytes} bytes); "
                      f"L2 flushed before each call {t_cold:.4f} ms ({b_ms / t_cold:.1%}) "
                      f"(device time, median of 25)", flush=True)
                del x, wq, sc
    del flush
    return rows


def int8_bits(kernel) -> None:
    """Bitwise gates of the w8a16 kernel's summation order: each row of an
    M=13 and an M=8 call equals its own M=1 launch, and bf16 x gives the
    bits of the same values in fp32, at both Mixtral shapes."""
    import torch

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    for k, n in INT8_SHAPES:
        for m in (13, 8):
            x, wq, sc = int8_inputs(m, k, n, torch.float32, seed=m + 3)
            full = kernel(x, wq, sc)
            for i in range(m):
                if not same(kernel(x[i:i + 1], wq, sc), full[i:i + 1]):
                    fail(f"int8 matmul row {i} of an M={m} call at K={k} N={n} differs from "
                         f"its own M=1 launch")
        for m in (1, 4, 8, 13):
            x, wq, sc = int8_inputs(m, k, n, torch.bfloat16, seed=m)
            if not same(kernel(x, wq, sc), kernel(x.float(), wq, sc)):
                fail(f"int8 matmul bf16 x differs from the same values in fp32 at M={m} K={k} "
                     f"N={n}")
        torch.cuda.synchronize()
    print("[int8] bitwise: every row of M=13 and M=8 calls == its own M=1 launch, bf16 x == "
          "x.float() at M in {1, 4, 8, 13}, at both Mixtral shapes", flush=True)


def int8_sass(lib_path: str) -> None:
    """The instruction mix of the w8a16 kernels (``cuobjdump -sass`` of the
    built library): any int-to-float conversion (I2F) fails the phase."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        fail("cuobjdump not found: the int8 kernel's SASS cannot be checked")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr.strip()[:300]}")
    funcs = re.split(r"\n\s*Function : ", proc.stdout)[1:]
    if not funcs:
        fail("cuobjdump -sass listed no function of the int8 library")
    for body in funcs:
        name = body.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)",
                         body)
        count = {}
        for op in ops:
            base = op.split(".")[0]
            count[base] = count.get(base, 0) + 1
        i2f = sum(v for key, v in count.items() if key.startswith("I2F"))
        print(f"[int8] SASS {name}: {len(ops)} instructions, I2F {i2f}, FFMA "
              f"{count.get('FFMA', 0)}, PRMT {count.get('PRMT', 0)}, FADD "
              f"{count.get('FADD', 0)}, LDS {count.get('LDS', 0)}, UTMALDG "
              f"{count.get('UTMALDG', 0)}", flush=True)
        if i2f:
            fail(f"int8 kernel {name} has {i2f} int-to-float conversions (I2F) in its SASS")


def int8_profile(m, k, n) -> None:
    """One call is one kernel: ``torch.profiler`` over 5 calls sees the w8a16
    kernel and no other (no reduction, no workspace fill).  Run as the
    process's first profiler session: after the other phases' profiles the
    profiler kept one record of the 5 calls in one run and none in another;
    the count is printed, and its launches do not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.int8_matmul import int8_matmul_kernel as kernel
    x, wq, sc = int8_inputs(m, k, n, torch.float32, seed=1)
    kernel(x, wq, sc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernel(x, wq, sc)
        torch.cuda.synchronize()
    events = [(ev.key, ev.count, ev.device_time / 1e3) for ev in prof.key_averages()
              if ev.device_time > 0]
    print(f"[int8] profile of 5 calls at M={m} K={k} N={n} (torch.profiler): "
          + "; ".join(f"{name} x{count}, {t:.4f} ms each" for name, count, t in events),
          flush=True)
    if not events or any("int8_matmul_kernel" not in name or count > 5
                         for name, count, _ in events):
        fail("an int8 matmul call launched another kernel than its one")
    kernel.launches = 0


def phase_int8() -> dict:
    """The w8a16 matmul kernel against its plain version, bitwise repeatable,
    its summation-order gates, its SASS, then timed on the Mixtral expert
    matrices."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul_kernel, int8_matmul_ref
    from repro_torch.kernels.int8_matmul import kernel as int8_lib
    shapes = list(INT8_SWEEP) + [(m, k, n) for m in (1, 4, 8) for k, n in INT8_SHAPES]
    worst, errs = 0.0, {}
    for m, k, n in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, wq, sc = int8_inputs(m, k, n, dtype, seed=m + k + n)
            got = int8_matmul_kernel(x, wq, sc)
            want = int8_matmul_ref(x, wq, sc)
            again = int8_matmul_kernel(x, wq, sc)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"int8 matmul output not finite at {(m, k, n)} {dtype}")
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            worst = max(worst, rel)
            errs[(m, k, n, dtype)] = err
            if rel > INT8_TOL:
                fail(f"int8 matmul disagrees with its plain version at {(m, k, n)} {dtype}: "
                     f"{rel:.3e}")
            if not torch.equal(got, again):
                fail(f"int8 matmul repeated launches differ at {(m, k, n)} {dtype}")
        p = int8_lib.plan(m, n, k)
        print(f"[int8] M={m} K={k} N={n}: max|k-p| {errs[(m, k, n, torch.float32)]:.3e} (fp32 "
              f"x) / {errs[(m, k, n, torch.bfloat16)]:.3e} (bf16 x); one launch of "
              f"{p['blocks']} blocks: K in {p['segments']} segment(s) of {p['segment_rows']} "
              f"rows, folded in segment order through distributed shared memory by clusters "
              f"of {p['cluster_blocks']} block(s) ({p['block_segments']} segment(s) a block), "
              f"column tiles of {p['tile_bytes']} codes, row tile {p['row_tile']}; repeated "
              f"launch bitwise equal", flush=True)
    print(f"[int8] worst max|k-p|/max|p| {worst:.3e} (tolerance {INT8_TOL:g})")
    for m, k, n in INT8_SWEEP:
        x, wq, sc = int8_inputs(m, k, n, torch.float32, seed=m + k + n)
        t = median_ms(lambda: int8_matmul_kernel(x, wq, sc))
        b_ms = int8_bound_ms(m, k, n, 4)[0]
        print(f"[int8] time M={m} K={k} N={n} fp32 x: {t:.4f} ms (bound {b_ms:.6f} ms; at this "
              f"size a launch's fixed cost) (device time, median of 25)", flush=True)
    int8_bits(int8_matmul_kernel)
    int8_sass(int8_lib.LIBRARY.build()["path"])
    times = int8_times(int8_matmul_kernel)
    rows = {}
    m = 4
    for k, n in INT8_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, wq, sc = int8_inputs(m, k, n, dtype, seed=1)
            w32 = wq.float() * sc[None, :]
            w16 = w32.to(torch.bfloat16)
            x32, x16 = x.float(), x.to(torch.bfloat16)
            t_p = median_ms(lambda: int8_matmul_ref(x, wq, sc), iters=20)
            t_l32 = median_ms(lambda: x32 @ w32)
            t_l16 = median_ms(lambda: x16 @ w16)
            row = dict(times[(m, k, n, dtype)], plain_ms=t_p, yardstick_fp32_ms=t_l32,
                       yardstick_bf16_ms=t_l16, max_abs_err=errs[(m, k, n, dtype)])
            rows[(k, n, dtype)] = row
            print(f"[int8] M={m} K={k} N={n} {str(dtype)[6:]} x: kernel {row['ms']:.4f} ms, "
                  f"plain {t_p:.4f} ms, cuBLAS on dequantized weights {t_l32:.4f} ms (fp32) / "
                  f"{t_l16:.4f} ms (bf16) (device time, median of 25 / 20 / 25 launches)",
                  flush=True)
            del x, wq, sc, w32, w16, x32, x16
    int8_matmul_kernel.launches = 0        # comparison launches do not count
    torch.cuda.empty_cache()
    return rows


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
        if res["launches_engine"]["moe_ffn_packed"] <= 0:
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
              f"{launches} (engine {res['launches_engine']['moe_ffn_packed']}, reference "
              f"{res['launches_reference']['moe_ffn_packed']}), moe_ffn launches "
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
        out["launches"] += res["launches_engine"]["moe_ffn_packed"]
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


def engine_prefill_ms(eng, cfg, prompt_len: int, tokens: int, seed: int) -> float:
    """The engine's prefill of the phase's prompt as ``generate`` runs it:
    the main model (``prefill_request``; every MoE layer's experts through
    the grouped FFN), then the SEP shadow's.  Host clock around work that
    ends in a synchronize, median of 3."""
    from repro_torch.launch.serve import _prompt
    batch = _prompt(cfg, prompt_len, seed, eng.device)

    def run():
        eng.prefill_request(batch, prompt_len + tokens)
        if eng.shadow is not None:
            eng.shadow.reset(batch, prompt_len + tokens)
    return _median_ms(run, reps=3)


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
    _, state = prefill(cfg, params, batch, 16, moe_method="grouped")
    ref_ms = _median_ms(lambda: decode_step(cfg, params, token, state))
    loads_per_token = eng.slots.stats["loads"] / max(len(res["step_seconds"]), 1)
    print(f"[breakdown] one expert load (pinned host -> card, {nbytes} bytes): "
          f"{load_ms:.3f} ms = {nbytes / load_ms / 1e6:.2f} GB/s")
    print(f"[breakdown] loads per decoded token: {loads_per_token:.3f}")
    print(f"[breakdown] SEP shadow step ({cfg.num_layers} layers, all {cfg.num_experts} "
          f"experts per MoE layer): {shadow_ms:.3f} ms")
    print(f"[breakdown] reference decode_step ({cfg.num_layers} layers, all "
          f"{cfg.num_experts} experts per MoE layer): {ref_ms:.3f} ms")
    return dict(load_ms=load_ms, load_bytes=nbytes, loads_per_token=loads_per_token,
                shadow_ms=shadow_ms, ref_ms=ref_ms)


SSD_H, SSD_P, SSD_N = 128, 64, 128     # Jamba's Mamba2 mixer: 128 heads of 64 x state 128


def ssd_inputs(b, nc, h, p, n, seed, with_h0):
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randn((b, nc, h, p, n), generator=gen, device=dev)
    decay = torch.rand((b, nc, h), generator=gen, device=dev) * 0.7 + 0.3
    h0 = torch.randn((b, h, p, n), generator=gen, device=dev) if with_h0 else None
    return s, decay, h0


def ssd_bound_ms(b, nc, h, p, n, with_h0) -> tuple:
    """Least time for the scan: s, decay (and h0) read once, h_in and
    h_last written once, against fp32 operations (a multiply and an add per
    element of s)."""
    state = b * h * p * n
    nbytes = 4 * (2 * nc * state + state + b * nc * h + (state if with_h0 else 0))
    ops = 2 * nc * state
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def refuse(call, what: str) -> None:
    """Fail unless ``call`` raises ValueError without launching."""
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    before = ssd_scan_kernel.launches
    try:
        call()
    except ValueError:
        if ssd_scan_kernel.launches != before:
            fail(f"ssd scan kernel launched before refusing {what}")
        return
    fail(f"ssd scan kernel accepted {what}")


def phase_ssd() -> dict:
    """The SSD scan kernel against its plain version (bitwise) and each
    batch row against its own B=1 launch, then timed at the Jamba slice's
    prefill shape and a larger one."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_ref
    shapes = [(b, nc, SSD_H, SSD_P, SSD_N) for b in (1, 4) for nc in (1, 4, 8)]
    shapes.append((1, JAMBA_LONG_CHUNKS, SSD_H, SSD_P, SSD_N))   # jamba-long's prefill
    shapes.append((2, 5, 3, 5, 12))                   # a ragged float4 tail
    worst = 0.0
    errs = {}
    for shape in shapes:
        for with_h0 in (False, True):
            s, decay, h0 = ssd_inputs(*shape, seed=sum(shape), with_h0=with_h0)
            k_in, k_last = ssd_scan_kernel(s, decay, h0)
            p_in, p_last = ssd_scan_ref(s, decay, h0)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(k_in).all()) and bool(torch.isfinite(k_last).all())):
                fail(f"ssd scan output not finite at {shape}")
            if not (torch.equal(k_in, p_in) and torch.equal(k_last, p_last)):
                fail(f"ssd scan kernel differs from its plain version at {shape} "
                     f"(h0 {'given' if with_h0 else 'None'})")
            err = max(float((k_in - p_in).abs().max()), float((k_last - p_last).abs().max()))
            rel = err / max(float(p_in.abs().max()), float(p_last.abs().max()))
            worst = max(worst, rel)
            errs[(shape, with_h0)] = err
            b = shape[0]
            for i in range(b):
                one_in, one_last = ssd_scan_kernel(
                    s[i:i + 1].contiguous(), decay[i:i + 1].contiguous(),
                    None if h0 is None else h0[i:i + 1].contiguous())
                if not (torch.equal(one_in, k_in[i:i + 1]) and
                        torch.equal(one_last, k_last[i:i + 1])):
                    fail(f"ssd scan row {i} differs from its own B=1 launch at {shape}")
            print(f"[ssd] B={shape[0]} NC={shape[1]} H={shape[2]} P={shape[3]} N={shape[4]} "
                  f"h0 {'given' if with_h0 else 'None '}: == plain version bitwise "
                  f"(max|k-p| {err:.3e}); rows == own B=1 launch", flush=True)
    # the kernel moves float4s: P*N not a multiple of 4 and a pointer that
    # is not 16-byte aligned are refused, not computed
    s, decay, _ = ssd_inputs(1, 4, 3, 5, 7, seed=9, with_h0=False)
    refuse(lambda: ssd_scan_kernel(s, decay), "P*N=35")
    s, decay, _ = ssd_inputs(1, 4, 6, 8, 16, seed=9, with_h0=False)
    shifted = torch.empty(s.numel() + 1, device="cuda")[1:].view(s.shape)
    shifted.copy_(s)
    refuse(lambda: ssd_scan_kernel(shifted, decay), "a misaligned s")
    print(f"[ssd] P*N=35 and a misaligned s: refused with ValueError; worst relative "
          f"error {worst:.3e} (tolerance {SSD_TOL:g}, after bitwise equality)")
    if worst > SSD_TOL:
        fail(f"ssd scan relative error {worst:.3e} above {SSD_TOL:g}")
    rows = {}
    for b, nc in ((1, 4), (4, 8), (1, JAMBA_LONG_CHUNKS)):
        s, decay, _ = ssd_inputs(b, nc, SSD_H, SSD_P, SSD_N, seed=3, with_h0=False)
        t_k = median_ms(lambda: ssd_scan_kernel(s, decay))
        t_p = median_ms(lambda: ssd_scan_ref(s, decay), iters=20)
        b_ms, b_by, nbytes = ssd_bound_ms(b, nc, SSD_H, SSD_P, SSD_N, False)
        rows[(b, nc)] = dict(ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by, nbytes=nbytes,
                             max_abs_err=errs[((b, nc, SSD_H, SSD_P, SSD_N), False)])
        print(f"[ssd] time B={b} NC={nc} H={SSD_H} P={SSD_P} N={SSD_N}: kernel {t_k:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}, {nbytes} bytes, {b_ms / t_k:.1%} of it), plain "
              f"{t_p:.4f} ms (device time, median of 25 / 20 launches); no PyTorch call "
              f"computes this recurrence", flush=True)
        del s, decay
    ssd_scan_kernel.launches = 0           # comparison launches do not count
    torch.cuda.empty_cache()
    return rows


JAMBA_LAYERS = 6          # layers 0-5 of Jamba's first period of 8
JAMBA_PROMPT = 1000       # 4 chunks of 256, the last padded by 24
JAMBA_SERVE_SEED = 149    # the first make_traffic seed whose burst makes the pool preempt


def _reset_launches():
    from repro_torch.launch.serve import KERNELS
    for kern in KERNELS.values():
        kern.launches = 0


def phase_jamba_slice() -> dict:
    """``serve_single`` at Jamba-v0.1 width, 6 layers, 1000-token prompt."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.mamba import mamba_decode
    from repro_torch.models.transformer import layer_params
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    kinds = cfg.layer_kinds()
    print(f"[jamba-slice] {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, {cfg.num_experts} experts top-{cfg.top_k}, d_expert "
          f"{cfg.d_expert}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, SSM state {cfg.ssm_state}, "
          f"head dim {cfg.ssm_head_dim}, d_inner {cfg.d_inner} ({cfg.ssm_heads} SSM heads), "
          f"conv {cfg.ssm_conv}, chunk {cfg.ssm_chunk}, {cfg.dtype}; layers {kinds}")
    print(f"[jamba-slice] cut: num_layers {full.num_layers} -> {cfg.num_layers} (layers 0-5 "
          f"of the first period): parameters are ~{cfg.param_count() * 2 / 1e9:.1f} GB at 6 "
          f"layers and the Mixtral slice peaked at 3.1x its parameters, so 6 layers need "
          f"~62 GB and 8 (~{dataclasses.replace(full, num_layers=8).param_count() * 2 / 1e9:.1f}"
          f" GB of parameters) ~82 GB, past the card's 80 GB")
    gc.collect()                # the Mixtral phases' tensors leave the card first
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[jamba-slice] random bf16 parameters from seed 0: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card", flush=True)
    res = _run_single("jamba-slice", cfg, params, _single_args(JAMBA_PROMPT, 8),
                      ("ssd_scan", "moe_ffn", "flash_decode"))
    eng = res["engine"]
    parts = phase_breakdown(cfg, params, eng, res)
    # one Mamba layer's decode step at B=1 (one block of 8 rows), and the
    # part of it that pads the state to the block
    li = kinds.index(("mamba", "dense"))
    mixer = layer_params(cfg, params, li)["mixer"]
    state = {"h": torch.randn((1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                              device="cuda"),
             "conv": torch.zeros((1, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                 dtype=torch.bfloat16, device="cuda")}
    x = torch.randn((1, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    mamba_ms = _median_ms(lambda: mamba_decode(cfg, mixer, x, state))
    pad_ms = _median_ms(lambda: torch.cat([state["h"], state["h"].new_zeros((7,) + tuple(
        state["h"].shape[1:]))]))
    print(f"[jamba-breakdown] one Mamba decode layer at B=1 (8-row block): {mamba_ms:.3f} ms, "
          f"of which padding h ({state['h'].numel() * 4} bytes a row) to 8 rows {pad_ms:.3f} "
          f"ms; a token's loads take {parts['loads_per_token'] * parts['load_ms']:.3f} ms",
          flush=True)
    prefill = engine_prefill_ms(eng, cfg, JAMBA_PROMPT, 8, 0)
    print(f"[jamba-slice] engine prefill of the {JAMBA_PROMPT}-token prompt (main model, then "
          f"the SEP shadow; CUDA-synchronized host clock, median of 3): {prefill:.3f} ms",
          flush=True)
    return {"launches": res["launches_engine"], "cfg": cfg, "params": params,
            "tpot_ms": res["tpot_ms"], "peak_gb": res["peak_gb"], "prefill_ms": prefill}


def phase_jamba_serve(cfg, params) -> dict:
    """``serve_traffic`` at Jamba-v0.1 width: 4 burst requests through a
    half-dense KV pool over the one attention layer."""
    import math
    import torch
    from repro_torch.launch.serve import KERNELS, build_parser, serve_traffic
    from repro_torch.serve import make_traffic
    max_batch, page_tokens = 4, 16
    reqs = make_traffic(cfg, 4, 0.0, prompt_len=1024, max_new=8, seed=JAMBA_SERVE_SEED)
    window = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
    pages = math.ceil(window / page_tokens) * max_batch // 2
    gc.collect()                # the slice's engine and shadow leave the card first
    torch.cuda.empty_cache()
    print(f"[jamba-serve] {len(reqs)} requests at t=0 (make_traffic seed {JAMBA_SERVE_SEED}): "
          f"prompts {[len(r.prompt) for r in reqs]}, budgets "
          f"{[r.max_new_tokens for r in reqs]}; window {window} slots; KV pool {pages} pages x "
          f"{page_tokens} slots = half the dense footprint of {max_batch} windows", flush=True)
    args = build_parser().parse_args(
        ["--requests", "4", "--arrival-rate", "0", "--prompt-len", "1024", "--tokens", "8",
         "--max-batch", str(max_batch), "--compose", "overlap", "--predictor", "sep",
         "--shadow", "int8", "--transport-precision", "fp32", "--workers", "8",
         "--seed", str(JAMBA_SERVE_SEED), "--kv-pages", str(pages),
         "--page-tokens", str(page_tokens)])
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = serve_traffic(cfg, params, args)       # raises unless every request == solo
    every = {name: k.launches for name, k in KERNELS.items()}
    res = out["result"]
    peak, built = out["serving_peak_bytes"] / 1e9, out["build_peak_bytes"] / 1e9
    print(f"[jamba-serve] serve_traffic took {time.perf_counter() - t0:.1f} s; peak device "
          f"memory while building the engine and pool {built:.2f} GB, while serving "
          f"{peak:.2f} GB")
    if len(res.outputs) != len(reqs):
        fail("not every jamba request was served")
    for r in reqs:
        toks = res.outputs[r.rid]
        if len(toks) != r.max_new_tokens or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size:
            fail(f"jamba request {r.rid}: {len(toks)} tokens, out of budget or vocabulary")
    st = res.kv_stats
    if res.mean_batch <= 1.0:
        fail(f"jamba mean batch {res.mean_batch:.2f}: no composed step")
    if st["preemptions"] < 1 or st["resumes"] < 1:
        fail(f"the half-dense pool did not preempt and resume ({st})")
    for name in ("ssd_scan", "moe_ffn", "flash_decode"):
        if out["launches_serving"][name] <= 0 or out["launches_reference"][name] <= 0:
            fail(f"{name} did not launch on both the serving and the reference side")
    print(f"[jamba-serve] tokens of all {len(reqs)} requests == solo greedy_generate; mean "
          f"batch {res.mean_batch:.2f} over {len(res.steps)} composed steps; preemptions "
          f"{st['preemptions']}, resumes {st['resumes']}, deferred admissions "
          f"{st['deferred_admissions']}; kernel launches on the main path (engine+shadow) "
          f"{out['launches_serving']}; in the solo greedy_generate check "
          f"{out['launches_reference']} (all {every})", flush=True)
    return {"launches": out["launches_serving"], "peak_gb": peak, "built_gb": built}


def kernel_width_rows(tag: str, d: int, f: int, shapes) -> dict:
    """Kernel 1 on bf16 weights at a model's widths (D, F) and its main
    path's (E, C): within tolerance of its plain version, each (row, expert)
    bitwise equal to the largest call's, timed back to back beside its
    bound, its plain version and the torch.bmm formula."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    emax, cmax = max(e for e, _ in shapes), max(c for _, c in shapes)

    def weight(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5).to(
            torch.bfloat16)

    x = torch.randn((cmax, d), generator=gen, device=dev)
    wg, wu, wd = weight((emax, d, f), d), weight((emax, d, f), d), weight((emax, f, d), f)
    full = moe_ffn_kernel(x.expand(emax, cmax, d).contiguous(), wg, wu, wd)

    def library(xd, e):
        xb = xd.to(torch.bfloat16)
        return torch.bmm(F.silu(torch.bmm(xb, wg[:e])) * torch.bmm(xb, wu[:e]), wd[:e])

    rows = {}
    for e, c in shapes:
        xd = x[:c].expand(e, c, d).contiguous()
        k = moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e])
        p = moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e])
        torch.cuda.synchronize()
        if not bool(torch.isfinite(k).all()):
            fail(f"kernel output not finite at {tag} E={e} C={c}")
        err = float((k - p).abs().max())
        if err / float(p.abs().max()) > KERNEL_TOL:
            fail(f"kernel disagrees with its plain version at {tag} E={e} C={c}")
        if not torch.equal(k, full[:e, :c]):
            fail(f"kernel rows at {tag} E={e} C={c} differ from the E={emax} C={cmax} call's")
        t_k = time_ms(lambda: moe_ffn_kernel(xd, wg[:e], wu[:e], wd[:e]))
        t_p = time_ms(lambda: moe_ffn_ref(xd, wg[:e], wu[:e], wd[:e]), iters=5)
        t_l = time_ms(lambda: library(xd, e))
        b_ms, b_by = bound_ms(e, c, 2, d, f)
        rows[(e, c)] = dict(shape=f"E={e} C={c} D={d} F={f} bf16", ms=t_k, plain_ms=t_p,
                            library_ms=t_l, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        print(f"[{tag}] kernel E={e:3d} C={c:2d} D={d} F={f}: max|k-p| {err:.3e}, rows == the "
              f"E={emax} C={cmax} call's bitwise; kernel {t_k:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {b_ms / t_k:.1%} of it), torch.bmm bf16 formula {t_l:.4f} ms, plain "
              f"{t_p:.4f} ms (back to back)", flush=True)
    del x, wg, wu, wd, full
    torch.cuda.empty_cache()
    return rows


def flash_layout_row(tag: str, b: int, w: int, kh: int, g: int, hd: int,
                     seed: int = None, cross: bool = False) -> dict:
    """Flash decode (bf16) at one head layout and window: within tolerance
    of its plain version, each row bitwise equal to its own B=1 launch,
    timed (device time) beside its bound, plain version and
    ``scaled_dot_product_attention``, and with the host's launch time.
    ``cross``: the cross-attention layout, every slot (memory frame) at
    position 0, so every one is valid."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode_kernel, flash_decode_ref
    q, k, v, kpos, pos = flash_inputs(b, w, torch.bfloat16, seed=w + g if seed is None else seed,
                                      kh=kh, g=g, hd=hd)
    if cross:
        kpos = torch.zeros_like(kpos)
    o = flash_decode_kernel(q, k, v, kpos, pos)
    p = flash_decode_ref(q, k, v, kpos, pos)
    torch.cuda.synchronize()
    err = float((o - p).abs().max())
    if not bool(torch.isfinite(o).all()) or err / float(p.abs().max()) > KERNEL_TOL:
        fail(f"flash kernel disagrees with its plain version at {tag} ({err:.3e})")
    for i in range(b):
        if not torch.equal(flash_decode_kernel(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                               kpos[i:i + 1], pos[i:i + 1]), o[i:i + 1]):
            fail(f"flash row {i} differs from its own B=1 launch at {tag}")
    qs = q.reshape(b, kh * g, 1, hd)
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = ((kpos >= 0) & (kpos <= pos[:, None]))[:, None, None, :]
    t_k = median_ms(lambda: flash_decode_kernel(q, k, v, kpos, pos))
    t_host = median_ms(lambda: flash_decode_kernel(q, k, v, kpos, pos), device_only=False)
    t_p = median_ms(lambda: flash_decode_ref(q, k, v, kpos, pos), iters=20)
    t_l = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                           enable_gqa=True))
    b_ms, b_by, nbytes = flash_bound_ms(b, w, 2, kh, g, hd)
    print(f"[{tag}] flash decode bf16 B={b} W={w} K={kh} G={g} Hd={hd}"
          f"{' (cross: every kpos 0)' if cross else ''}: max|k-p| {err:.3e}, "
          f"rows == own B=1 launch; kernel {t_k:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{nbytes} bytes, {b_ms / t_k:.1%} of it), plain {t_p:.4f} ms, "
          f"scaled_dot_product_attention {t_l:.4f} ms (device time, median of 25 / 20 / 25 "
          f"launches); kernel with the host's launch time {t_host:.4f} ms", flush=True)
    return dict(shape=f"B={b} W={w} K={kh} G={g} Hd={hd} bf16{' cross' if cross else ''}",
                ms=t_k, plain_ms=t_p,
                library_ms=t_l, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, host_ms=t_host)


def _single_args(prompt_len: int, workers: int, tokens: int = LONG_TOKENS):
    from repro_torch.launch.serve import build_parser
    return build_parser().parse_args(
        ["--prompt-len", str(prompt_len), "--tokens", str(tokens), "--predictor", "sep",
         "--shadow", "int8", "--transport-precision", "fp32", "--workers", str(workers),
         "--seed", "0"])


def _run_single(tag: str, cfg, params, args, kernels) -> dict:
    """``serve_single`` with the launch counts set to 0 just before it and
    the peak memory reset, then the gates of every single-stream phase:
    tokens of the right shape, in the vocabulary, equal to
    ``greedy_generate``, and each of ``kernels`` launched by the engine
    and by the reference."""
    import statistics
    import torch
    from repro_torch.launch.serve import serve_single
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res = serve_single(cfg, params, args)
    print(f"[{tag}] serve_single took {time.perf_counter() - t0:.1f} s", flush=True)
    toks = res["tokens"]
    if tuple(toks.shape) != (1, args.tokens):
        fail(f"{tag} engine tokens have shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"{tag} engine tokens out of the vocabulary")
    if not torch.equal(toks.cpu(), res["reference"].cpu()):
        fail(f"{tag} engine tokens differ from greedy_generate")
    for name in kernels:
        if res["launches_engine"][name] <= 0 or res["launches_reference"][name] <= 0:
            fail(f"the {tag} main path did not launch {name} on both sides")
    eng = res["engine"]
    res["tpot_ms"] = statistics.median(res["step_seconds"]) * 1e3
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] tokens {res['tokens'].cpu().tolist()[0]} == greedy_generate: True; kernel "
          f"launches on the main path (engine+shadow) {res['launches_engine']}, in the "
          f"greedy_generate check {res['launches_reference']}")
    print(f"[{tag}] TPOT median {res['tpot_ms']:.3f} ms over {len(res['step_seconds'])} "
          f"tokens; recall {eng_recall(res)}, loads {eng.slots.stats['loads']} "
          f"({eng.slots.stats['loads'] / len(res['step_seconds']):.3f} a token), bytes_moved "
          f"{eng.slots.bytes_moved}; peak device memory {res['peak_gb']:.2f} GB", flush=True)
    return res


def phase_long(cfg, params) -> dict:
    """The Mixtral slice with a 3000-token prompt: ``prefill`` pads it to its
    4096 bucket, so every attention layer's prefill runs blockwise; the cache
    holds 3008 slots, so flash decode runs at W=3008."""
    import torch
    from repro_torch.models.attention import attn_seq
    from repro_torch.models.transformer import layer_params
    gc.collect()                # the cluster phase's engines leave the card first
    torch.cuda.empty_cache()
    res = _run_single("long", cfg, params, _single_args(LONG_PROMPT, 8),
                      ("moe_ffn", "flash_decode"))
    eng = res["engine"]
    prefill = engine_prefill_ms(eng, cfg, LONG_PROMPT, LONG_TOKENS, 0)
    print(f"[long] engine prefill of the {LONG_PROMPT}-token prompt at its 4096 bucket (main "
          f"model, then the SEP shadow; CUDA-synchronized host clock, median of 3): "
          f"{prefill:.3f} ms", flush=True)
    w = LONG_PROMPT + LONG_TOKENS
    frow = flash_layout_row("long", 1, w, N_KV, GROUP, HEAD_DIM)
    mixer = layer_params(cfg, params, 0)["mixer"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((1, 4096, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(4096, device="cuda", dtype=torch.int32)[None]
    t_blk = _median_ms(lambda: attn_seq(cfg, mixer, x, pos))
    t_full = _median_ms(lambda: attn_seq(cfg, mixer, x[:, :2048], pos[:, :2048]))
    print(f"[long] one attention layer's prefill (bf16, projections included; "
          f"CUDA-synchronized host clock, median of 5): blockwise at T=4096 {t_blk:.3f} ms, "
          f"the full path at T=2048 {t_full:.3f} ms ({t_blk / t_full:.2f}x for 2x the "
          f"tokens)", flush=True)
    del x, pos, mixer, eng, res["engine"]
    return {"launches": res["launches_engine"], "tpot_ms": res["tpot_ms"],
            "peak_gb": res["peak_gb"], "prefill_ms": prefill, "flash": frow,
            "blockwise_ms": t_blk, "full_2048_ms": t_full}


def phase_jamba_long(cfg, params) -> dict:
    """The jamba-slice phase's parameters with a 3000-token prompt: a hybrid
    never pads, so its attention layer runs blockwise at 3000 tokens and its
    Mamba layers scan 12 chunks of 256."""
    import torch
    gc.collect()                # jamba-serve's engine and pool leave the card first
    torch.cuda.empty_cache()
    res = _run_single("jamba-long", cfg, params, _single_args(LONG_PROMPT, 8),
                      ("ssd_scan", "moe_ffn", "flash_decode"))
    prefill = engine_prefill_ms(res["engine"], cfg, LONG_PROMPT, LONG_TOKENS, 0)
    print(f"[jamba-long] engine prefill of the {LONG_PROMPT}-token prompt (main model, then "
          f"the SEP shadow; CUDA-synchronized host clock, median of 3): {prefill:.3f} ms; "
          f"ssd_scan launches engine+shadow {res['launches_engine']['ssd_scan']}, "
          f"greedy_generate check {res['launches_reference']['ssd_scan']}", flush=True)
    return {"launches": res["launches_engine"], "tpot_ms": res["tpot_ms"],
            "peak_gb": res["peak_gb"], "prefill_ms": prefill}


QWEN3_LAYERS = 8          # of 48: the dense reference and the shadow stack all 128 experts
TOP8_WORKERS = 16         # two groups of 8: a layer's loads overlap the layer before


def _top8_params(tag: str, cfg, full):
    """Random bf16 parameters from seed 0 on the card, after the earlier
    phases' tensors have left it."""
    import torch
    from repro_torch.models import init_params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads} (G={cfg.num_heads // cfg.num_kv_heads}, Hd "
          f"{cfg.resolved_head_dim}), {cfg.num_experts} experts (expert rows "
          f"{cfg.num_experts_padded}) top-{cfg.top_k}, d_expert {cfg.d_expert}, vocab "
          f"{cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}, {cfg.num_layers} of "
          f"{full.num_layers} layers, {cfg.dtype}; {cfg.param_count() * 2 / 1e9:.2f} GB of "
          f"parameters", flush=True)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[{tag}] random bf16 parameters from seed 0: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card", flush=True)
    return params


def modelled_baselines(tag: str, cfg, res) -> dict:
    """The timing model on the phase's own trace: OD-MoE, fully cached,
    single-node offload cache (LRU and LFU, a third of the experts cached)
    and CPU inference, on the paper's testbed."""
    from repro_torch.core import (RTX3090_EDGE, simulate_cached, simulate_cpu, simulate_odmoe,
                                  simulate_offload_cache)
    eng, trace = res["engine"], res["trace"]
    n_experts = len(eng.moe_layers) * cfg.num_experts
    cache = n_experts // 3
    out = {"odmoe": simulate_odmoe(cfg, trace, eng.sched, RTX3090_EDGE, shadow_scheme="int8",
                                   predictor="sep", transport=res["transport"]).tokens_per_s,
           "cached": simulate_cached(cfg, RTX3090_EDGE), "cpu": simulate_cpu(cfg, RTX3090_EDGE)}
    for policy in ("lru", "lfu"):
        out[policy] = simulate_offload_cache(cfg, trace, RTX3090_EDGE, policy=policy,
                                             cache_experts=cache)
    print(f"[{tag}] modelled, not measured ({RTX3090_EDGE.name} profile, fp32 weights, this "
          f"phase's trace of {len(trace.records)} steps): OD-MoE {out['odmoe']:.3f} tok/s; "
          f"fully cached {out['cached']:.3f}; offload cache of {cache} of {n_experts} experts "
          f"LRU {out['lru']['tokens_per_s']:.3f} tok/s (hit rate "
          f"{out['lru']['cache_hit_rate']:.4f}), LFU {out['lfu']['tokens_per_s']:.3f} (hit rate "
          f"{out['lfu']['cache_hit_rate']:.4f}); CPU {out['cpu']:.3f}", flush=True)
    return out


def phase_qwen3() -> dict:
    """qwen3-moe-30b-a3b at full width, 8 of 48 layers, on 16 workers."""
    from repro_torch.configs import get_config
    full = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, num_layers=QWEN3_LAYERS)
    print(f"[qwen3] cut: num_layers {full.num_layers} -> {cfg.num_layers}: the dense "
          f"reference and the SEP shadow each hold every expert on the card, ~"
          f"{full.param_count() * 2 / 1e9:.1f} GB at 48 layers, twice over past the card's 80 GB")
    params = _top8_params("qwen3", cfg, full)
    res = _run_single("qwen3", cfg, params, _single_args(16, TOP8_WORKERS),
                      ("moe_ffn", "flash_decode"))
    phase_breakdown(cfg, params, res["engine"], res)
    modelled = modelled_baselines("qwen3", cfg, res)
    prefill = engine_prefill_ms(res["engine"], cfg, 16, LONG_TOKENS, 0)
    print(f"[qwen3] engine prefill of the 16-token prompt: {prefill:.3f} ms", flush=True)
    del res["engine"]
    rows = kernel_width_rows("qwen3", cfg.d_model, cfg.d_expert,
                             ((8, 1), (cfg.num_experts, 1), (cfg.num_experts, 16)))
    return {"cfg": cfg, "params": params, "launches": res["launches_engine"],
            "tpot_ms": res["tpot_ms"], "peak_gb": res["peak_gb"], "prefill_ms": prefill,
            "modelled": modelled, "rows": rows}


def phase_qwen3_serve(cfg, params) -> dict:
    """The serve phase's traffic on qwen3-moe (8 layers), dense KV, 16 workers."""
    import torch
    from repro_torch.launch.serve import build_parser, serve_traffic
    gc.collect()
    torch.cuda.empty_cache()
    args = build_parser().parse_args(
        ["--requests", "8", "--arrival-rate", "0", "--prompt-len", "128", "--tokens", "8",
         "--max-batch", "4", "--compose", "overlap", "--predictor", "sep", "--shadow", "int8",
         "--transport-precision", "fp32", "--workers", str(TOP8_WORKERS),
         "--seed", str(SERVE_SEED)])
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = serve_traffic(cfg, params, args)       # raises unless every request == solo
    res, reqs = out["result"], out["requests"]
    peak, built = out["serving_peak_bytes"] / 1e9, out["build_peak_bytes"] / 1e9
    print(f"[qwen3-serve] {len(reqs)} requests at t=0 (make_traffic seed {SERVE_SEED}): "
          f"prompts {[len(r.prompt) for r in reqs]}; serve_traffic took "
          f"{time.perf_counter() - t0:.1f} s; peak device memory while building "
          f"{built:.2f} GB, while serving {peak:.2f} GB")
    if sorted(res.outputs) != sorted(r.rid for r in reqs):
        fail("not every qwen3 request was served")
    for r in reqs:
        toks = res.outputs[r.rid]
        if len(toks) != r.max_new_tokens or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size:
            fail(f"qwen3 request {r.rid}: {len(toks)} tokens, out of budget or vocabulary")
    if res.mean_batch <= 1.0:
        fail(f"qwen3 mean batch {res.mean_batch:.2f}: no composed step")
    for name in ("moe_ffn", "flash_decode"):
        if out["launches_serving"][name] <= 0 or out["launches_reference"][name] <= 0:
            fail(f"{name} did not launch on both the qwen3 serving and reference side")
    by_b = steps_by_b(res)
    print(f"[qwen3-serve] tokens of all {len(reqs)} requests == solo greedy_generate; mean "
          f"batch {res.mean_batch:.2f}; composed steps {fmt_steps(by_b)}; kernel launches on "
          f"the main path (engine+shadow) {out['launches_serving']}; in the solo check "
          f"{out['launches_reference']}", flush=True)
    launches = out["launches_serving"]
    del out, res
    frow = flash_layout_row("qwen3-serve", 4, 144, cfg.num_kv_heads,
                            cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"launches": launches, "steps_by_b": by_b, "peak_gb": peak, "built_gb": built,
            "flash": frow}


def phase_granite() -> dict:
    """granite-moe-3b-a800m at full width and depth on 16 workers."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-3b-a800m")
    print(f"[granite] cut: none ({cfg.num_layers} layers; padded_experts "
          f"{cfg.padded_experts} kept: the router picks among {cfg.num_experts}, the store "
          f"holds those {cfg.num_experts})")
    params = _top8_params("granite", cfg, cfg)
    res = _run_single("granite", cfg, params, _single_args(16, TOP8_WORKERS),
                      ("moe_ffn", "flash_decode"))
    eng = res["engine"]
    stored = sorted({e for (_, e) in eng.store._packed})
    if stored != list(range(cfg.num_experts)):
        fail(f"the granite store holds experts {stored[0]}..{stored[-1]}, not the "
             f"{cfg.num_experts} routed ones")
    phase_breakdown(cfg, params, eng, res)
    prefill = engine_prefill_ms(eng, cfg, 16, LONG_TOKENS, 0)
    print(f"[granite] engine prefill of the 16-token prompt: {prefill:.3f} ms", flush=True)
    del eng, res["engine"]
    gc.collect()
    frow = flash_layout_row("granite", 1, 16 + LONG_TOKENS, cfg.num_kv_heads,
                            cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim)
    rows = kernel_width_rows("granite", cfg.d_model, cfg.d_expert,
                             ((8, 1), (64, 1), (64, 16)))
    return {"cfg": cfg, "params": params, "launches": res["launches_engine"],
            "tpot_ms": res["tpot_ms"], "peak_gb": res["peak_gb"], "prefill_ms": prefill,
            "flash": frow, "rows": rows}


DISPATCH_BATCH, DISPATCH_SEQ = 2, 512        # loss_fn's tokens: 1024 rows a MoE layer
DISPATCH_RUNS = ("grouped", "dense", "scatter-no-drop", "einsum-no-drop", "scatter-config",
                 "einsum-config", "scatter-tight", "einsum-tight")
# below the config's factor, so pairs drop (the random router balances its
# 1024 rows well enough that none drops at 1.25)
DISPATCH_TIGHT = 0.5
# One MoE layer's output against its reference dispatch on the same rows
# (max |out - ref| / max |ref|).  fp32 sums in other orders.  In bf16 each
# dispatch rounds its own products and partial sums; a pair with scatter on
# either side (it adds a token's 8 contributions in bf16, in an order that
# varies run to run) read 1.1e-2 to 2.2e-2 on an H100 80GB HBM3 at 700 W,
# grouped against dense 9.1e-3 and einsum against dense 5.7e-3 in every
# run.  Each pair is held to the larger bound of its two dispatches.
DISPATCH_LAYER_RTOL = {"float32": {"": 1e-4},
                       "bfloat16": {"": 1.5e-2, "scatter": 3e-2}}
# Whole-model losses, relative.  fp32: a router input 1e-7 away can flip a
# near tie among 32 layers x 1024 rows x 40 logits and move the loss by
# about 1e-4 (on an H100 80GB HBM3 at 700 W: scatter against dense 8.4e-5,
# grouped 1.8e-7).  bf16 losses differ by about 1% (grouped 167.68, dense
# 169.38; every pair read 2.1e-3 to 1.2e-2 on the same card): tied
# embeddings of unit scale give this random model logits in the hundreds,
# and each dispatch's own roundings over 32 layers move the loss that much,
# so the bf16 bound only guards against gross faults.  The tight factor's
# gaps are not gated: with half the pairs dropped, one flipped tie hands
# capacity slots to other tokens in every later layer (fp32 einsum against
# scatter 1.28e-2 on the same card, while every layer on the same rows
# placed the same pairs within the per-layer tolerance); those checks stand.
DISPATCH_LOSS_RTOL = {"float32": 1e-3, "bfloat16": 2.5e-2}


def _dispatch_factor(tag: str, cfg):
    return {"": None, "no-drop": cfg.num_experts / cfg.top_k, "config": cfg.capacity_factor,
            "tight": DISPATCH_TIGHT}[tag]


def _layer_rtol(dtype: str, method: str, ref_method: str) -> float:
    bounds = DISPATCH_LAYER_RTOL[dtype]
    return max(bounds.get(m, bounds[""]) for m in (method, ref_method))


def _grouped_kernel_err(c, p, x) -> float:
    """Kernel 1 at the grouped dispatch's own shapes (every padded expert on
    blocks of rows, as ``grouped_topk_contrib`` launches it) against its
    plain version on the same rows: max |k - p| / max |p| of the fp32
    gate-weighted (row, rank) contributions, before the layer rounds them."""
    import torch
    from repro_torch.kernels.moe_gemm import grouped_topk_contrib, moe_ffn_ref
    from repro_torch.models.moe import route
    topk_idx, topk_gate = route(c, p, x)
    n, e = x.shape[0], c.num_experts
    w = [p[k][:e] for k in ("w_gate", "w_up", "w_down")]
    k = grouped_topk_contrib(x, *w, topk_idx, topk_gate)
    y = moe_ffn_ref(x.float().expand(e, n, x.shape[1]).contiguous(), *w)
    plain = topk_gate[..., None] * y[topk_idx, torch.arange(n, device=x.device)[:, None]]
    return float((k - plain).abs().max() / plain.abs().max())


def _dispatch_method(name: str, cfg):
    """A run's ``moe_method`` and its record.  "dense" is plain.  Every other
    run is a callable that, in each MoE layer, also runs its reference on the
    same rows: ``dense`` for ``grouped`` and the no-drop runs (factor E/k),
    the other capacity dispatch at the config's factor and the tight one.  It records the
    layer's relative error against the reference and that pair's bound
    (``_layer_rtol``), whether the two load-balance terms are bitwise equal
    (the same routing of the same rows), its drop fraction and, against the
    other capacity dispatch, whether both keep the same (token, rank) pairs.
    ``grouped`` also records kernel 1 against its plain version on the
    layer's rows (``_grouped_kernel_err``)."""
    import torch
    from repro_torch.models.moe import moe_ff
    method, _, tag = name.partition("-")
    if method == "dense":
        return "dense", None
    factor = _dispatch_factor(tag, cfg)
    ref_method = "dense" if tag in ("", "no-drop") else (
        "einsum" if method == "scatter" else "scatter")
    rec = {"err": [], "lb_equal": [], "drops": [], "same": [], "kernel_err": [],
           "tol": _layer_rtol(cfg.dtype, method, ref_method)}

    def call(c, p, x):
        out, aux = moe_ff(c, p, x, method, cap_factor=factor)
        ref, raux = moe_ff(c, p, x, ref_method, cap_factor=factor)
        rec["err"].append(float((out.float() - ref.float()).abs().max()
                                / ref.float().abs().max()))
        rec["lb_equal"].append(bool(torch.equal(aux["load_balance_loss"],
                                                raux["load_balance_loss"])))
        if "kept" in aux:
            rec["drops"].append(float(aux["drop_fraction"]))
        if "kept" in raux:
            rec["same"].append(bool(torch.equal(aux["kept"], raux["kept"])))
        if method == "grouped":
            rec["kernel_err"].append(_grouped_kernel_err(c, p, x))
        return out, aux

    return call, rec


def _plain_method(name: str, cfg):
    from repro_torch.models.moe import moe_ff
    method, _, tag = name.partition("-")
    if not tag:
        return method
    factor = _dispatch_factor(tag, cfg)
    return lambda c, p, x: moe_ff(c, p, x, method, cap_factor=factor)


def _dispatch_losses(cfg, params, batch, timed: bool) -> dict:
    """``loss_fn`` under each of DISPATCH_RUNS with its per-layer reference
    (``_dispatch_method``): loss and metrics; fails unless every layer is
    within its pair's DISPATCH_LAYER_RTOL of its reference with a bitwise
    equal load-balance term, kernel 1 is within KERNEL_TOL of its plain
    version in every layer of ``grouped``, nothing drops at E/k, and
    scatter and einsum keep the same pairs in every layer at the config's
    factor.  With ``timed``, each
    dispatch alone (``_plain_method``) timed, median of 3 (host clock around
    work ending in a synchronize), and its peak device memory."""
    import torch
    from repro_torch.models import loss_fn
    out = {}
    with torch.no_grad():
        for name in DISPATCH_RUNS:
            method, rec = _dispatch_method(name, cfg)
            loss, metrics = loss_fn(cfg, params, batch, moe_method=method)
            row = {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}
            if not math.isfinite(row["loss"]):
                fail(f"dispatch {name} ({cfg.dtype}): loss not finite")
            if rec is not None:
                row["layer_err"], row["layer_tol"] = max(rec["err"]), rec["tol"]
                if row["layer_err"] > rec["tol"]:
                    fail(f"dispatch {name} ({cfg.dtype}): a MoE layer's output is "
                         f"{row['layer_err']:.3e} from its reference's on the same rows "
                         f"(tolerance {rec['tol']:g})")
                if rec["kernel_err"]:
                    row["kernel_err"] = max(rec["kernel_err"])
                    if row["kernel_err"] > KERNEL_TOL:
                        fail(f"dispatch {name} ({cfg.dtype}): kernel 1 is "
                             f"{row['kernel_err']:.3e} from its plain version on a layer's "
                             f"rows (tolerance {KERNEL_TOL:g})")
                if not all(rec["lb_equal"]):
                    fail(f"dispatch {name} ({cfg.dtype}): a load-balance term differs from "
                         f"its reference's on the same rows")
                if not all(rec["same"]):
                    fail(f"dispatch {name} ({cfg.dtype}): scatter and einsum keep other "
                         f"(token, rank) pairs in MoE layers "
                         f"{[i for i, x in enumerate(rec['same']) if not x]}")
                if rec["drops"]:
                    row["drop_fraction"] = sum(rec["drops"]) / len(rec["drops"])
                    if name.endswith("no-drop") and any(rec["drops"]):
                        fail(f"dispatch {name} dropped pairs: {rec['drops']}")
            if timed:
                plain = _plain_method(name, cfg)
                torch.cuda.reset_peak_memory_stats()
                row["ms"] = _median_ms(lambda: loss_fn(cfg, params, batch, moe_method=plain),
                                       reps=3)
                row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out[name] = row
    return out


def _dispatch_gaps(runs) -> dict:
    """Relative gaps: each no-drop run and grouped against dense (loss and
    load-balance term), einsum against scatter at the config's factor (the
    gated ones), then at the tight factor (printed only)."""
    pairs = [(m, "dense", k) for m in ("grouped", "scatter-no-drop", "einsum-no-drop")
             for k in ("loss", "load_balance_loss")] + [
        (f"einsum-{t}", f"scatter-{t}", "loss") for t in ("config", "tight")]
    return {f"{a} vs {b} {k}": abs(runs[a][k] - runs[b][k]) / abs(runs[b][k])
            for a, b, k in pairs}


def _gate_gaps(dtype: str, gaps: dict) -> None:
    """Fails on a loss gap above DISPATCH_LOSS_RTOL (the tight factor's are
    printed only); prints them all."""
    tol = DISPATCH_LOSS_RTOL[dtype]
    for k, v in gaps.items():
        if "tight" not in k and v > tol:
            fail(f"dispatch {dtype} {k}: relative gap {v:.3e} above {tol:g}")
    print(f"[dispatch] {dtype} loss gaps (tolerance {tol:g}; the tight factor's not gated): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)


def phase_dispatch(cfg, params) -> dict:
    """granite-moe's ``loss_fn`` on B=2 T=512 tokens under the four MoE
    dispatches.  On the granite phase's bf16 parameters: the main path
    (``grouped``, kernel 1's launches counted), every dispatch timed, and in
    every MoE layer each run against its reference on the same rows
    (``_dispatch_method``).  On the same parameters in fp32 the same.  In
    both, the losses: ``grouped`` and the no-drop runs against ``dense``,
    einsum against scatter at the config's and the tight factor
    (``_gate_gaps``)."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import tree_map
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (DISPATCH_BATCH, DISPATCH_SEQ),
                                     generator=gen, device="cuda", dtype=torch.int32)}
    print(f"[dispatch] {cfg.name} loss_fn on B={DISPATCH_BATCH} T={DISPATCH_SEQ} "
          f"({DISPATCH_BATCH * DISPATCH_SEQ} rows a MoE layer), {cfg.num_layers} layers, "
          f"{cfg.num_experts} experts in {cfg.num_experts_padded} rows top-{cfg.top_k}; "
          f"capacity factors {cfg.num_experts / cfg.top_k:g} (E/k: none can drop), "
          f"{cfg.capacity_factor:g} (the config's) and {DISPATCH_TIGHT:g}", flush=True)
    _reset_launches()
    with torch.no_grad():
        loss_fn(cfg, params, batch, moe_method="grouped")      # the phase's main path
    launches = moe_ffn_kernel.launches
    if launches <= 0:
        fail("loss_fn under the grouped dispatch launched no moe_ffn kernel")
    runs = _dispatch_losses(cfg, params, batch, timed=True)
    moe_ffn_kernel.launches = 0               # timing launches do not count
    for name, r in runs.items():
        print(f"[dispatch] bf16 {name:15s} loss {r['loss']:.6f} (ce {r['ce']:.6f}, load-balance "
              f"{r['load_balance_loss']:.6f}"
              + (f", drop fraction {r['drop_fraction']:.4f} a layer" if "drop_fraction" in r
                 else "")
              + (f", worst layer against its reference {r['layer_err']:.3e} (tolerance "
                 f"{r['layer_tol']:g})" if "layer_err" in r else "")
              + (f", kernel 1 against its plain version {r['kernel_err']:.3e} (tolerance "
                 f"{KERNEL_TOL:g})" if "kernel_err" in r else "")
              + f"): loss_fn {r['ms']:.3f} ms (CUDA-synchronized host clock, median of 3), "
              f"peak device memory {r['peak_gb']:.2f} GB", flush=True)
    gaps16 = _dispatch_gaps(runs)
    _gate_gaps("bfloat16", gaps16)
    p32 = tree_map(lambda t: t.float(), params)
    runs32 = _dispatch_losses(dataclasses.replace(cfg, dtype="float32"), p32, batch,
                              timed=False)
    del p32
    moe_ffn_kernel.launches = 0
    gaps = _dispatch_gaps(runs32)
    _gate_gaps("float32", gaps)
    print("[dispatch] fp32: " + ", ".join(
        f"{n} {r['loss']:.6f}" for n, r in runs32.items()) + "; worst layer against its "
          "reference on the same rows " + ", ".join(
        f"{n} {r['layer_err']:.3e}" for n, r in runs32.items() if "layer_err" in r)
          + f" (tolerance {DISPATCH_LAYER_RTOL['float32']['']:g}), kernel 1 against its plain "
          f"version under grouped {runs32['grouped']['kernel_err']:.3e} (tolerance "
          f"{KERNEL_TOL:g}), load-balance terms bitwise equal on the same rows; scatter and "
          f"einsum keep the same pairs in every layer, in bf16 and fp32; moe_ffn launches "
          f"under grouped (bf16 main path) {launches}", flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs, "runs32": runs32, "gaps": gaps,
            "gaps_bf16": gaps16}


TRAIN_STEPS = 3
# AdamW for the train phases: the full rate from step 1, cosine decay over
# 100 steps (3 are taken).  The rate is the largest of 1e-3, 3e-4 and 1e-4
# at which the held loss of the random model falls over the 3 steps
# (``tools/train_lr_probe.py``): on mamba2-2.7b (an H100 80GB HBM3 at
# 700 W) every rate halves it at step 1,
# and at 1e-3 and 3e-4 step 2 overshoots (held 292 -> 152 -> 1008 -> 324 at
# 1e-3; 292 -> 209 -> 212 -> 191 at 1e-4); granite's falls at 1e-3.
TRAIN_OPT = dict(warmup_steps=0, total_steps=100)
TRAIN_LR = {"train": 1e-3, "train-ssm": 1e-4}
TRAIN_GRAD_TOL = 1e-5     # d(decay) of the scan against autograd: a reduction in another order


def train_batches(cfg, batch: int, seq: int, seed: int):
    """A held batch and TRAIN_STEPS training batches from the Markov stream
    (``batch_iterator``), on the card."""
    import torch
    from repro_torch.data import SyntheticConfig, batch_iterator
    it = batch_iterator(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        batch_size=batch, seed=seed))
    on_card = lambda b: {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
    held = on_card(next(it))
    return held, [on_card(next(it)) for _ in range(TRAIN_STEPS)]


def held_loss(cfg, params, batch):
    """``loss_fn`` (scatter) on the held batch without grad, with PyTorch's
    deterministic algorithms on: the scatter dispatch's ``index_add_`` then
    sums a token's expert outputs in a fixed order instead of by atomics,
    so equal parameters give equal bits.  (cuBLAS is deterministic on one
    stream; its workspace warning is muted.)"""
    import warnings
    import torch
    from repro_torch.models import loss_fn
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, _ = loss_fn(cfg, params, batch, moe_method="scatter")
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return loss


def grouped_refused_under_grad(cfg, params) -> str:
    """``loss_fn`` under ``grouped`` with grad enabled on parameters that
    require it must raise ``ValueError`` before kernel 1 launches: the
    kernel has no backward."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_ffn_kernel
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import tree_map
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32, device="cuda")}
    before = moe_ffn_kernel.launches
    try:
        loss_fn(cfg, ps, batch, moe_method="grouped")
    except ValueError as err:
        if moe_ffn_kernel.launches != before:
            fail("kernel 1 launched before loss_fn under grouped refused to differentiate it")
        return str(err)
    fail("loss_fn under grouped with grad enabled did not refuse (kernel 1 has no backward)")


def ssd_grad_gate(h: int, p: int, n: int) -> dict:
    """The scan's ``autograd.Function`` on the card (kernel forward, kernel
    reverse scan) against autograd through ``ssd_scan_ref`` on the same
    inputs and upstream gradients, at a Mamba layer's shape (B=1 NC=4):
    ``ds`` and ``dh0`` bitwise, ``d(decay)`` within TRAIN_GRAD_TOL of its
    largest."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_kernel, ssd_scan_ref
    s, decay, h0 = ssd_inputs(1, 4, h, p, n, seed=17, with_h0=True)
    gen = torch.Generator(device="cuda").manual_seed(18)
    g_in = torch.randn(s.shape, generator=gen, device="cuda")
    g_last = torch.randn(h0.shape, generator=gen, device="cuda")
    grads = []
    for fn in (ssd_scan, ssd_scan_ref):
        ins = [t.clone().requires_grad_(True) for t in (s, decay, h0)]
        before = ssd_scan_kernel.launches
        outs = fn(*ins)
        grads.append(torch.autograd.grad(outs, ins, grad_outputs=(g_in, g_last)))
        torch.cuda.synchronize()
        if fn is ssd_scan and ssd_scan_kernel.launches - before != 2:
            fail(f"the scan's forward and backward launched the kernel "
                 f"{ssd_scan_kernel.launches - before} times, not 2")
    (ds, dd, dh0), (rs, rd, rh0) = grads
    errs = {"ds": float((ds - rs).abs().max()), "dh0": float((dh0 - rh0).abs().max()),
            "decay": float((dd - rd).abs().max() / rd.abs().max())}
    print(f"[train-ssm] ssd_scan gradient at B=1 NC=4 H={h} P={p} N={n} (kernel forward and "
          f"reverse scan) against autograd through its plain version: ds max|k-p| "
          f"{errs['ds']:.3e}, dh0 {errs['dh0']:.3e} (both bitwise required), d(decay) "
          f"{errs['decay']:.3e} of its largest (tolerance {TRAIN_GRAD_TOL:g})", flush=True)
    if not (torch.equal(ds, rs) and torch.equal(dh0, rh0)):
        fail("the scan's ds or dh0 through the kernel differs from autograd through its "
             "plain version")
    if errs["decay"] > TRAIN_GRAD_TOL:
        fail(f"the scan's d(decay) is {errs['decay']:.3e} from autograd's")
    ssd_scan_kernel.launches = 0          # comparison launches do not count
    return errs


def phase_train(tag: str, cfg, params, batch: int, seq: int, n_mb: int, expect: dict) -> dict:
    """``make_train_step`` (scatter, remat, AdamW with fp32 moments) for
    TRAIN_STEPS steps on ``params`` in place, ``n_mb`` microbatches.  Gates:
    every loss finite; after step 1 every leaf of ``mu`` (``(1 - beta1)``
    times the clipped gradient) has a non-zero element; the held batch's
    loss falls; each kernel's launches over the steps equal ``expect``; a
    checkpoint of the trained parameters loads into freshly initialised
    ones bit for bit, and the held loss on them is bitwise the same."""
    import statistics
    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.launch.serve import KERNELS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state
    gc.collect()
    torch.cuda.empty_cache()
    held, batches = train_batches(cfg, batch, seq, seed=3)
    print(f"[{tag}] {cfg.name}: {cfg.param_count() / 1e9:.3f} G parameters "
          f"({cfg.param_count() * 2 / 1e9:.2f} GB bf16), {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}; AdamW fp32 moments "
          f"({cfg.param_count() * 8 / 1e9:.2f} GB), lr {TRAIN_LR[tag]:g}, scatter, remat on, "
          f"B={batch} T={seq} from batch_iterator, {n_mb} microbatch(es), {TRAIN_STEPS} steps",
          flush=True)
    before = held_loss(cfg, params, held)
    opt = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR[tag], **TRAIN_OPT),
                           moe_method="scatter", n_microbatches=n_mb, remat=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print(f"[{tag}] step {i + 1}: loss {losses[-1]:.4f}, grad norm "
              f"{float(m['grad_norm']):.4f}, lr {float(m['lr']):.2e}, {times[-1] * 1e3:.1f} ms",
              flush=True)
        if not math.isfinite(losses[-1]):
            fail(f"{tag}: step {i + 1} loss is not finite ({losses[-1]})")
        if i == 0:
            silent = [j for j, mu in enumerate(tree_leaves(opt["mu"])) if not bool(mu.any())]
            if silent:
                fail(f"{tag}: {len(silent)} parameter leaves got an all-zero gradient at "
                     f"step 1 (leaf indices {silent[:8]})")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: k.launches for name, k in KERNELS.items()}
    if launches != expect:
        fail(f"{tag}: kernel launches over the steps {launches}, expected {expect}")
    after = held_loss(cfg, params, held)
    if not float(after) < float(before):
        fail(f"{tag}: the held batch's loss did not fall ({float(before)} -> {float(after)})")
    path = os.path.join(ROOT, "build", f"train_{tag}.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, params, step=TRAIN_STEPS)
    t_save = time.perf_counter() - t0
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    fresh = init_params(cfg, seed=1, device="cuda")
    t0 = time.perf_counter()
    loaded, _, saved_step = load_checkpoint(path, fresh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    ckpt_gb = os.path.getsize(path) / 1e9
    os.remove(path)
    del fresh
    if saved_step != TRAIN_STEPS or not all(
            torch.equal(a, c) for a, c in zip(tree_leaves(loaded), tree_leaves(params))):
        fail(f"{tag}: the checkpoint did not restore every parameter bit for bit")
    reloaded = held_loss(cfg, loaded, held)
    if not torch.equal(reloaded, after):
        fail(f"{tag}: held loss on the reloaded parameters {float(reloaded)!r} != "
             f"{float(after)!r}")
    del loaded
    step_ms = statistics.median(times[1:]) * 1e3
    print(f"[{tag}] losses {', '.join(f'{x:.4f}' for x in losses)} (finite); every leaf's "
          f"gradient non-zero at step 1; held batch {float(before):.4f} -> "
          f"{float(after):.4f}; step time {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}, "
          f"CUDA-synchronized host clock; step 1 {times[0] * 1e3:.1f} ms), peak device memory "
          f"over the steps {peak:.2f} GB; launches over the steps {launches}", flush=True)
    print(f"[{tag}] checkpoint round trip: {ckpt_gb:.2f} GB npz saved in {t_save:.1f} s, "
          f"loaded into fresh parameters in {t_load:.1f} s; every leaf bitwise equal, held "
          f"loss on them bitwise equal ({float(reloaded)!r})", flush=True)
    return {"params": params, "losses": losses, "held": (float(before), float(after)),
            "step_ms": step_ms, "step1_ms": times[0] * 1e3, "peak_gb": peak,
            "launches": launches, "save_s": t_save, "load_s": t_load, "ckpt_gb": ckpt_gb}


TRAIN_BATCH, TRAIN_SEQ = 2, 512             # granite: the dispatch phase's B and T
SSM_BATCH, SSM_SEQ, SSM_MICROBATCHES = 2, 1024, 2


def phase_train_granite(cfg, params) -> dict:
    """Training at granite-moe's full width and depth (the dispatch phase's
    bf16 parameters): ``grouped`` refuses under grad, then
    ``phase_train``; the step runs no hand-written kernel."""
    msg = grouped_refused_under_grad(cfg, params)
    print(f"[train] loss_fn under grouped with grad enabled refused before launching: "
          f"ValueError({msg!r})", flush=True)
    expect = {name: 0 for name in ("moe_ffn", "moe_ffn_packed", "flash_decode", "ssd_scan",
                                   "int8_matmul")}
    return phase_train("train", cfg, params, TRAIN_BATCH, TRAIN_SEQ, 1, expect)


def phase_train_ssm() -> dict:
    """Training mamba2-2.7b at full width and depth: the scan's gradient
    gate, then ``phase_train`` with 2 microbatches; ``ssd_scan`` launches
    3 times a Mamba layer a microbatch (forward, remat recompute, reverse
    scan)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("mamba2-2.7b")
    errs = ssd_grad_gate(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-ssm] cut: none ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, N={cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size})", flush=True)
    params = init_params(cfg, seed=0, device="cuda")
    per_step = 3 * cfg.num_layers * SSM_MICROBATCHES
    expect = {name: 0 for name in ("moe_ffn", "moe_ffn_packed", "flash_decode",
                                   "int8_matmul")}
    expect["ssd_scan"] = TRAIN_STEPS * per_step
    res = phase_train("train-ssm", cfg, params, SSM_BATCH, SSM_SEQ, SSM_MICROBATCHES, expect)
    print(f"[train-ssm] ssd_scan launches: {per_step} a step (3 x {cfg.num_layers} layers x "
          f"{SSM_MICROBATCHES} microbatches), {res['launches']['ssd_scan']} over "
          f"{TRAIN_STEPS} steps", flush=True)
    del res["params"], params
    res["grad_errs"] = errs
    res["per_step"] = per_step
    return res


ENCDEC_BATCH, FRONT_PROMPT, FRONT_TOKENS = 2, 16, 8
# logits of a decode step against the teacher-forced sequence's at its
# position, fp32: max |step - full| / max |full|
TEACHER_TOL = 1e-4


def _front_batch(cfg, b: int, dtype, seed: int) -> dict:
    """A prompt of FRONT_PROMPT tokens and the stub frontend's embeddings
    (256 frames or patches), from ``seed``, on the card."""
    import torch
    from repro_torch.models.frontends import synthetic_frontend_embeds
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"frontend_embeds": synthetic_frontend_embeds(cfg, gen, b, dtype=dtype, device="cuda"),
            "tokens": torch.randint(0, cfg.vocab_size, (b, FRONT_PROMPT), generator=gen,
                                    device="cuda", dtype=torch.int32)}


def teacher_forced_gate(tag: str, cfg, params, batch, cache: int, full_logits) -> dict:
    """``greedy_generate`` (its flash-decode launches counted) against the
    same decode through ``prefill``/``decode_step`` and against the
    teacher-forced full sequence ``full_logits(tokens)`` (B, T, V): equal
    tokens, equal to the full sequence's argmax, and each step's logits
    within TEACHER_TOL of the full sequence's at its position."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_kernel
    from repro_torch.models import decode_step, greedy_generate, prefill
    _reset_launches()
    toks = greedy_generate(cfg, params, batch, FRONT_TOKENS, max_cache_len=cache)
    launches = flash_decode_kernel.launches
    logits, state = prefill(cfg, params, batch, cache)
    steps = [logits]
    for i in range(1, FRONT_TOKENS):
        logits, state = decode_step(cfg, params, toks[:, i - 1], state)
        steps.append(logits)
    if not torch.equal(torch.stack([torch.argmax(lg, -1) for lg in steps], 1).to(toks.dtype),
                       toks):
        fail(f"{tag}: greedy_generate's tokens differ from prefill/decode_step's argmax")
    t = batch["tokens"].shape[1]
    full = full_logits(torch.cat([batch["tokens"], toks[:, :-1]], 1))[:, t - 1:]
    worst = 0.0
    for i, lg in enumerate(steps):
        if not bool(torch.isfinite(lg).all()):
            fail(f"{tag}: decode step {i}'s logits not finite")
        worst = max(worst, float((lg - full[:, i]).abs().max() / full[:, i].abs().max()))
    if not torch.equal(torch.argmax(full, -1).to(toks.dtype), toks):
        fail(f"{tag}: greedy tokens differ from the teacher-forced sequence's argmax")
    if worst > TEACHER_TOL:
        fail(f"{tag}: decode logits differ from the teacher-forced sequence's by {worst:.3e}")
    print(f"[{tag}] fp32 gate: greedy_generate tokens {toks.cpu().tolist()} == prefill/"
          f"decode_step argmax == the teacher-forced sequence's argmax; step logits within "
          f"{worst:.3e} of it (max |step - full| / max |full|, tolerance {TEACHER_TOL:g}); "
          f"flash_decode launches {launches}", flush=True)
    return {"worst": worst, "launches": launches}


def timed_generate(tag: str, cfg, params, batch, cache: int, per_step: int) -> dict:
    """The bf16 run: ``greedy_generate`` with the launch counts set to 0
    just before it (flash decode must launch ``per_step`` times a decode
    step), then prefill (median of 3) and each decode step alone
    (CUDA-synchronized host clock; TPOT is their median), and the peak
    device memory of it all."""
    import statistics
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_kernel
    from repro_torch.models import decode_step, greedy_generate, prefill
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    toks = greedy_generate(cfg, params, batch, FRONT_TOKENS, max_cache_len=cache)
    launches = flash_decode_kernel.launches
    if launches != per_step * (FRONT_TOKENS - 1):
        fail(f"{tag}: flash_decode launched {launches} times, not {per_step} a decode step")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size or \
            tuple(toks.shape) != (batch["tokens"].shape[0], FRONT_TOKENS):
        fail(f"{tag}: bf16 tokens of shape {tuple(toks.shape)} or out of the vocabulary")
    prefill_ms = _median_ms(lambda: prefill(cfg, params, batch, cache), reps=3)
    logits, state = prefill(cfg, params, batch, cache)
    steps = []
    for i in range(1, FRONT_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = decode_step(cfg, params, toks[:, i - 1], state)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()):
        fail(f"{tag}: bf16 logits not finite")
    flash_decode_kernel.launches = 0
    out = {"tpot_ms": statistics.median(steps), "prefill_ms": prefill_ms, "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "tokens": toks.cpu().tolist()}
    print(f"[{tag}] bf16: greedy_generate tokens {out['tokens']}; flash_decode launches "
          f"{launches} ({per_step} a decode step); TPOT median {out['tpot_ms']:.3f} ms over "
          f"{len(steps)} decode steps (each step alone, CUDA-synchronized host clock); prefill "
          f"{prefill_ms:.3f} ms (median of 3); peak device memory {out['peak_gb']:.2f} GB",
          flush=True)
    return out


def phase_encdec() -> dict:
    """seamless-m4t-large-v2 at full width and depth: the fp32 gate, then
    the bf16 run, through the encoder, the cross memories and the decoder
    with self and cross attention on the flash-decode kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.encdec import encdec_seq
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("seamless-m4t-large-v2")
    cache = FRONT_PROMPT + FRONT_TOKENS
    print(f"[encdec] {full.name}: {full.num_encoder_layers} encoder and {full.num_layers} "
          f"decoder layers, d_model {full.d_model}, heads {full.num_heads}/{full.num_kv_heads} "
          f"(G={full.num_heads // full.num_kv_heads}, Hd {full.resolved_head_dim}), d_ff "
          f"{full.d_ff}, vocab {full.vocab_size}, {full.norm_type}; "
          f"{full.param_count() / 1e9:.3f} B parameters; B={ENCDEC_BATCH}, 256 frames of "
          f"{full.frontend_dim}, prompt {FRONT_PROMPT}, {FRONT_TOKENS} tokens; cut: the gate "
          f"runs fp32 weights ({full.param_count() * 4 / 1e9:.1f} GB), the timed run bf16",
          flush=True)
    cfg32 = dataclasses.replace(full, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    batch = _front_batch(cfg32, ENCDEC_BATCH, torch.float32, seed=1)
    with torch.no_grad():
        gate = teacher_forced_gate(
            "encdec", cfg32, params, batch, cache,
            lambda toks: encdec_seq(cfg32, params, batch["frontend_embeds"], toks)[0])
    if gate["launches"] != 2 * full.num_layers * (FRONT_TOKENS - 1):
        fail(f"encdec: flash_decode launched {gate['launches']} times in the fp32 gate, not "
             f"self + cross in each of {full.num_layers} layers a decode step")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(full, seed=0, device="cuda")
    batch = _front_batch(full, ENCDEC_BATCH, torch.bfloat16, seed=1)
    run = timed_generate("encdec", full, params, batch, cache, 2 * full.num_layers)
    del params
    rows = {"self": flash_layout_row("encdec", ENCDEC_BATCH, cache, full.num_kv_heads,
                                     full.num_heads // full.num_kv_heads, full.resolved_head_dim),
            "cross": flash_layout_row("encdec", ENCDEC_BATCH, 256, full.num_kv_heads,
                                      full.num_heads // full.num_kv_heads,
                                      full.resolved_head_dim, cross=True)}
    return dict(run, gate=gate, flash=rows)


VLM_GATE_LAYERS = 4        # fp32 at all 48 layers would be ~80 GB


def phase_vlm() -> dict:
    """internvl2-26b at full width: the fp32 gate at 4 layers, then the
    bf16 run at full depth, 256 patch embeddings prepended to the prompt,
    a cache holding them all (``max_cache_len = 256 + 16 + 8``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import lm_seq
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("internvl2-26b")
    n_front = full.frontend_tokens
    cache = n_front + FRONT_PROMPT + FRONT_TOKENS
    print(f"[vlm] {full.name}: d_model {full.d_model}, heads {full.num_heads}/"
          f"{full.num_kv_heads} (G={full.num_heads // full.num_kv_heads}, Hd "
          f"{full.resolved_head_dim}), d_ff {full.d_ff}, vocab {full.vocab_size}, frontend dim "
          f"{full.frontend_dim}; {full.param_count() / 1e9:.3f} B parameters at "
          f"{full.num_layers} layers; B=1, {n_front} patches, prompt {FRONT_PROMPT}, "
          f"{FRONT_TOKENS} tokens, cache {cache}; cut: the fp32 gate runs {VLM_GATE_LAYERS} "
          f"layers", flush=True)
    cfg32 = dataclasses.replace(full, dtype="float32", num_layers=VLM_GATE_LAYERS)
    params = init_params(cfg32, seed=0, device="cuda")
    batch = _front_batch(cfg32, 1, torch.float32, seed=2)

    def full_logits(toks):
        logits, aux, _ = lm_seq(cfg32, params, toks, frontend_embeds=batch["frontend_embeds"])
        return logits[:, aux["n_front"]:]

    with torch.no_grad():
        gate = teacher_forced_gate("vlm", cfg32, params, batch, cache, full_logits)
    if gate["launches"] != VLM_GATE_LAYERS * (FRONT_TOKENS - 1):
        fail(f"vlm: flash_decode launched {gate['launches']} times in the fp32 gate, not once "
             f"in each of {VLM_GATE_LAYERS} layers a decode step")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(full, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[vlm] random bf16 parameters from seed 0, {full.num_layers} layers: "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card", flush=True)
    batch = _front_batch(full, 1, torch.bfloat16, seed=2)
    run = timed_generate("vlm", full, params, batch, cache, full.num_layers)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    row = flash_layout_row("vlm", 1, cache, full.num_kv_heads,
                           full.num_heads // full.num_kv_heads, full.resolved_head_dim)
    return dict(run, gate=gate, flash=row, layers=full.num_layers)


def eng_recall(res) -> str:
    r = res["trace"].recall()
    return "n/a" if r is None else f"{r:.4f}"


def main():
    t_start = time.perf_counter()
    smi_line = phase_card()
    import torch
    phase_build()
    # the process's first profiler session: later ones may keep no record
    # of a short call, which would leave the one-launch gate undecided
    int8_profile(4, D_MODEL, D_EXPERT)
    rows = phase_kernel()
    prows = phase_packed_kernel()
    frows = phase_flash()
    phase_small()
    moe = phase_slice()
    cfg, params = moe.pop("cfg"), moe.pop("params")
    serve = phase_serve(cfg, params)
    prefetch = phase_prefetch(cfg, params)
    pserve = phase_prefetch_serve(cfg, params, serve["steps_by_b"])
    spec = phase_spec(cfg, params)
    sserve = phase_spec_serve(cfg, params, serve["steps_by_b"])
    fleet = phase_fleet(cfg, params, moe)
    store = fleet.pop("store")
    fserve = phase_fleet_serve(cfg, params, serve, store)
    placement = phase_placement(cfg, params, moe, store)
    cvs = phase_cvs(cfg, params, moe, store)
    cluster = phase_cluster(cfg, params, serve, store, placement.pop("plan"))
    del store
    long = phase_long(cfg, params)
    del cfg, params, moe["batch"], moe["reference"]
    gc.collect()
    torch.cuda.empty_cache()
    packed = phase_packed_slice()
    torch.cuda.empty_cache()
    srows = phase_ssd()
    jamba = phase_jamba_slice()
    jcfg, jparams = jamba.pop("cfg"), jamba.pop("params")
    jamba_serve = phase_jamba_serve(jcfg, jparams)
    jamba_long = phase_jamba_long(jcfg, jparams)
    del jcfg, jparams
    qwen3 = phase_qwen3()
    qcfg, qparams = qwen3.pop("cfg"), qwen3.pop("params")
    qwen3_serve = phase_qwen3_serve(qcfg, qparams)
    del qcfg, qparams
    granite = phase_granite()
    gcfg, gparams = granite.pop("cfg"), granite.pop("params")
    dispatch = phase_dispatch(gcfg, gparams)
    train = phase_train_granite(gcfg, gparams)
    del gcfg, gparams, train["params"]
    train_ssm = phase_train_ssm()
    encdec = phase_encdec()
    vlm = phase_vlm()
    gc.collect()
    torch.cuda.empty_cache()
    irows = phase_int8()
    row, row32 = rows[(2, 1)], rows[("fp32", 2, 1)]
    prow, frow, vrow = prows[("int8", 2, 1)], frows[(4, 144)], spec["verify"]
    srow, irow = srows[(1, 4)], irows[(D_MODEL, D_EXPERT, torch.float32)]
    print("[memory] peak device memory while serving (while building the engine and pool): "
          + ", ".join(f"{n} {r['peak_gb']:.2f} GB ({r['built_gb']:.2f} GB)" for n, r in
                      (("serve", serve), ("prefetch-serve", pserve), ("spec-serve", sserve),
                       ("jamba-serve", jamba_serve), ("qwen3-serve", qwen3_serve)))
          + "; prefetch runs, peak while decoding: "
          + ", ".join(f"{n} {r['peak_gb']:.2f}" for n, r in prefetch["runs"].items()) + " GB"
          + "; single-stream phases, peak while building and decoding: " + ", ".join(
              f"{n} {r['peak_gb']:.2f} GB" for n, r in (
                  ("long", long), ("jamba-long", jamba_long), ("qwen3", qwen3),
                  ("granite", granite), ("encdec bf16", encdec), ("vlm bf16", vlm))))
    print(f"[prefill] engine prefill (main model, then the SEP shadow): slice "
          f"{moe['prefill_ms']:.3f} ms (16 tokens), long {long['prefill_ms']:.3f} ms "
          f"({LONG_PROMPT} tokens at the 4096 bucket), jamba-slice {jamba['prefill_ms']:.3f} ms "
          f"({JAMBA_PROMPT} tokens), jamba-long {jamba_long['prefill_ms']:.3f} ms "
          f"({LONG_PROMPT} tokens), qwen3 {qwen3['prefill_ms']:.3f} ms and granite "
          f"{granite['prefill_ms']:.3f} ms (16 tokens)")
    print(f"[tpot] single-stream TPOT medians: long {long['tpot_ms']:.3f} ms, jamba-long "
          f"{jamba_long['tpot_ms']:.3f} ms, qwen3 {qwen3['tpot_ms']:.3f} ms, granite "
          f"{granite['tpot_ms']:.3f} ms; encdec (B={ENCDEC_BATCH}) {encdec['tpot_ms']:.3f} ms, "
          f"vlm ({vlm['layers']} layers) {vlm['tpot_ms']:.3f} ms; prefill encdec "
          f"{encdec['prefill_ms']:.3f} ms, vlm {vlm['prefill_ms']:.3f} ms")
    print("[train] training steps (scatter, remat, AdamW fp32 moments): " + ", ".join(
        f"{n} step {r['step_ms']:.1f} ms (median of steps 2-{TRAIN_STEPS}), peak "
        f"{r['peak_gb']:.2f} GB, held loss {r['held'][0]:.4f} -> {r['held'][1]:.4f}, "
        f"checkpoint {r['ckpt_gb']:.2f} GB saved {r['save_s']:.1f} s / loaded {r['load_s']:.1f} s"
        for n, r in (("granite-moe-3b-a800m", train), ("mamba2-2.7b", train_ssm)))
        + f"; ssd_scan launches {train_ssm['per_step']} a mamba2 step")
    kernels = [{
        "name": "moe_ffn", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_ffn.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:61",
        "launches": moe["launches"], "max_abs_err": row["max_abs_err"],
        "spec_launches": spec["launches"]["moe_ffn"],
        "spec_serve_launches": sserve["launches"]["moe_ffn"],
        "fleet_launches": fleet["launches"]["moe_ffn"],
        "fleet_serve_launches": fserve["launches"]["moe_ffn"],
        "placement_launches": placement["launches"], "cvs_launches": cvs["launches"],
        "cluster_launches": cluster["launches"]["moe_ffn"],
        "long_launches": long["launches"]["moe_ffn"],
        "qwen3_launches": qwen3["launches"]["moe_ffn"],
        "qwen3_serve_launches": qwen3_serve["launches"]["moe_ffn"],
        "granite_launches": granite["launches"]["moe_ffn"],
        "dispatch_launches": dispatch["launches"],
        "top8_widths": list(qwen3["rows"].values()) + list(granite["rows"].values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": f"E=2 C=1 D={D_MODEL} F={D_EXPERT} bf16 weights (engine wave)",
        "fp32_ms": row32["ms"], "fp32_bound_ms": row32["bound_ms"],
        "fp32_library_ms": row32["library_ms"], "fp32_device_ms": row32["device_ms"],
        "fp32_shape": f"E=2 C=1 D={D_MODEL} F={D_EXPERT} fp32 weights (the packed slice's "
                      "dtype: its shadow and reference), library = torch.bmm fp32 formula",
    }, {
        "name": "moe_ffn_packed", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_ffn_packed.cu",
        "replaces": "src/repro/kernels/moe_gemm/packed.py:147",
        "launches": packed["launches"], "max_abs_err": prow["max_abs_err"],
        "ms": prow["ms"], "plain_ms": prow["plain_ms"], "bound_ms": prow["bound_ms"],
        "bound_by": prow["bound_by"], "library_ms": None, "device_ms": prow["device_ms"],
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
        "spec_launches": spec["launches"]["flash_decode"],
        "spec_serve_launches": sserve["launches"]["flash_decode"],
        "fleet_serve_launches": fserve["launches"]["flash_decode"],
        "cluster_launches": cluster["launches"]["flash_decode"],
        "long_launches": long["launches"]["flash_decode"],
        "qwen3_launches": qwen3["launches"]["flash_decode"],
        "qwen3_serve_launches": qwen3_serve["launches"]["flash_decode"],
        "granite_launches": granite["launches"]["flash_decode"],
        "encdec_launches": encdec["launches"], "vlm_launches": vlm["launches"],
        "new_layouts": [long["flash"], qwen3_serve["flash"], granite["flash"],
                        encdec["flash"]["self"], encdec["flash"]["cross"], vlm["flash"]],
        "verify_ms": vrow["ms"], "verify_plain_ms": vrow["plain_ms"],
        "verify_library_ms": vrow["library_ms"], "verify_bound_ms": vrow["bound_ms"],
        "verify_bound_by": vrow["bound_by"], "verify_max_abs_err": vrow["max_abs_err"],
        "verify_shape": f"B*S=4 W={SPEC_PROMPT + SPEC_TOKENS} K={N_KV} G={GROUP} "
                        f"Hd={HEAD_DIM} bf16 (spec phase's verify wave, k=4)",
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:44",
        "launches": jamba["launches"]["ssd_scan"], "max_abs_err": srow["max_abs_err"],
        "ms": srow["ms"], "plain_ms": srow["plain_ms"], "bound_ms": srow["bound_ms"],
        "bound_by": srow["bound_by"], "library_ms": None,
        "shape": f"B=1 NC=4 H={SSD_H} P={SSD_P} N={SSD_N} fp32 (jamba-slice prefill of "
                 f"{JAMBA_PROMPT} tokens); jamba-serve launches (engine+shadow): "
                 f"{jamba_serve['launches']['ssd_scan']}",
        "jamba_long_launches": jamba_long["launches"]["ssd_scan"],
        "nc12": srows[(1, JAMBA_LONG_CHUNKS)],
        "train_launches": train_ssm["launches"]["ssd_scan"],
        "train_launches_per_step": train_ssm["per_step"],
        "train_grad_errors": train_ssm["grad_errs"],
    }, {
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul/kernel.py:56",
        "launches": prefetch["launches"]["int8_matmul"], "max_abs_err": irow["max_abs_err"],
        "ms": irow["ms"], "plain_ms": irow["plain_ms"], "bound_ms": irow["bound_ms"],
        "bound_by": irow["bound_by"], "library_ms": None, "cold_l2_ms": irow["cold_ms"],
        "yardstick_ms": irow["yardstick_fp32_ms"],
        "yardstick": "cuBLAS fp32 x @ w on weights dequantized beforehand (no PyTorch call "
                     "dequantizes inside its product)",
        "shape": f"M=4 K={D_MODEL} N={D_EXPERT}, fp32 x, int8 w, fp32 scale; on no path of "
                 f"the port, as in the JAX package (launches counted on the prefetch runs)",
    }]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
