"""Serving entry point: the OD-MoE cacheless engine.

Single-stream mode (the paper's experiment):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --tokens 32 --predictor sep --shadow int8 --device cuda

  PYTHONPATH=src python -m repro_torch.launch.serve --packed-slots \
      --transport-precision tiered

Continuous-batching mode (``repro_torch.serve``), enabled by
``--requests``:

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \
      --arrival-rate 2.0 --max-batch 4 [--kv-pages 24 --page-tokens 16]

Cluster mode (``repro_torch.serve.cluster``): N replica loops over one
shared worker fleet and expert store, with optional gate-statistics
expert placement and compute-vs-ship:

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 \
      --replicas 2 --routing least_loaded --placement gate-stats --compute-vs-ship

All run real prefill + decode through ``ODMoEEngine`` (prediction,
on-demand loading, alignment, eviction) on the registry config's
reduced variant and check the tokens against the dense reference under
the same transport policy (per request, against its solo decode, in
serving mode).  They print recall, loads, bytes moved, memory and the
measured wall time per decoded token or per composed step, then what
the timing model gives for the paper's testbed (a model, never a
measurement).  ``--packed-slots`` keeps wire-format experts in the
worker slots and computes them with the in-register-dequant kernel;
``--token-period`` / ``--kv-period`` set how often the SEP shadow aligns
its token and KV with the main model; ``--speculate k`` decodes in
shadow-drafted waves of k positions and prints the acceptance.
``--placement gate-stats`` calibrates a ``GateStatsRecorder`` on a short
decode of a prompt drawn from ``--seed`` + 2 (by this package's generator,
so the plan can differ from the JAX command line's, whose prompt comes
from JAX's) and places the experts with ``optimize_placement``;
``--compute-vs-ship`` computes a cold expert on the main node when
streaming it from host memory beats its worker's link.  As in the JAX
package, the command line has no fault flags: fleet profiles and fault
scripts are engine options.
"""
from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (RTX3090_EDGE, AlignmentPolicy, ODMoEEngine, node_memory_report,
                              simulate_cached, simulate_odmoe)
from repro_torch.device import resolve_device
from repro_torch.fleet import (FleetSchedule, GateStatsRecorder, expected_t_maxload, modulo_plan,
                               optimize_placement)
from repro_torch.kernels.flash_decode import flash_decode_kernel
from repro_torch.kernels.int8_matmul import int8_matmul_kernel
from repro_torch.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_packed_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.models import greedy_generate, init_params
from repro_torch.quant import TieredPolicy, UniformPolicy
from repro_torch.serve import (BatchComposer, KVPool, ServingLoop, WorkloadSpec,
                               dense_cache_footprint, make_cluster, make_trace, make_traffic)
from repro_torch.serve.cluster import ROUTING_POLICIES

MODELLED = f"modelled ({RTX3090_EDGE.name} profile, not measured)"
# every hand-written kernel of the port, by name; as in the JAX package,
# no decode path calls int8_matmul, so its count stays 0 here
KERNELS = {"moe_ffn": moe_ffn_kernel, "moe_ffn_packed": moe_ffn_packed_kernel,
           "flash_decode": flash_decode_kernel, "ssd_scan": ssd_scan_kernel,
           "int8_matmul": int8_matmul_kernel}


def _launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _since(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in KERNELS}


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
    ap.add_argument("--token-period", type=int, default=1,
                    help="align the shadow's input token with the main model's every "
                         "N steps (0 = never)")
    ap.add_argument("--kv-period", type=int, default=1,
                    help="copy the main model's KV into the shadow every N steps "
                         "(0 = never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speculate", type=int, default=1,
                    help="shadow-drafted speculative decoding: verify k draft positions "
                         "per wave (1 = off; needs --predictor sep)")
    ap.add_argument("--transport-precision", default="fp32",
                    choices=["fp32", "fp16", "int8", "nf4", "tiered"],
                    help="on-demand expert wire precision; 'tiered' calibrates a "
                         "confidence-tiered fp16+int8 policy from a short decode")
    ap.add_argument("--packed-slots", action="store_true",
                    help="packed-resident worker slots: keep the wire-format codes "
                         "and scales resident and dequantize in registers inside "
                         "the grouped kernel (same tokens, smaller slots)")
    # ------------------------------------------------- serving mode flags
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N requests through continuous batching (0 = single "
                         "stream)")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="arrival rate, requests/s of modelled time (<=0: all at t=0)")
    ap.add_argument("--max-batch", type=int, default=4, help="composed decode batch cap")
    ap.add_argument("--compose", default="overlap", choices=["overlap", "fifo", "fair"],
                    help="batch composition policy (fair: per-tenant weighted deficit "
                         "round-robin)")
    ap.add_argument("--workload", default="uniform", choices=["uniform", "trace"],
                    help="'uniform': the near-uniform make_traffic mix; 'trace': "
                         "heavy-tailed multi-tenant traffic (repro_torch.serve.workload)")
    ap.add_argument("--arrival", default="bursty", choices=["poisson", "bursty", "diurnal"],
                    help="arrival process for --workload trace")
    ap.add_argument("--preempt", default="youngest", choices=["youngest", "slack"],
                    help="KV-page preemption victim: youngest admission, or most "
                         "TPOT-deadline slack")
    ap.add_argument("--admit", default="fifo", choices=["fifo", "priority"],
                    help="admission order: arrival FIFO, or tenant-weight priority")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="serve decode KV out of a paged pool of this many pages "
                         "(0 = dense per-request buffers)")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="KV slots per page (with --kv-pages)")
    # ------------------------------------------------- cluster mode flags
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas over one shared worker fleet and expert store "
                         "(> 1 routes the --requests traffic through ClusterRouter)")
    ap.add_argument("--routing", default="least_loaded", choices=list(ROUTING_POLICIES),
                    help="per-request replica routing policy (with --replicas > 1)")
    ap.add_argument("--placement", default="modulo", choices=["modulo", "gate-stats"],
                    help="expert placement: 'modulo', the paper's i mod G mapping; "
                         "'gate-stats', a plan optimized on gate statistics from a short "
                         "calibration decode (same tokens either way)")
    ap.add_argument("--compute-vs-ship", action="store_true",
                    help="compute a cold expert on the main node when streaming it from "
                         "host memory beats its worker's link (same weights, same tokens)")
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


def print_prefetch_report(eng) -> None:
    """The prefetch and residency counters, when either ran."""
    if eng.prefetch is None and eng.residency is None:
        return
    rep = eng.prefetch_report()
    print("  prefetch/residency: " + ", ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in rep.items()))


def build_placement(cfg, params, args):
    """--placement gate-stats: calibrate a ``GateStatsRecorder`` on a
    short decode without a predictor, optimize the placement on it, and
    return a ``FleetSchedule`` carrying the plan (None for 'modulo')."""
    if args.placement != "gate-stats":
        return None
    device = params["embed"]["table"].device
    cal = GateStatsRecorder()
    eng = ODMoEEngine(cfg, params, n_workers=args.workers, predictor="none", gate_stats=cal,
                      device=device)
    eng.generate(_prompt(cfg, args.prompt_len, args.seed + 2, device), max(8, args.tokens // 2))
    expert_bytes = eng.store.expert_bytes
    del eng
    g = max(cfg.top_k, 1)
    base = FleetSchedule(args.workers, g)
    kw = dict(num_experts=cfg.num_experts, n_moe=cal.n_layers)
    bkw = dict(kw, expert_bytes=expert_bytes)
    plan = optimize_placement(cal, base, **bkw)
    e_opt = expected_t_maxload(plan, cal, base, **bkw)
    e_mod = expected_t_maxload(modulo_plan(base, **kw), cal, base, **bkw)
    print(f"  placement: gate-stats plan over {cal.n_layers} MoE layers; expected t_maxload "
          f"{e_opt * 1e3:.4f} ms vs modulo {e_mod * 1e3:.4f} ms (modelled, "
          f"{base.link_gbps_of(0):g} GB/s links)")
    return FleetSchedule(args.workers, g, plan=plan)


def engine_kwargs(cfg, params, args, transport) -> dict:
    """``ODMoEEngine`` keywords shared by the single-stream, serving and
    cluster paths: predictor, transport, the placement schedule (or the
    worker count) and compute-vs-ship."""
    kw = dict(predictor=args.predictor, shadow_scheme=args.shadow, seed=args.seed,
              transport=transport, device=params["embed"]["table"].device,
              packed_slots=args.packed_slots, speculate=args.speculate)
    sched = build_placement(cfg, params, args)
    if sched is not None:
        kw["sched"] = sched
    else:
        kw["n_workers"] = args.workers
    if args.compute_vs_ship:
        kw["compute_vs_ship"] = True
    return kw


def print_hosted(trace) -> None:
    """How many experts compute-vs-ship kept on the main node."""
    hosted = sum(len(lr.hosted) for rec in trace.records for lr in rec.layers)
    if hosted:
        print(f"  compute-vs-ship: {hosted} experts computed on the main node over "
              f"{len(trace.records)} steps ({hosted / len(trace.records):.3f} per step)")


def serve_single(cfg, params, args) -> dict:
    """Decode one random prompt with the engine and with the dense
    reference; print the comparison and the engine's accounting.
    Returns the tokens, the engine, its trace, the transport policy and
    the launches of each kernel on each side, by kernel name."""
    device = params["embed"]["table"].device
    batch = _prompt(cfg, args.prompt_len, args.seed, device)
    transport = build_transport(cfg, params, args)
    kw = engine_kwargs(cfg, params, args, transport)
    launches0 = _launches()
    eng = ODMoEEngine(cfg, params, **kw)
    _sync(device)
    t0 = time.perf_counter()
    toks, trace = eng.generate(batch, args.tokens,
                               AlignmentPolicy(args.token_period, args.kv_period))
    _sync(device)
    t_engine = time.perf_counter() - t0
    launches1 = _launches()
    ref = greedy_generate(cfg, params, batch, args.tokens, transport=transport)
    engine_launches = _since(launches0, launches1)
    reference_launches = _since(launches1, _launches())
    exact = torch.equal(toks.cpu(), ref.cpu())
    print(f"  tokens == dense reference (same transport policy): {exact}")
    if not exact:
        raise AssertionError("engine output diverged from the reference")
    rec = trace.recall()
    print(f"  recall (Eq.3): {'n/a (no predictions)' if rec is None else f'{rec:.4f}'}"
          f"   reload fraction: {trace.reload_fraction():.4f}")
    if args.speculate > 1:
        drafted = sum(r.spec_len for r in trace.records)
        committed = sum(r.committed for r in trace.records)
        print(f"  speculation k={args.speculate}: acceptance "
              f"{committed / max(drafted, 1):.3f} over {len(trace.records)} waves")
    print(f"  loads: {eng.slots.stats}")
    print_hosted(trace)
    print(f"  bytes moved [{eng.transport.describe()}]: {eng.slots.bytes_moved} "
          f"({eng.slots.bytes_moved / 1e9:.3f} GB over "
          f"{eng.slots.stats['loads']} loads)")
    print_transport_stats(eng)
    mem = eng.memory_report()
    print("  memory: " + ", ".join(f"{k}={v / 1e6:.2f}MB" for k, v in mem.items()
                                   if k.endswith("bytes")))
    steps = [r.seconds for r in trace.records]
    if steps and args.speculate > 1:
        committed = sum(r.committed for r in trace.records) // toks.shape[0]
        print(f"  measured wall time per verify wave on {device}: mean "
              f"{statistics.mean(steps) * 1e3:.3f} ms, median "
              f"{statistics.median(steps) * 1e3:.3f} ms over {len(steps)} waves; "
              f"{sum(steps) / committed * 1e3:.3f} ms per committed token over {committed} "
              f"(generate total {t_engine:.3f} s, prefill included)")
    elif steps:
        print(f"  measured wall time per decoded token on {device}: "
              f"mean {statistics.mean(steps) * 1e3:.3f} ms, median "
              f"{statistics.median(steps) * 1e3:.3f} ms over {len(steps)} tokens "
              f"(generate total {t_engine:.3f} s, prefill included)")
    print(f"  kernel launches: engine+shadow {engine_launches}, reference "
          f"{reference_launches}")
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
            "launches_engine": engine_launches, "launches_reference": reference_launches,
            "modelled_tok_s": modelled, "step_seconds": steps}


def build_requests(cfg, args):
    if args.workload == "trace":
        spec = WorkloadSpec(n_requests=args.requests, rate=args.arrival_rate,
                            arrival=args.arrival, prompt_median=args.prompt_len,
                            max_prompt=4 * args.prompt_len, output_median=args.tokens,
                            max_output=2 * args.tokens)
        return make_trace(cfg, spec, seed=args.seed)
    return make_traffic(cfg, args.requests, args.arrival_rate, prompt_len=args.prompt_len,
                        max_new=args.tokens, seed=args.seed)


def check_bit_exact(cfg, params, reqs, outputs, transport) -> bool:
    """Every served request must equal its solo reference decode under the
    same transport policy."""
    device = params["embed"]["table"].device
    exact = True
    for r in reqs:
        ref = greedy_generate(cfg, params,
                              {"tokens": torch.as_tensor(r.prompt, device=device)[None, :]},
                              r.max_new_tokens, transport=transport)[0]
        exact &= bool(np.array_equal(ref.cpu().numpy(), outputs[r.rid]))
    print(f"  per-request tokens == solo reference (same transport policy): {exact}")
    if not exact:
        raise AssertionError("serving output diverged from the single-request reference")
    return exact


def _percentile_line(rep, m: str) -> str:
    return (f"  {m.upper()}  mean {rep[f'{m}_mean_s'] * 1e3:.2f} ms   "
            f"p50 {rep[f'{m}_p50_s'] * 1e3:.2f}   p95 {rep[f'{m}_p95_s'] * 1e3:.2f}   "
            f"p99 {rep[f'{m}_p99_s'] * 1e3:.2f}   [{MODELLED}]")


def serve_traffic(cfg, params, args, **engine_options) -> dict:
    """Serve ``--requests`` through ``ServingLoop``, check every request
    against its solo decode, and print the latency report (modelled), the
    measured composed-step times by batch size, load amortization and the
    KV pool's counters.  ``engine_options`` go to ``ODMoEEngine``
    (``prefetch``, ``residency``: the JAX package's command line has no
    flag for them).  Returns the result, the engine, the pool, the kernel
    launches on the serving side and on the reference side, and on a CUDA
    device the peak of allocated memory while building the engine and the
    pool (``build_peak_bytes``) and while serving (``serving_peak_bytes``);
    both are None on the host."""
    device = params["embed"]["table"].device
    transport = build_transport(cfg, params, args)
    kw = dict(engine_kwargs(cfg, params, args, transport), **engine_options)
    launches0 = _launches()
    eng = ODMoEEngine(cfg, params, **kw)
    reqs = build_requests(cfg, args)
    kv_pool = (KVPool(cfg, num_pages=args.kv_pages, page_tokens=args.page_tokens,
                      device=device) if args.kv_pages else None)
    loop = ServingLoop(eng, max_batch=args.max_batch,
                       composer=BatchComposer(args.max_batch, args.compose, kv_pool=kv_pool),
                       kv_pool=kv_pool, preempt=args.preempt, admit=args.admit,
                       policy=AlignmentPolicy(args.token_period, args.kv_period))
    on_card = torch.device(device).type == "cuda"
    build_peak = serving_peak = None
    if on_card:
        build_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    res = loop.run(reqs)
    if on_card:
        serving_peak = torch.cuda.max_memory_allocated(device)
    launches1 = _launches()
    check_bit_exact(cfg, params, reqs, res.outputs, transport)
    launches2 = _launches()
    rep = res.timings.report()
    print(f"  requests: {rep['n_requests']}  tokens: {rep['total_tokens']}  mean batch: "
          f"{res.mean_batch:.2f}")
    for m in ("ttft", "tpot"):
        print(_percentile_line(rep, m))
    print(f"  throughput: {rep['throughput_tok_s']:.2f} tok/s over {rep['makespan_s']:.3f} s "
          f"makespan [{MODELLED}]")
    by_b = defaultdict(list)
    for st in res.steps:
        by_b[len(st.request_ids)].append(st.wall_s)
    print(f"  measured composed decode step on {device} (median wall time, host clock "
          "ending in a device sync): " + ", ".join(
              f"B={b} {statistics.median(ts) * 1e3:.3f} ms (n={len(ts)})"
              for b, ts in sorted(by_b.items())))
    if args.workload == "trace":
        print(f"  trace: {args.arrival} arrivals, preempt={args.preempt}, admit={args.admit}, "
              f"compose={args.compose}")
        for name, tr in res.tenant_report().items():
            print(f"  [{name}] n={tr['n_requests']}  TTFT p50/p95/p99 "
                  f"{tr['ttft_p50_s'] * 1e3:.2f}/{tr['ttft_p95_s'] * 1e3:.2f}/"
                  f"{tr['ttft_p99_s'] * 1e3:.2f} ms  TPOT p95 {tr['tpot_p95_s'] * 1e3:.2f} ms  "
                  f"SLO ttft {tr['ttft_slo_attainment']:.2f} tpot "
                  f"{tr['tpot_slo_attainment']:.2f}  [{MODELLED}]")
    if res.spec_stats is not None:
        ss = res.spec_stats
        print(f"  speculation k={ss['speculate']}: acceptance {ss['acceptance']:.3f} over "
              f"{len(ss['per_request'])} requests")
    ev = eng.slots.events
    served = [len(e.requests) for e in ev if e.requests]
    if served:
        print(f"  loads: {len(ev)}  mean requests/load: {np.mean(served):.2f}  "
              f"multi-request loads: {sum(1 for s in served if s > 1)}/{len(served)}  "
              f"loads/step: {len(ev) / max(len(res.steps), 1):.3f}")
    print(f"  load stats: {eng.slots.stats}")
    print_hosted(res.trace)
    print_transport_stats(eng)
    print_prefetch_report(eng)
    if kv_pool is not None:
        st = res.kv_stats
        occ = [s.kv_pages_used for s in res.steps if s.kv_pages_used >= 0]
        dense = dense_cache_footprint(cfg, kv_pool.window_pages * kv_pool.page_tokens,
                                      len(reqs))
        print(f"  kv pool: {st['num_pages']} pages x {st['page_tokens']} tokens = "
              f"{st['pool_bytes'] / 1e6:.2f} MB (dense footprint for {len(reqs)} requests: "
              f"{dense / 1e6:.2f} MB)")
        print(f"  occupancy: peak {st['peak_pages_used']}/{st['num_pages']} pages"
              + (f", mean {np.mean(occ):.1f}" if occ else "")
              + f"  deferred admissions: {st['deferred_admissions']}")
        print(f"  preemptions: {st['preemptions']}  resumes: {st['resumes']}  swapped: "
              f"{(st['swap_out_bytes'] + st['swap_in_bytes']) / 1e6:.2f} MB "
              f"({st['swap_s'] * 1e3:.3f} ms {MODELLED})")
    mem = node_memory_report(eng, kv_pool)
    print("  per-node memory: " + ", ".join(f"{k}={v / 1e6:.2f}MB" for k, v in mem.items()
                                            if k.endswith("bytes")))
    if on_card:
        print(f"  peak allocated device memory: {build_peak / 1e9:.2f} GB while building the "
              f"engine and the pool, {serving_peak / 1e9:.2f} GB while serving")
    per_req = {r.rid: 0 for r in reqs}
    for e in ev:
        for rid in e.requests:
            if rid in per_req:
                per_req[rid] += e.bytes
    if any(per_req.values()):
        vals = list(per_req.values())
        print(f"  wire bytes/request: mean {np.mean(vals) / 1e6:.2f} MB  max "
              f"{max(vals) / 1e6:.2f} MB")
    serving, reference = _since(launches0, launches1), _since(launches1, launches2)
    print(f"  kernel launches: serving (engine+shadow) {serving}, reference {reference}")
    return {"result": res, "engine": eng, "kv_pool": kv_pool, "requests": reqs,
            "launches_serving": serving, "launches_reference": reference,
            "build_peak_bytes": build_peak, "serving_peak_bytes": serving_peak}


def serve_cluster(cfg, params, args, **engine_options) -> dict:
    """Serve ``--requests`` through ``--replicas`` replicas
    (``make_cluster``: one store, one fleet schedule, one gate-stats
    recorder, dense KV), check every request against its solo decode, and
    print the cluster report (modelled), each replica's rows and measured
    composed-step times.  Returns the result, the router, the requests,
    the recorder and the kernel launches on the serving and the reference
    side."""
    device = params["embed"]["table"].device
    transport = build_transport(cfg, params, args)
    gate_stats = GateStatsRecorder()
    kw = dict(engine_kwargs(cfg, params, args, transport), gate_stats=gate_stats,
              **engine_options)
    reqs = build_requests(cfg, args)
    launches0 = _launches()
    router = make_cluster(cfg, params, replicas=args.replicas, policy=args.routing,
                          engine_kw=kw, loop_kw=dict(max_batch=args.max_batch))
    res = router.run(reqs)
    _sync(device)
    launches1 = _launches()
    check_bit_exact(cfg, params, reqs, res.outputs, transport)
    launches2 = _launches()
    rep = res.report()
    print(f"  cluster: {rep['replicas']} replicas, routing={res.policy}, requests: "
          f"{rep['n_requests']}, tokens: {rep['total_tokens']}")
    for m in ("ttft", "tpot"):
        print(_percentile_line(rep, m))
    print(f"  throughput: {rep['throughput_tok_s']:.2f} tok/s over {rep['makespan_s']:.3f} s "
          f"makespan [{MODELLED}]")
    for i, (rr, r) in enumerate(zip(rep["per_replica"], res.replicas)):
        by_b = defaultdict(list)
        for st in r.steps:
            by_b[len(st.request_ids)].append(st.wall_s)
        print(f"  [replica {i}] n={rr['requests']}  mean batch {rr['mean_batch']:.2f}  "
              f"TTFT p95 {rr['ttft_p95_s'] * 1e3:.2f} ms [{MODELLED}]; measured composed "
              f"step on {device}: " + ", ".join(
                  f"B={b} {statistics.median(ts) * 1e3:.3f} ms (n={len(ts)})"
                  for b, ts in sorted(by_b.items())))
        print_hosted(r.trace)
    if res.autoscale_events:
        print(f"  autoscale events: {res.autoscale_events}")
    print(f"  pooled gate stats: {gate_stats.n_layers} MoE layers, "
          f"{sum(gate_stats.rows.values())} routed rows")
    serving, reference = _since(launches0, launches1), _since(launches1, launches2)
    print(f"  kernel launches: serving (engines+shadows) {serving}, reference {reference}")
    return {"result": res, "router": router, "requests": reqs, "gate_stats": gate_stats,
            "launches_serving": serving, "launches_reference": reference}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if not cfg.num_experts:
        raise SystemExit(f"{args.arch} has no experts: OD-MoE loading does "
                         "not apply")
    if args.replicas > 1 and not args.requests:
        raise SystemExit("--replicas > 1 needs --requests traffic")
    params = init_params(cfg, seed=args.seed, device=device)
    mode = (f"continuous batching: {args.requests} {args.workload} requests @ "
            f"{args.arrival_rate}/s, max-batch {args.max_batch} ({args.compose})"
            + (f", {args.replicas} replicas ({args.routing})" if args.replicas > 1 else "")
            if args.requests else "single stream")
    print(f"[serve] {cfg.name} on {device}: E={cfg.num_experts} top{cfg.top_k}, "
          f"{args.workers} workers, predictor={args.predictor}"
          + (f"/{args.shadow}" if args.predictor == "sep" else "")
          + f", transport={args.transport_precision}"
          + (", packed slots" if args.packed_slots else "")
          + (f", speculate {args.speculate}" if args.speculate > 1 else "")
          + f", placement={args.placement}"
          + (", compute-vs-ship" if args.compute_vs_ship else "") + f" — {mode}")
    if args.requests and args.replicas > 1:
        serve_cluster(cfg, params, args)
    elif args.requests:
        serve_traffic(cfg, params, args)
    else:
        serve_single(cfg, params, args)


if __name__ == "__main__":
    main()
