"""Discrete-event timing model of OD-MoE decode on the paper's testbed.

These are modelled times, never measurements: stage durations derive
from the bytes each stage moves at calibrated effective bandwidths,

    t_compute(stage) = stage_param_bytes / eff_hbm_Bps
    t_load(expert)   = expert_bytes      / pcie_Bps
    t_lan(payload)   = payload_bytes     / lan_Bps + lan_latency

and the OD-MoE pipeline (worker grouping, staggered loads, shadow
lookahead, alignment late departure, misprediction reloads) is replayed
event by event from an engine ``Trace``, following Figs. 2/4/5.  The
paper's comparison systems (fully cached, CPU, single-node LRU/LFU expert
offloading with optional expert quantization) and the prefill models
price the same config, the offload cache on the same routing trace;
``synthetic_trace`` builds such a trace for a full-size config.
The serving loop drives the same clock step by step, charging prefills
and KV swaps between decode steps; ``ServingTimings`` turns the
per-request timestamps into TTFT/TPOT/throughput.  A speculative verify
wave is priced by its width (wider activation hops, and the shadow's
extra draft passes before its predictions).  ``RTX3090_EDGE`` is
the paper's edge testbed.  Over a ``repro_torch.fleet.FleetSchedule``
each load is priced on its worker's own (throttled) link, dead workers
drop out of the orders (a placement plan's orders, where it has one), and
``simulate_odmoe(..., faults=)`` replays a fault script.  Experts that
compute-vs-ship hosted on the main node cross no link: each costs its
full-width stream from host memory after the gate.  Cluster replicas run
one clock each over a shared ``worker_free``.  Counterpart:
``repro.core.timing``.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.config import ATTN, DENSE_FF, MOE_FF, ModelConfig
from repro_torch.quant.transport import resolve_policy, transport_expert_bytes

from .align import kv_bytes_per_token
from .engine import LayerRecord, TokenRecord, Trace
from .schedule import GroupSchedule


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    eff_hbm_gbps: float        # effective weight-streaming bandwidth, GB/s
    pcie_gbps: float           # CPU->GPU expert-loading bandwidth, GB/s
    lan_gbps: float            # inter-node link, Gbit/s
    lan_latency_ms: float      # per-message overhead
    cpu_mem_gbps: float = 40.0   # for a CPU-inference baseline
    weight_bytes: int = 4        # full-precision deployment (paper: FP32)

    @property
    def lan_bps(self) -> float:
        return self.lan_gbps * 1e9 / 8

    def t_lan(self, payload_bytes: float) -> float:
        return payload_bytes / self.lan_bps + self.lan_latency_ms * 1e-3

    def t_stream(self, param_bytes: float) -> float:
        return param_bytes / (self.eff_hbm_gbps * 1e9)

    def t_load(self, param_bytes: float) -> float:
        return param_bytes / (self.pcie_gbps * 1e9)


# The paper's testbed: RTX 3090 nodes on a 1 Gbit/s LAN.  Calibrated so the
# fully-cached reference lands at the paper's ~4.9 tok/s for Mixtral-8x7B
# FP32 (its Table 2); every other number is derived from it.
RTX3090_EDGE = HardwareProfile(
    name="rtx3090-edge", eff_hbm_gbps=260.0, pcie_gbps=24.0,
    lan_gbps=1.0, lan_latency_ms=0.15, cpu_mem_gbps=42.0, weight_bytes=4)


def layer_bytes(cfg: ModelConfig, wb: int) -> Dict[str, float]:
    """Parameter bytes per layer kind (drives stage durations)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * d) * wb
    return {"attn": attn, "dense_ff": 3 * d * cfg.d_ff * wb,
            "expert": 3 * d * cfg.d_expert_resolved * wb,
            "router": d * cfg.num_experts * wb, "mamba": cfg._mamba_params() * wb,
            "embed": cfg.vocab_size * d * wb}


def embedding_payload(cfg: ModelConfig, wb: int = 4) -> float:
    """One token's activation shipped main<->worker (paper: ~16 KB)."""
    return cfg.d_model * wb


def degraded_tpot_report(per_token_s: List[float], alive_workers: List[int],
                         n_workers: int) -> Dict[str, float]:
    """Split per-token decode time into healthy-fleet and degraded-fleet
    steps (any worker dead = degraded).  Every value is finite: an empty
    bucket reports 0.0, and an all-healthy run has ``healthy_only`` True
    and ``degradation_x`` 1.0."""
    healthy = [d for d, a in zip(per_token_s, alive_workers) if a >= n_workers]
    degraded = [d for d, a in zip(per_token_s, alive_workers) if a < n_workers]

    def mean(xs):
        return float(np.mean(xs)) if xs else 0.0

    return {
        "steps": len(per_token_s),
        "degraded_steps": len(degraded),
        "healthy_only": not degraded,
        "min_alive_workers": min(alive_workers) if alive_workers else n_workers,
        "tpot_s": mean(per_token_s),
        "tpot_healthy_s": mean(healthy),
        "tpot_degraded_s": mean(degraded),
        "degradation_x": (mean(degraded) / mean(healthy)
                          if healthy and degraded else 1.0),
    }


@dataclass
class ODMoETimings:
    per_token_s: List[float]
    io_stall_s: List[float]
    # alive workers after each step's faults (``simulate_odmoe`` fills it:
    # the whole fleet throughout when the schedule has no fleet state)
    alive_workers: Optional[List[int]] = None

    @property
    def tokens_per_s(self) -> float:
        return 1.0 / float(np.mean(self.per_token_s))

    def degraded_report(self, n_workers: int) -> Dict[str, float]:
        alive = self.alive_workers or [n_workers] * len(self.per_token_s)
        return degraded_tpot_report(self.per_token_s, alive, n_workers)


class DecodeClock:
    """Fig. 2 replay, one decode iteration at a time on a continuous
    clock with per-worker timelines.  A worker's next predicted load
    starts as soon as the prediction exists and the worker is free, so
    loads for layer l+G-1 overlap the compute of layer l; mispredicted
    experts reload only after the main node's gate result.

    Loads are priced by each expert's PACKED bytes under ``transport``,
    over the loading worker's link (``t_load_for``).  Worker compute
    streams full-width weights (dequantize on arrival), or with
    ``packed_compute`` the packed ones (packed-resident slots and the
    in-register-dequant kernel)."""

    def __init__(self, cfg: ModelConfig, sched: GroupSchedule, profile: HardwareProfile,
                 shadow_scheme: str = "int8", predictor: str = "sep", transport=None,
                 worker_free: Optional[Dict[int, float]] = None,
                 packed_compute: bool = False):
        self.sched = sched
        self.profile = profile
        self.predictor = predictor
        wb = profile.weight_bytes
        lb = layer_bytes(cfg, wb)
        self.kinds = cfg.layer_kinds()
        emb = embedding_payload(cfg, wb)
        self.emb = emb
        self.transport = resolve_policy(transport)
        self.packed_compute = packed_compute
        self._cfg = cfg
        self._wb = wb
        self._scheme_bytes_cache: Dict[str, float] = {"fp32": lb["expert"]}
        default_packed = (lb["expert"] if self.transport.trivial else
                          self._scheme_bytes(self.transport.default_scheme))
        self.t_main_attn = profile.t_stream(lb["attn"]) + 2 * profile.t_lan(emb)
        self.t_main_mamba = profile.t_stream(lb["mamba"])
        self.t_main_dense_ff = profile.t_stream(lb["dense_ff"])
        self.t_router = profile.t_stream(lb["router"])
        expert_stream = default_packed if packed_compute else lb["expert"]
        self.t_worker = profile.t_stream(expert_stream) + profile.t_lan(emb)
        self.t_load = profile.t_load(default_packed)
        self.t_head = profile.t_stream(lb["embed"])
        self._expert_bytes = default_packed
        # compute-vs-ship: a hosted expert streams its full-width weights
        # from the main node's host memory
        self.t_exp_host = lb["expert"] / (profile.cpu_mem_gbps * 1e9)
        # a FleetSchedule's shared liveness and throttle state
        self._fleet_state = getattr(sched, "state", None)
        # the shadow runs the whole (quantized) model on its own node
        qf = {"fp16": 0.5, "int8": 0.25, "nf4": 0.125}.get(shadow_scheme, 1.0)
        shadow_active = cfg.active_param_count() * wb * qf
        self.t_shadow_layer = profile.t_stream(shadow_active / cfg.num_layers)
        self.align_payload = kv_bytes_per_token(cfg, wb)
        # may be shared: cluster replicas run a clock each over one fleet,
        # so a worker loading for one replica delays the others
        self.worker_free: Dict[int, float] = (
            worker_free if worker_free is not None else defaultdict(float))
        self.now = 0.0

    def _scheme_bytes(self, scheme: str) -> float:
        """Packed bytes of one expert at ``scheme`` (cached)."""
        if scheme not in self._scheme_bytes_cache:
            self._scheme_bytes_cache[scheme] = transport_expert_bytes(self._cfg, scheme,
                                                                      self._wb)
        return self._scheme_bytes_cache[scheme]

    def _bytes_for(self, layer: int, expert) -> float:
        """Wire payload of loading ``expert`` at ``layer`` (the policy's
        default when the expert is unknown: group-padding loads)."""
        if self.transport.trivial or expert is None:
            return self._expert_bytes
        return self._scheme_bytes(self.transport.scheme_for(layer, int(expert)))

    def t_load_for(self, worker: int, nbytes: Optional[float] = None) -> float:
        """One load of ``nbytes`` packed payload (default: one expert at the
        policy's default scheme) on ``worker``'s link: the fleet schedule's
        profiled bandwidth times its throttle, with this hardware profile's
        PCIe rate for unpinned links; a base schedule prices every link at
        PCIe."""
        nbytes = self._expert_bytes if nbytes is None else nbytes
        t_load_s = getattr(self.sched, "t_load_s", None)
        if t_load_s is None:
            return self.profile.t_load(nbytes)
        return t_load_s(worker, nbytes, default_gbps=self.profile.pcie_gbps)

    def alive_workers(self) -> int:
        """Workers alive now (the whole fleet without a fleet state)."""
        return (self._fleet_state.n_alive if self._fleet_state is not None
                else self.sched.n_workers)

    def advance_to(self, t: float) -> None:
        """Idle until ``t`` (waiting for the next arrival)."""
        if t > self.now:
            self.now = t

    def charge_prefill(self, seconds: float) -> None:
        """Serialize a prefill on the pipeline: the main node and every
        worker are busy for its duration (§3.3 loads every expert across
        the workers)."""
        self.now += seconds
        for w in range(self.sched.n_workers):
            self.worker_free[w] = max(self.worker_free[w], self.now)

    def charge_kv_swap(self, nbytes: float) -> float:
        """A KV-page preemption or resume: the pages cross the main node's
        host link, and decode waits for them, so the transfer serializes
        on the clock.  Returns the charged seconds."""
        dt = self.profile.t_load(nbytes)
        self.now += dt
        return dt

    def step(self, rec) -> tuple:
        """Advance through one decode iteration of ``rec`` (an engine
        ``TokenRecord``); return ``(duration, io_stall)``."""
        profile, sched = self.profile, self.sched
        iter_start = t = self.now
        stall = 0.0
        # a speculative verify wave of ``spec_len`` positions rides one
        # iteration: weight streaming is row-invariant, so its marginal cost
        # is the wider activation payload on every hop
        spec = rec.spec_len
        emb_extra = (spec - 1) * self.emb / profile.lan_bps
        # shadow late departure (Fig. 5): the alignment payload must land
        delay = 0.0
        if self.predictor == "sep":
            if rec.aligned_kv:
                delay += profile.t_lan(self.align_payload)
            if rec.aligned_token:
                delay += profile.t_lan(4)
        shadow_start = iter_start + delay
        # the shadow drafts the wave by rolling itself forward: the last
        # position's predictions, which the wave's loads wait for, come
        # ``spec - 1`` whole shadow passes later
        draft_delay = ((spec - 1) * len(self.kinds) * self.t_shadow_layer
                       if self.predictor == "sep" else 0.0)

        def pred_avail(layer_idx: int, main_now: float) -> float:
            if self.predictor == "sep":
                # the shadow must itself pass layer ``layer_idx``, then notify
                return (shadow_start + draft_delay + (layer_idx + 1) * self.t_shadow_layer
                        + profile.lan_latency_ms * 1e-3)
            # gate extrapolation: the prediction emerges from the main
            # model's own previous layer, i.e. now
            return main_now

        worker_free = self.worker_free
        layer_rec = {lr.layer: lr for lr in rec.layers}
        moe_i = -1
        for li, (mixer, ff) in enumerate(self.kinds):
            # t_main_attn holds two one-token activation hops; a wave widens both
            t += (self.t_main_attn + 2 * emb_extra) if mixer == ATTN else self.t_main_mamba
            if ff == DENSE_FF:
                t += self.t_main_dense_ff
                continue
            if ff != MOE_FF:
                continue
            moe_i += 1
            lr = layer_rec.get(li)
            t += self.t_router                 # the gate runs on the main node
            workers = sched.active_workers_of_group(moe_i)
            targets = sched.load_targets(moe_i)
            if not targets:                    # the whole fleet is dead
                raise RuntimeError("no alive workers in the fleet")
            # hosted experts crossed no link: never priced as loads below
            hosted = set(lr.hosted) if lr is not None else set()
            load_done = 0.0
            if (lr is not None and lr.predicted is not None
                    and lr.shipped is not None):
                # residency-aware records list exactly the predicted experts
                # that shipped (re-hits excluded): price those and only those,
                # with no group padding (a fully re-hit layer loads nothing)
                for j, e in enumerate(lr.shipped):
                    w = targets[j % len(targets)]
                    ls = max(pred_avail(li, t - self.t_router), worker_free[w])
                    worker_free[w] = ls + self.t_load_for(w, self._bytes_for(li, int(e)))
                    load_done = max(load_done, worker_free[w])
            elif lr is not None and lr.predicted is not None:
                # predicted loads, issued once the prediction and the worker
                # allow, each priced by its expert's packed bytes (padding
                # loads beyond the known experts at the default scheme)
                pred_u = list(dict.fromkeys(int(e) for e in lr.predicted.reshape(-1)))
                n_loads = max(len(workers), min(len(pred_u), len(targets)))
                for j in range(n_loads):
                    w = targets[j % len(targets)]
                    e = pred_u[j] if j < len(pred_u) else None
                    ls = max(pred_avail(li, t - self.t_router), worker_free[w])
                    worker_free[w] = ls + self.t_load_for(w, self._bytes_for(li, e))
                    load_done = max(load_done, worker_free[w])
            else:
                # no prediction: load after the gate result
                true_u = ([int(e) for e in dict.fromkeys(lr.true.reshape(-1).tolist())
                           if int(e) not in hosted]
                          if lr is not None else [])
                if hosted:
                    # the record is exact: only the rest shipped, no padding
                    n_loads = min(len(true_u), len(targets))
                else:
                    n_loads = max(len(workers),
                                  min(len(true_u) or len(workers), len(targets)))
                for j in range(n_loads):
                    w = targets[j % len(targets)]
                    e = true_u[j] if j < len(true_u) else None
                    ls = max(t, worker_free[w])
                    worker_free[w] = ls + self.t_load_for(w, self._bytes_for(li, e))
                    load_done = max(load_done, worker_free[w])
            # mispredictions (and the predictions a fault stranded) reload
            # after the gate result, round-robin over the engine's fleet
            # order, missed experts first
            if lr is not None and lr.predicted is not None and lr.reloads:
                pred_set = {int(e) for e in lr.predicted.reshape(-1)}
                true_set = [int(e) for e in dict.fromkeys(lr.true.reshape(-1).tolist())
                            if int(e) not in hosted]
                pool = ([e for e in true_set if e not in pred_set]
                        + [e for e in true_set if e in pred_set])
                for i in range(lr.reloads):
                    w = targets[i % len(targets)]
                    e = pool[i] if i < len(pool) else None
                    ls = max(t, worker_free[w])
                    worker_free[w] = ls + self.t_load_for(w, self._bytes_for(li, e))
                    load_done = max(load_done, worker_free[w])
            # hosted experts stream from host memory and compute serially on
            # the main node after the gate
            t += len(hosted) * self.t_exp_host
            ready = t + profile.t_lan(spec * self.emb)   # the wave's embeddings, one message
            ec_start = max(ready, load_done)
            stall += max(0.0, ec_start - ready)
            t = ec_start + self.t_worker + emb_extra
            for w in workers:
                worker_free[w] = max(worker_free[w], t)
        t += self.t_head
        self.now = t
        return t - iter_start, stall


def simulate_odmoe(cfg: ModelConfig, trace, sched: GroupSchedule, profile: HardwareProfile,
                   shadow_scheme: str = "int8", predictor: str = "sep", faults=None,
                   transport=None, packed_compute: bool = False) -> ODMoETimings:
    """Replay an engine trace through the Fig. 2 pipeline (``DecodeClock``).
    ``faults`` (a ``repro_torch.fleet.FaultInjector`` over a
    ``FleetSchedule``) fires each record's due events before its step, so
    kills and throttles slow the replayed clock.  The replay starts from
    scratch: the injector and the schedule's fleet state are reset first,
    so the engine run that consumed the same script replays directly, and
    the state is reset again afterwards.  ``transport`` prices every load
    by its packed bytes; ``packed_compute`` also prices worker compute at
    the packed stream."""
    clock = DecodeClock(cfg, sched, profile, shadow_scheme, predictor,
                        transport=transport, packed_compute=packed_compute)
    if faults is not None:
        faults.reset()
        sched.state.reset()
    per_token, stalls, alive = [], [], []
    try:
        for rec in trace.records:
            if faults is not None:
                faults.apply_step_all(rec.index, sched.state)
            d, s = clock.step(rec)
            per_token.append(d)
            stalls.append(s)
            alive.append(clock.alive_workers())
    finally:
        if faults is not None:
            sched.state.reset()     # leak no end state into later replays
    return ODMoETimings(per_token, stalls, alive)


def simulate_cached(cfg: ModelConfig, profile: HardwareProfile) -> float:
    """Fully GPU-cached single-server deployment -> tokens/s."""
    return 1.0 / profile.t_stream(cfg.active_param_count() * profile.weight_bytes)


def simulate_cpu(cfg: ModelConfig, profile: HardwareProfile) -> float:
    """llama.cpp-style CPU inference (DRAM-streaming bound) -> tokens/s."""
    active = cfg.active_param_count() * profile.weight_bytes
    return 1.0 / (active / (profile.cpu_mem_gbps * 1e9))


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.od: "OrderedDict" = OrderedDict()

    def access(self, key) -> bool:
        hit = key in self.od
        if hit:
            self.od.move_to_end(key)
        else:
            if len(self.od) >= self.capacity:
                self.od.popitem(last=False)
            self.od[key] = True
        return hit


class _LFU:
    """Least-frequently-used; the victim is ``min`` over a ``set`` of
    (layer, expert) keys, as in the reference, so ties fall alike."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.counts: Dict = defaultdict(int)
        self.resident: set = set()

    def access(self, key) -> bool:
        self.counts[key] += 1
        hit = key in self.resident
        if not hit:
            if len(self.resident) >= self.capacity:
                victim = min(self.resident, key=lambda k: self.counts[k])
                self.resident.discard(victim)
            self.resident.add(key)
        return hit


def simulate_offload_cache(cfg: ModelConfig, trace: Trace, profile: HardwareProfile, *,
                           policy: str = "lru", cache_experts: int = 0,
                           quant_factor: float = 1.0) -> Dict[str, float]:
    """Single-node expert-offloading baseline (Mixtral-Offloading / HOBBIT
    / MoE-Infinity family) replayed on the SAME routing trace.

    ``cache_experts`` is the device expert cache's capacity in experts;
    ``quant_factor`` scales expert bytes (HOBBIT/AdapMoE quantization).
    Misses load serially over one host link."""
    lb = layer_bytes(cfg, profile.weight_bytes)
    cache = (_LRU if policy == "lru" else _LFU)(max(cache_experts, 1))
    t_attn = profile.t_stream(lb["attn"])
    t_dense = profile.t_stream(lb["dense_ff"])
    t_mamba = profile.t_stream(lb["mamba"])
    t_exp = profile.t_stream(lb["expert"] * quant_factor)
    t_load = profile.t_load(lb["expert"] * quant_factor)
    t_head = profile.t_stream(lb["embed"])
    hits = misses = 0
    per_token = []
    for rec in trace.records:
        t = 0.0
        layer_rec = {lr.layer: lr for lr in rec.layers}
        for li, (mixer, ff) in enumerate(cfg.layer_kinds()):
            t += t_attn if mixer == ATTN else t_mamba
            if ff == DENSE_FF:
                t += t_dense
            if ff != MOE_FF:
                continue
            lr = layer_rec.get(li)
            experts = [int(e) for e in lr.true.reshape(-1)] if lr is not None else []
            for e in set(experts):
                if cache.access((li, e)):
                    hits += 1
                else:
                    misses += 1
                    t += t_load
                t += t_exp
        t += t_head
        per_token.append(t)
    total = hits + misses
    return {"tokens_per_s": 1.0 / float(np.mean(per_token)),
            "cache_hit_rate": hits / total if total else 0.0}


def simulate_prefill_odmoe(cfg: ModelConfig, profile: HardwareProfile, prompt_len: int,
                           n_workers: int = 8, n_minibatches: int = 4) -> float:
    """TTFT under §3.3, in seconds: per layer all experts load in parallel
    across the workers, and batched embeddings ship in mini-batches so
    transfer pipelines with compute (Fig. 7b)."""
    wb = profile.weight_bytes
    lb = layer_bytes(cfg, wb)
    emb_batch = embedding_payload(cfg, wb) * prompt_len
    t = profile.t_stream(lb["embed"])
    for mixer, ff in cfg.layer_kinds():
        t += profile.t_stream(lb["attn"] if mixer == ATTN else lb["mamba"])
        if ff == DENSE_FF:
            t += profile.t_stream(lb["dense_ff"])
        if ff != MOE_FF:
            continue
        experts_per_worker = max(1, cfg.num_experts // n_workers)
        t_load = profile.t_load(lb["expert"]) * experts_per_worker
        mb = emb_batch / n_minibatches
        t_mb_comm = profile.t_lan(mb)
        t_mb_comp = profile.t_stream(lb["expert"]) / n_minibatches
        # Fig. 7b: first mini-batch transfer, then overlap
        t_pipeline = (t_mb_comm + max(t_mb_comm, t_mb_comp) * (n_minibatches - 1)
                      + t_mb_comp)
        t += max(t_load, t_pipeline)
    return t


def simulate_prefill_cached(cfg: ModelConfig, profile: HardwareProfile,
                            prompt_len: int) -> float:
    """Fully-cached prefill: the weights stream once, compute amortized
    over the batch."""
    active = cfg.active_param_count() * profile.weight_bytes
    return profile.t_stream(active) * (1 + prompt_len / 2048)


# ---------------------------------------------------------------- serving
def poisson_arrivals(rate: float, n: int, seed: int = 0) -> List[float]:
    """Arrival times (seconds) of ``n`` requests from a Poisson process at
    ``rate`` req/s (numpy's generator, so the times equal the reference's
    for a seed); ``rate <= 0`` puts everything at t=0."""
    if rate <= 0:
        return [0.0] * n
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n)).tolist()


def latency_percentiles(xs: List[float], prefix: str) -> Dict[str, float]:
    """mean/p50/p95/p99 of a latency sample; an empty sample reports 0.0
    everywhere."""
    if not xs:
        return {f"{prefix}_{k}_s": 0.0 for k in ("mean", "p50", "p95", "p99")}
    p50, p95, p99 = np.percentile(xs, (50, 95, 99))
    return {f"{prefix}_mean_s": float(np.mean(xs)), f"{prefix}_p50_s": float(p50),
            f"{prefix}_p95_s": float(p95), f"{prefix}_p99_s": float(p99)}


@dataclass
class ServingTimings:
    """Per-request latency and aggregate throughput of a serving run, in
    the clock's modelled seconds.  Lists are positional, in ascending
    request-id order.  TTFT covers admission wait and prefill (the first
    token falls out of prefill); TPOT is the mean gap over the remaining
    tokens.  ``tenants`` and the SLO lists (optional, same order) feed
    ``per_tenant_report``.  Every report field is finite."""
    arrival_s: List[float]
    first_token_s: List[float]
    finish_s: List[float]
    tokens: List[int]
    tenants: Optional[List[str]] = None
    ttft_slo_s: Optional[List[float]] = None
    tpot_slo_s: Optional[List[float]] = None

    @property
    def ttft_s(self) -> List[float]:
        return [f - a for f, a in zip(self.first_token_s, self.arrival_s)]

    @property
    def tpot_s(self) -> List[float]:
        return [(fin - ft) / (n - 1) if n > 1 else 0.0
                for fin, ft, n in zip(self.finish_s, self.first_token_s, self.tokens)]

    @property
    def makespan_s(self) -> float:
        if not self.finish_s:
            return 0.0
        return max(self.finish_s) - min(self.arrival_s)

    @property
    def tokens_per_s(self) -> float:
        span = self.makespan_s
        return sum(self.tokens) / span if span > 0 else 0.0

    def _subset(self, idx: List[int]) -> "ServingTimings":
        def pick(xs):
            return [xs[i] for i in idx] if xs is not None else None

        return ServingTimings(arrival_s=pick(self.arrival_s),
                              first_token_s=pick(self.first_token_s),
                              finish_s=pick(self.finish_s), tokens=pick(self.tokens),
                              tenants=pick(self.tenants), ttft_slo_s=pick(self.ttft_slo_s),
                              tpot_slo_s=pick(self.tpot_slo_s))

    @staticmethod
    def _attainment(xs: List[float], slos: Optional[List[float]]) -> float:
        """Share of requests meeting their SLO (no target counts as met;
        an empty sample is 1.0)."""
        if not xs or slos is None:
            return 1.0
        return float(np.mean([x <= s for x, s in zip(xs, slos)]))

    def report(self) -> Dict[str, float]:
        ttft, tpot = self.ttft_s, self.tpot_s
        rep = {"n_requests": len(self.tokens), "total_tokens": int(sum(self.tokens)),
               "makespan_s": self.makespan_s, "throughput_tok_s": self.tokens_per_s}
        rep.update(latency_percentiles(ttft, "ttft"))
        rep.update(latency_percentiles(tpot, "tpot"))
        if self.ttft_slo_s is not None or self.tpot_slo_s is not None:
            rep["ttft_slo_attainment"] = self._attainment(ttft, self.ttft_slo_s)
            rep["tpot_slo_attainment"] = self._attainment(tpot, self.tpot_slo_s)
        return rep

    def per_tenant_report(self) -> Dict[str, Dict[str, float]]:
        """``report()`` by tenant class; without labels one ``"default"``
        class."""
        tenants = self.tenants or ["default"] * len(self.tokens)
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(set(tenants)) or ["default"]:
            out[name] = self._subset([i for i, t in enumerate(tenants)
                                      if t == name]).report()
        return out


def node_memory_report(engine, kv_pool=None, budget_bytes: Optional[int] = None) -> Dict:
    """Per-node device bytes under the OD-MoE budget: the expert slots of
    the fleet's largest worker, the transient packed buffer live while a
    shard dequantizes on arrival, and the paged KV pool (zero when serving
    runs dense).  ``budget_bytes`` adds a pass/fail against a budget."""
    slots = engine.slots
    slot_bytes = slots.slot_unit_bytes() * max(slots.capacity)
    transient = slots.transient_packed_bytes()
    kv_bytes = kv_pool.pool_bytes() if kv_pool is not None else 0
    rep = {"expert_slot_bytes": slot_bytes, "transient_packed_bytes": transient,
           "kv_page_bytes": kv_bytes,
           "kv_pages": kv_pool.num_pages if kv_pool is not None else 0,
           "total_bytes": slot_bytes + transient + kv_bytes}
    if budget_bytes is not None:
        rep["budget_bytes"] = int(budget_bytes)
        rep["within_budget"] = rep["total_bytes"] <= budget_bytes
    return rep


# ------------------------------------------------------------ synthetic trace
def synthetic_trace(cfg: ModelConfig, n_tokens: int, recall: float, batch: int = 1,
                    seed: int = 0, with_predictions: bool = True,
                    sticky: float = 0.55) -> Trace:
    """A routing trace for a full-size config that no host run decodes,
    at a target prediction recall.  Expert popularity is Zipf-ish, each
    layer's selection is kept from the previous token with probability
    ``sticky`` (what gives the LRU/LFU baselines their hits), and
    mispredictions are i.i.d. at rate 1 - recall.  Draws the reference's
    ``np.random.default_rng(seed)`` numbers in the reference's order, so
    both packages give the same trace."""
    rng = np.random.default_rng(seed)
    moe_layers = [i for i, (_, ff) in enumerate(cfg.layer_kinds()) if ff == MOE_FF]
    e, k = cfg.num_experts, cfg.top_k
    pop = 1.0 / np.arange(1, e + 1) ** 0.5
    pop /= pop.sum()
    prev: Dict[int, np.ndarray] = {}
    trace = Trace()
    for n in range(1, n_tokens + 1):
        rec = TokenRecord(index=n, aligned_token=True, aligned_kv=True)
        for mi, li in enumerate(moe_layers):
            perm = rng.permutation(e)
            true = np.stack([rng.choice(e, size=k, replace=False, p=pop)
                             for _ in range(batch)])
            if li in prev and sticky > 0:
                keep = rng.random(true.shape) < sticky
                true = np.where(keep, prev[li], true)
            prev[li] = true
            if with_predictions:
                pred = true.copy()
                wrong = rng.random(true.shape) > recall
                pred[wrong] = perm[pred[wrong]]          # derangement-ish
                correct = sum(len(set(map(int, pred[b])) & set(map(int, true[b])))
                              for b in range(batch))
                reloads = len({int(x) for x in true.reshape(-1)}
                              - {int(x) for x in pred.reshape(-1)})
            else:
                pred, correct = None, 0
                reloads = len({int(x) for x in true.reshape(-1)})
            rec.layers.append(LayerRecord(
                layer=li, moe_index=mi, group=0, predicted=pred, true=true,
                correct=correct, reloads=reloads,
                assignments=[(int(x), 0) for x in dict.fromkeys(true.reshape(-1).tolist())]))
        trace.records.append(rec)
    return trace
