"""Discrete-event timing model of OD-MoE decode on the paper's testbed.

These are modelled times, never measurements: stage durations derive
from the bytes each stage moves at calibrated effective bandwidths,

    t_compute(stage) = stage_param_bytes / eff_hbm_Bps
    t_load(expert)   = expert_bytes      / pcie_Bps
    t_lan(payload)   = payload_bytes     / lan_Bps + lan_latency

and the OD-MoE pipeline (worker grouping, staggered loads, shadow
lookahead, alignment late departure, misprediction reloads) is replayed
event by event from an engine ``Trace``, following Figs. 2/4/5.  The
fully-cached baseline and the prefill models price the same config.
``RTX3090_EDGE`` is the paper's edge testbed.  Counterpart:
``repro.core.timing``; the serving timings, the offload-cache baselines
and the fleet and fault state wait (ROADMAP.md queue 1).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.models.config import ATTN, DENSE_FF, MOE_FF, ModelConfig
from repro_torch.quant.transport import resolve_policy, transport_expert_bytes

from .align import kv_bytes_per_token
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


@dataclass
class ODMoETimings:
    per_token_s: List[float]
    io_stall_s: List[float]

    @property
    def tokens_per_s(self) -> float:
        return 1.0 / float(np.mean(self.per_token_s))


class DecodeClock:
    """Fig. 2 replay, one decode iteration at a time on a continuous
    clock with per-worker timelines.  A worker's next predicted load
    starts as soon as the prediction exists and the worker is free, so
    loads for layer l+G-1 overlap the compute of layer l; mispredicted
    experts reload only after the main node's gate result.

    Loads are priced by each expert's PACKED bytes under ``transport``.
    Worker compute streams full-width weights (dequantize on arrival),
    or with ``packed_compute`` the packed ones (packed-resident slots and
    the in-register-dequant kernel)."""

    def __init__(self, cfg: ModelConfig, sched: GroupSchedule, profile: HardwareProfile,
                 shadow_scheme: str = "int8", predictor: str = "sep", transport=None,
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
        # the shadow runs the whole (quantized) model on its own node
        qf = {"fp16": 0.5, "int8": 0.25, "nf4": 0.125}.get(shadow_scheme, 1.0)
        shadow_active = cfg.active_param_count() * wb * qf
        self.t_shadow_layer = profile.t_stream(shadow_active / cfg.num_layers)
        self.align_payload = kv_bytes_per_token(cfg, wb)
        self.worker_free: Dict[int, float] = defaultdict(float)
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

    def step(self, rec) -> tuple:
        """Advance through one decode iteration of ``rec`` (an engine
        ``TokenRecord``); return ``(duration, io_stall)``."""
        profile, sched = self.profile, self.sched
        iter_start = t = self.now
        stall = 0.0
        # shadow late departure (Fig. 5): the alignment payload must land
        delay = 0.0
        if self.predictor == "sep":
            if rec.aligned_kv:
                delay += profile.t_lan(self.align_payload)
            if rec.aligned_token:
                delay += profile.t_lan(4)
        shadow_start = iter_start + delay

        def pred_avail(layer_idx: int, main_now: float) -> float:
            if self.predictor == "sep":
                # the shadow must itself pass layer ``layer_idx``, then notify
                return (shadow_start + (layer_idx + 1) * self.t_shadow_layer
                        + profile.lan_latency_ms * 1e-3)
            # gate extrapolation: the prediction emerges from the main
            # model's own previous layer, i.e. now
            return main_now

        worker_free = self.worker_free
        layer_rec = {lr.layer: lr for lr in rec.layers}
        moe_i = -1
        for li, (mixer, ff) in enumerate(self.kinds):
            t += self.t_main_attn if mixer == ATTN else self.t_main_mamba
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
            load_done = 0.0
            if lr is not None and lr.predicted is not None:
                # predicted loads, issued once the prediction and the worker
                # allow, each priced by its expert's packed bytes (padding
                # loads beyond the known experts at the default scheme)
                pred_u = list(dict.fromkeys(int(e) for e in lr.predicted.reshape(-1)))
                n_loads = max(len(workers), min(len(pred_u), len(targets)))
                for j in range(n_loads):
                    w = targets[j % len(targets)]
                    e = pred_u[j] if j < len(pred_u) else None
                    ls = max(pred_avail(li, t - self.t_router), worker_free[w])
                    worker_free[w] = ls + profile.t_load(self._bytes_for(li, e))
                    load_done = max(load_done, worker_free[w])
            else:
                # no prediction: load after the gate result
                true_u = ([int(e) for e in dict.fromkeys(lr.true.reshape(-1).tolist())]
                          if lr is not None else [])
                n_loads = max(len(workers), min(len(true_u) or len(workers), len(targets)))
                for j in range(n_loads):
                    w = targets[j % len(targets)]
                    e = true_u[j] if j < len(true_u) else None
                    ls = max(t, worker_free[w])
                    worker_free[w] = ls + profile.t_load(self._bytes_for(li, e))
                    load_done = max(load_done, worker_free[w])
            # mispredictions reload after the gate result, round-robin over
            # the engine's fleet order, missed experts first
            if lr is not None and lr.predicted is not None and lr.reloads:
                pred_set = {int(e) for e in lr.predicted.reshape(-1)}
                true_set = [int(e) for e in dict.fromkeys(lr.true.reshape(-1).tolist())]
                pool = ([e for e in true_set if e not in pred_set]
                        + [e for e in true_set if e in pred_set])
                for i in range(lr.reloads):
                    w = targets[i % len(targets)]
                    e = pool[i] if i < len(pool) else None
                    ls = max(t, worker_free[w])
                    worker_free[w] = ls + profile.t_load(self._bytes_for(li, e))
                    load_done = max(load_done, worker_free[w])
            ready = t + profile.t_lan(self.emb)   # the embedding reaches the workers
            ec_start = max(ready, load_done)
            stall += max(0.0, ec_start - ready)
            t = ec_start + self.t_worker
            for w in workers:
                worker_free[w] = max(worker_free[w], t)
        t += self.t_head
        self.now = t
        return t - iter_start, stall


def simulate_odmoe(cfg: ModelConfig, trace, sched: GroupSchedule, profile: HardwareProfile,
                   shadow_scheme: str = "int8", predictor: str = "sep", transport=None,
                   packed_compute: bool = False) -> ODMoETimings:
    """Replay an engine trace through the Fig. 2 pipeline (``DecodeClock``).
    ``transport`` prices every load by its packed bytes; ``packed_compute``
    also prices worker compute at the packed stream."""
    clock = DecodeClock(cfg, sched, profile, shadow_scheme, predictor,
                        transport=transport, packed_compute=packed_compute)
    per_token, stalls = [], []
    for rec in trace.records:
        d, s = clock.step(rec)
        per_token.append(d)
        stalls.append(s)
    return ODMoETimings(per_token, stalls)


def simulate_cached(cfg: ModelConfig, profile: HardwareProfile) -> float:
    """Fully GPU-cached single-server deployment -> tokens/s."""
    return 1.0 / profile.t_stream(cfg.active_param_count() * profile.weight_bytes)


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
