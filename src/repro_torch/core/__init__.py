"""The paper's system: SEP prediction, alignment, the cacheless
on-demand expert loading engine (single stream and the request-level API
the serving loop composes), worker-group scheduling, the expert store
and worker slots (full-width or packed-resident), prefill assignment and
the decode and serving timing model (fleet- and fault-aware over a
``repro_torch.fleet.FleetSchedule``, pricing experts that compute-vs-ship
hosts on the main node) with the paper's cached, CPU and offload-cache
baselines, async expert prefetch with opportunistic
residency, and shadow-drafted speculative decoding."""
from .align import AlignmentPolicy, kv_bytes_per_token, token_bytes
from .engine import (LayerRecord, ODMoEEngine, TokenRecord, Trace, concat_cache_lists,
                     slice_cache_list)
from .predictor import (FrequencyPredictor, GateExtrapolator, RandomPredictor,
                        SEPShadow, concat_shadow_states, layers_within_horizon,
                        moe_layer_indices, recall_counts, slice_rollout,
                        slice_shadow_state, topk_to_layer_dict)
from .prefetch import (ChaosExecutor, GateStatsResidency, LRUResidency, PrefetchExecutor,
                       ResidencyPolicy, SyncExecutor, ThreadedExecutor, make_executor,
                       resolve_residency)
from .prefill import experts_activated, prefill_expert_assignment, split_minibatches
from .schedule import GroupSchedule
from .specdecode import accept_prefix, select_commit, spec_attn_decode, wave_preds
from .store import DeviceShard, ExpertStore, FetchedShard, LoadEvent, WorkerSlots
from .timing import (RTX3090_EDGE, DecodeClock, HardwareProfile, ODMoETimings,
                     ServingTimings, degraded_tpot_report, embedding_payload, latency_percentiles,
                     layer_bytes, node_memory_report, poisson_arrivals, simulate_cached,
                     simulate_cpu, simulate_odmoe, simulate_offload_cache,
                     simulate_prefill_cached, simulate_prefill_odmoe, synthetic_trace)

__all__ = [
    "AlignmentPolicy", "kv_bytes_per_token", "token_bytes", "LayerRecord",
    "ODMoEEngine", "TokenRecord", "Trace", "concat_cache_lists", "slice_cache_list",
    "wave_preds", "FrequencyPredictor", "GateExtrapolator", "RandomPredictor", "SEPShadow",
    "concat_shadow_states", "layers_within_horizon", "moe_layer_indices", "recall_counts",
    "slice_rollout", "slice_shadow_state", "topk_to_layer_dict", "ChaosExecutor", "GateStatsResidency",
    "LRUResidency", "PrefetchExecutor", "ResidencyPolicy", "SyncExecutor", "ThreadedExecutor",
    "make_executor", "resolve_residency", "experts_activated", "prefill_expert_assignment",
    "split_minibatches", "GroupSchedule", "accept_prefix", "select_commit",
    "spec_attn_decode", "DeviceShard", "ExpertStore", "FetchedShard", "LoadEvent",
    "WorkerSlots", "RTX3090_EDGE", "DecodeClock", "HardwareProfile", "ODMoETimings",
    "ServingTimings", "degraded_tpot_report", "embedding_payload", "latency_percentiles",
    "layer_bytes", "node_memory_report", "poisson_arrivals", "simulate_cached",
    "simulate_cpu", "simulate_odmoe", "simulate_offload_cache", "simulate_prefill_cached",
    "simulate_prefill_odmoe", "synthetic_trace",
]
