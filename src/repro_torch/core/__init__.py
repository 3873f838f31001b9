"""The paper's system: SEP prediction, alignment, the cacheless
on-demand expert loading engine, worker-group scheduling, the expert
store and worker slots (full-width or packed-resident), prefill
assignment and the decode timing model."""
from .align import AlignmentPolicy, kv_bytes_per_token, token_bytes
from .engine import LayerRecord, ODMoEEngine, TokenRecord, Trace
from .predictor import (FrequencyPredictor, GateExtrapolator, RandomPredictor,
                        SEPShadow, moe_layer_indices, recall_counts,
                        topk_to_layer_dict)
from .prefill import experts_activated, prefill_expert_assignment, split_minibatches
from .schedule import GroupSchedule
from .store import DeviceShard, ExpertStore, LoadEvent, WorkerSlots
from .timing import (RTX3090_EDGE, DecodeClock, HardwareProfile, ODMoETimings,
                     embedding_payload, layer_bytes, simulate_cached, simulate_odmoe,
                     simulate_prefill_cached, simulate_prefill_odmoe)

__all__ = [
    "AlignmentPolicy", "kv_bytes_per_token", "token_bytes", "LayerRecord",
    "ODMoEEngine", "TokenRecord", "Trace", "FrequencyPredictor", "GateExtrapolator",
    "RandomPredictor", "SEPShadow", "moe_layer_indices", "recall_counts",
    "topk_to_layer_dict", "experts_activated", "prefill_expert_assignment",
    "split_minibatches", "GroupSchedule", "DeviceShard", "ExpertStore", "LoadEvent",
    "WorkerSlots", "RTX3090_EDGE", "DecodeClock", "HardwareProfile", "ODMoETimings",
    "embedding_payload", "layer_bytes", "simulate_cached", "simulate_odmoe",
    "simulate_prefill_cached", "simulate_prefill_odmoe",
]
