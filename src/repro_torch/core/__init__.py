"""The paper's system: SEP prediction, alignment, the cacheless
on-demand expert loading engine, worker-group scheduling, the expert
store and worker slots.  The timing model waits (ROADMAP.md queue 1)."""
from .align import AlignmentPolicy
from .engine import LayerRecord, ODMoEEngine, TokenRecord, Trace
from .predictor import (FrequencyPredictor, GateExtrapolator, RandomPredictor,
                        SEPShadow, moe_layer_indices, recall_counts,
                        topk_to_layer_dict)
from .schedule import GroupSchedule
from .store import ExpertStore, LoadEvent, WorkerSlots

__all__ = [
    "AlignmentPolicy", "LayerRecord", "ODMoEEngine",
    "TokenRecord", "Trace", "FrequencyPredictor", "GateExtrapolator",
    "RandomPredictor", "SEPShadow", "moe_layer_indices", "recall_counts",
    "topk_to_layer_dict", "GroupSchedule", "ExpertStore", "LoadEvent",
    "WorkerSlots",
]
