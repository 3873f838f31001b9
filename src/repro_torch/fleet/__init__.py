"""Heterogeneous, fault-tolerant worker fleet (``repro.fleet``):
per-worker capability profiles, scripted fault injection (kill, recover,
throttle at chosen decode steps), a liveness- and link-aware extension
of the paper's group schedule, and gate-statistics expert placement
(``placement``), which the cluster router's replicas share
(``repro_torch.serve.cluster``)."""
from .faults import FaultEvent, FaultInjector, outage, random_fault_script
from .placement import (GateStatsRecorder, PlacementPlan, expected_t_maxload, modulo_plan,
                        optimize_placement, uniform_plan)
from .profile import DEFAULT_LINK_GBPS, FleetState, WorkerProfile, uniform_profiles
from .schedule import FleetSchedule

__all__ = [
    "DEFAULT_LINK_GBPS", "FaultEvent", "FaultInjector", "FleetSchedule",
    "FleetState", "GateStatsRecorder", "PlacementPlan", "WorkerProfile",
    "expected_t_maxload", "modulo_plan", "optimize_placement", "outage",
    "random_fault_script", "uniform_plan", "uniform_profiles",
]
