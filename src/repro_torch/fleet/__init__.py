"""Heterogeneous, fault-tolerant worker fleet (``repro.fleet`` without
its placement module): per-worker capability profiles, scripted fault
injection (kill, recover, throttle at chosen decode steps) and a
liveness- and link-aware extension of the paper's group schedule.
Gate-statistics placement waits (ROADMAP.md queue 1, "placement and
compute-vs-ship, then serve/cluster.py")."""
from .faults import FaultEvent, FaultInjector, outage, random_fault_script
from .profile import DEFAULT_LINK_GBPS, FleetState, WorkerProfile, uniform_profiles
from .schedule import FleetSchedule

__all__ = [
    "DEFAULT_LINK_GBPS", "FaultEvent", "FaultInjector", "FleetSchedule", "FleetState",
    "WorkerProfile", "outage", "random_fault_script", "uniform_profiles",
]
