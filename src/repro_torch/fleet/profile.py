"""Per-worker capability profiles and the mutable fleet liveness state
(``repro.fleet.profile``).

The paper's testbed is ten identical workers that never fail; an edge
fleet is neither.  A ``WorkerProfile`` gives one worker's expert-loading
link bandwidth and how many expert slots its memory holds.
``FleetState`` is the runtime side, which workers are alive and how far
each link is throttled, shared by reference between the schedule, the
engine's slots and the timing clock, so one fault is seen everywhere.
Plain Python.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# Link speed of a profile that pins none: ``RTX3090_EDGE.pcie_gbps``, so a
# default fleet times like the paper's homogeneous testbed.
DEFAULT_LINK_GBPS = 24.0


@dataclass(frozen=True)
class WorkerProfile:
    """Static capabilities of one worker.  ``link_gbps`` is its
    expert-loading bandwidth in GB/s (``None``: the hardware profile's
    PCIe rate when timing, ``DEFAULT_LINK_GBPS`` when ordering); the link
    prices whatever payload crosses it (``FleetSchedule.t_load_s``).
    ``capacity`` is the number of device expert slots (>= 1)."""
    worker: int
    link_gbps: Optional[float] = None
    capacity: int = 1

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError("worker index must be >= 0")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.link_gbps is not None and self.link_gbps <= 0:
            raise ValueError("link_gbps must be positive")

    def link_or_default(self, default_gbps: float = DEFAULT_LINK_GBPS) -> float:
        return self.link_gbps if self.link_gbps is not None else default_gbps


def uniform_profiles(n_workers: int, link_gbps: Optional[float] = None,
                     capacity: int = 1) -> Tuple[WorkerProfile, ...]:
    """The paper's homogeneous fleet as explicit profiles."""
    return tuple(WorkerProfile(w, link_gbps, capacity) for w in range(n_workers))


@dataclass
class FleetState:
    """Liveness and throttle state shared by schedule, slots and clock.
    ``link_scale[w]`` multiplies worker ``w``'s link bandwidth (1.0 =
    nominal; a throttle fault lowers it)."""
    alive: List[bool]
    link_scale: List[float]

    @classmethod
    def fresh(cls, n_workers: int) -> "FleetState":
        return cls([True] * n_workers, [1.0] * n_workers)

    def reset(self) -> None:
        """Back to all alive and unthrottled (trace replays start here)."""
        self.alive = [True] * len(self.alive)
        self.link_scale = [1.0] * len(self.link_scale)

    @property
    def n_alive(self) -> int:
        return sum(self.alive)

    def kill(self, worker: int) -> None:
        self.alive[worker] = False

    def recover(self, worker: int) -> None:
        self.alive[worker] = True

    def throttle(self, worker: int, factor: float) -> None:
        if factor <= 0:
            raise ValueError("throttle factor must be positive")
        self.link_scale[worker] = factor
