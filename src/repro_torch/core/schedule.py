"""Worker grouping + round-robin scheduling (paper §3.1, Fig. 2).

Workers are split into ``n_workers / group_size`` groups.  MoE layer
``l`` (the i-th MoE layer in execution order) is served by group
``i mod n_groups``; inside a group the top-k routed experts map one to
one onto the group's workers.  ``t_maxload`` is Eq. (1): the longest an
expert load may take without stalling compute.  Plain Python, copied
from ``repro.core.schedule``; ``repro_torch.fleet.FleetSchedule`` extends
it to dead workers, link speeds and slot capacities.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class GroupSchedule:
    n_workers: int
    group_size: int

    def __post_init__(self):
        if self.n_workers % self.group_size:
            raise ValueError("n_workers must be divisible by group_size")

    @property
    def n_groups(self) -> int:
        return self.n_workers // self.group_size

    def group_of(self, moe_index: int) -> int:
        """Group serving the ``moe_index``-th MoE layer (round-robin)."""
        return moe_index % self.n_groups

    def workers_of_group(self, group: int) -> List[int]:
        base = group * self.group_size
        return list(range(base, base + self.group_size))

    def assign(self, moe_index: int, experts: Sequence[int]) -> List[Tuple[int, int]]:
        """One-to-one (expert, worker) mapping onto this layer's group."""
        workers = self.workers_of_group(self.group_of(moe_index))
        return [(e, workers[j % len(workers)]) for j, e in enumerate(experts)]

    def spill_workers(self, moe_index: int) -> List[int]:
        """Overflow order when a layer needs more experts than its group
        holds: the other groups' workers, nearest group first."""
        group = self.group_of(moe_index)
        order: List[int] = []
        for step in range(1, self.n_groups):
            order.extend(self.workers_of_group((group + step) % self.n_groups))
        return order

    def active_workers_of_group(self, moe_index: int) -> List[int]:
        """Workers of the layer's home group able to serve (all of them:
        every worker is alive with one slot)."""
        return self.workers_of_group(self.group_of(moe_index))

    def serving_order(self, moe_index: int) -> List[int]:
        """Worker preference order for this layer: home group, then spill."""
        return (self.workers_of_group(self.group_of(moe_index))
                + self.spill_workers(moe_index))

    def load_targets(self, moe_index: int) -> List[int]:
        """Slot preference order for predicted loads (one slot per worker,
        so ``serving_order``)."""
        return self.serving_order(moe_index)

    def place(self, moe_index: int, experts: Sequence[int],
              reserved: Optional[Dict[int, int]] = None) -> List[Tuple[int, int]]:
        """Map predicted experts onto workers in ``load_targets``, skipping
        ``reserved`` slots (worker -> slots already taken, e.g. residency
        re-hits); any overflow is dropped (the reload path picks it up)."""
        budget = dict(reserved) if reserved else {}
        targets: List[int] = []
        for w in self.load_targets(moe_index):
            if budget.get(w, 0) > 0:
                budget[w] -= 1
                continue
            targets.append(w)
        return list(zip(experts, targets))

    def t_maxload(self, t_main: float, t_worker: float) -> float:
        """Eq. (1): while a group computes layer l, the other ``G - 1``
        groups load, so a group has ``G·t^M + (G−1)·t^W`` (G = n_groups)
        for its next load."""
        g = self.n_groups
        return g * t_main + (g - 1) * t_worker

    def io_bottlenecked(self, t_load: float, t_main: float, t_worker: float) -> bool:
        """Paper §3.1 closing check: is the system I/O-bound?"""
        return t_load > self.t_maxload(t_main, t_worker)
