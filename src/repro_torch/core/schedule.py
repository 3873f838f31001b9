"""Worker grouping + round-robin scheduling (paper §3.1, Fig. 2).

Workers are split into ``n_workers / group_size`` groups.  MoE layer
``l`` (the i-th MoE layer in execution order) is served by group
``i mod n_groups``; inside a group the top-k routed experts map one to
one onto the group's workers.  Plain Python, copied from
``repro.core.schedule`` (the fleet-aware schedule waits).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


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

    def spill_workers(self, moe_index: int) -> List[int]:
        """Overflow order when a layer needs more experts than its group
        holds: the other groups' workers, nearest group first."""
        group = self.group_of(moe_index)
        order: List[int] = []
        for step in range(1, self.n_groups):
            order.extend(self.workers_of_group((group + step) % self.n_groups))
        return order

    def serving_order(self, moe_index: int) -> List[int]:
        """Worker preference order for this layer: home group, then spill."""
        return (self.workers_of_group(self.group_of(moe_index))
                + self.spill_workers(moe_index))

    def place(self, moe_index: int, experts: Sequence[int]) -> List[Tuple[int, int]]:
        """Map predicted experts onto workers in ``serving_order``; any
        overflow is dropped (the reload path picks it up)."""
        return list(zip(experts, self.serving_order(moe_index)))
