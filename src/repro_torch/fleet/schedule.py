"""Liveness- and link-aware worker scheduling over heterogeneous fleets
(``repro.fleet.schedule``).

``FleetSchedule`` keeps ``GroupSchedule``'s groups (paper §3.1: the i-th
MoE layer is served by group ``i mod G``) and its Eq. (1) ``t_maxload``,
and makes every ordering decision fleet-aware:

  * dead workers are skipped everywhere (assignment, spill, serving
    order), which is what lets decode survive the loss of a node;
  * within a group, faster links come first, stable on ties, so a
    uniform all-alive fleet orders exactly like ``GroupSchedule``;
  * ``load_targets`` expands the serving order by slot capacity,
    breadth-first, so multi-slot workers absorb extra predicted experts
    before the schedule spills further;
  * a ``plan=`` (``repro_torch.fleet.placement.PlacementPlan``) replaces
    the ``i mod G`` rotation with gate-statistics placement: worker orders
    come from the plan (dead workers dropped at query time) and
    ``place``/``assign`` honour its expert -> worker affinity; a uniform
    plan orders exactly like the rotation;
  * Eq. (1) holds per worker: the ``t_maxload`` budget belongs to the
    group, but whether a link meets it is per link
    (``io_bottlenecked_worker``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule import GroupSchedule

from .profile import DEFAULT_LINK_GBPS, FleetState, WorkerProfile, uniform_profiles


@dataclass(frozen=True)
class FleetSchedule(GroupSchedule):
    profiles: Tuple[WorkerProfile, ...] = ()
    state: Optional[FleetState] = field(default=None, compare=False, repr=False)
    # a placement.PlacementPlan (untyped: placement imports this module)
    plan: Optional[object] = field(default=None, repr=False)

    def __post_init__(self):
        GroupSchedule.__post_init__(self)
        if not self.profiles:
            object.__setattr__(self, "profiles", uniform_profiles(self.n_workers))
        if len(self.profiles) != self.n_workers:
            raise ValueError("one profile per worker required")
        if [p.worker for p in self.profiles] != list(range(self.n_workers)):
            raise ValueError("profiles must be ordered by worker index")
        if self.state is None:
            object.__setattr__(self, "state", FleetState.fresh(self.n_workers))
        if self.plan is not None and self.plan.n_workers != self.n_workers:
            raise ValueError("plan sized for a different fleet")

    # ---------------------------------------------------------- liveness
    def alive(self, worker: int) -> bool:
        return self.state.alive[worker]

    def link_gbps_of(self, worker: int, default_gbps: float = DEFAULT_LINK_GBPS) -> float:
        """Effective link bandwidth: the profile's (or the default) times
        the throttle."""
        return self.profiles[worker].link_or_default(default_gbps) * self.state.link_scale[worker]

    def _fast_first(self, workers: Sequence[int]) -> List[int]:
        # stable: equal-speed workers keep index order, so a uniform
        # all-alive fleet orders exactly like GroupSchedule
        return sorted(workers, key=lambda w: -self.link_gbps_of(w))

    # ---------------------------------------------------------- ordering
    def _plan_alive(self, moe_index: int) -> List[int]:
        """The plan's worker order for this layer, dead workers dropped."""
        return [w for w in self.plan.order_for(moe_index) if self.alive(w)]

    def active_workers_of_group(self, moe_index: int) -> List[int]:
        if self.plan is not None:
            home = self.plan.order_for(moe_index)[:self.group_size]
            return [w for w in home if self.alive(w)]
        group = self.group_of(moe_index)
        return self._fast_first(w for w in self.workers_of_group(group) if self.alive(w))

    def spill_workers(self, moe_index: int) -> List[int]:
        """Overflow order: the other groups' alive workers, nearest group
        first, fast links first within each group (with a plan: the plan's
        order beyond the layer's home workers)."""
        if self.plan is not None:
            rest = self.plan.order_for(moe_index)[self.group_size:]
            return [w for w in rest if self.alive(w)]
        group = self.group_of(moe_index)
        order: List[int] = []
        for step in range(1, self.n_groups):
            order.extend(self._fast_first(
                w for w in self.workers_of_group((group + step) % self.n_groups)
                if self.alive(w)))
        return order

    def serving_order(self, moe_index: int) -> List[int]:
        return self.active_workers_of_group(moe_index) + self.spill_workers(moe_index)

    def load_targets(self, moe_index: int) -> List[int]:
        """Serving order expanded by slot capacity, breadth-first: every
        alive worker takes one expert before any takes a second."""
        order = self.serving_order(moe_index)
        out: List[int] = []
        depth = 0
        while True:
            round_ws = [w for w in order if self.profiles[w].capacity > depth]
            if not round_ws:
                return out
            out.extend(round_ws)
            depth += 1

    def assign(self, moe_index: int, experts: Sequence[int]) -> List[Tuple[int, int]]:
        """(expert, worker) pairs over the capacity-expanded
        ``load_targets``: overflow beyond the group spills onto other
        groups' alive workers, and a multi-slot worker takes a second
        expert before any worker is reused beyond its capacity.  Under a
        plan with affinity, each expert goes to its planned worker while
        that worker is alive with a free slot; the rest fill the remaining
        targets in order."""
        targets = self.load_targets(moe_index)
        if not targets:
            raise RuntimeError("no alive workers in the fleet")
        plan = self.plan
        if plan is not None and plan.expert_workers is not None:
            avail = list(targets)
            pinned: List[Optional[int]] = []
            for e in experts:
                w = plan.worker_of(moe_index, e)
                if w is not None and w in avail:
                    avail.remove(w)
                    pinned.append(w)
                else:
                    pinned.append(None)
            out: List[Tuple[int, int]] = []
            j = 0
            for e, w in zip(experts, pinned):
                if w is None:
                    pool = avail if avail else targets
                    w = pool[j % len(pool)]
                    j += 1
                out.append((e, w))
            return out
        return [(e, targets[j % len(targets)]) for j, e in enumerate(experts)]

    def place(self, moe_index: int, experts: Sequence[int],
              reserved: Optional[Dict[int, int]] = None) -> List[Tuple[int, int]]:
        """Predicted-load placement: the base walk over ``load_targets``
        without a plan's affinity.  With it, each predicted expert lands on
        its planned worker while that worker has a free slot; the rest pair
        with the remaining slots in preference order, and the overflow is
        dropped for the reload path as in the base placement."""
        plan = self.plan
        if plan is None or plan.expert_workers is None:
            return super().place(moe_index, experts, reserved)
        budget = dict(reserved) if reserved else {}
        slots: List[int] = []
        for w in self.load_targets(moe_index):
            if budget.get(w, 0) > 0:
                budget[w] -= 1
                continue
            slots.append(w)
        placed: List[Tuple[int, int]] = []
        overflow: List[int] = []
        for e in experts:
            w = plan.worker_of(moe_index, e)
            if w is not None and w in slots:
                slots.remove(w)
                placed.append((e, w))
            else:
                overflow.append(e)
        placed.extend(zip(overflow, slots))
        return placed

    # ------------------------------------------------------ Eq. 1, per link
    def t_load_s(self, worker: int, expert_bytes: float,
                 default_gbps: float = DEFAULT_LINK_GBPS) -> float:
        """Expert-load duration on this worker's (throttled) link, for the
        bytes that cross it (full width or a transport codec's payload).
        ``link_gbps_of`` is also what ``_fast_first`` orders by, so
        pricing and scheduling cannot disagree."""
        return expert_bytes / (self.link_gbps_of(worker, default_gbps) * 1e9)

    def io_bottlenecked_worker(self, worker: int, expert_bytes: float, t_main: float,
                               t_worker: float,
                               default_gbps: float = DEFAULT_LINK_GBPS) -> bool:
        """Per-worker Eq. (1): does this link exceed the group's
        ``t_maxload`` budget?"""
        return self.t_load_s(worker, expert_bytes, default_gbps) > \
            self.t_maxload(t_main, t_worker)
