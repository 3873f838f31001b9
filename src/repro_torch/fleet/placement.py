"""Gate-statistics expert placement, SlimCaching-style over Eq. (1)
(``repro.fleet.placement``).

The paper serves the i-th MoE layer with group ``i mod G`` and maps the
routed experts onto that group's workers by position: placement never
looks at which experts are hot.  Real gate distributions are skewed, so
a placement chosen from observed gate statistics can shrink the expected
per-wave load bound well below the modulo rotation's:

  * ``GateStatsRecorder``: per-MoE-layer expert routing counts and gate
    mass, collected live from the engine (``gate_stats=``) or replayed
    from a recorded trace.  Sorted-key accumulation, so equally seeded
    runs give identical dictionaries, and a commutative merge so
    replicas can pool their observations in any order.
  * ``PlacementPlan``: per-layer worker preference orders and an optional
    expert -> worker affinity.  ``FleetSchedule(plan=...)`` consults it in
    place of the ``i mod G`` rotation; ``uniform_plan`` orders exactly as
    the rotation does.
  * ``optimize_placement``: greedy longest-processing-time placement.  Per
    layer, experts in descending routed probability each go to the worker
    whose expected link load ``L_w = sum_e p_e * t_load_w(bytes)`` grows
    least; the layer's worker order is descending placed load.
    ``expected_t_maxload`` scores a plan as the mean over layers of
    ``max_w L_w``, a modelled quantity.

Placement moves only where predicted loads land.  Expert arithmetic is
untouched, so a decode under any plan gives ``greedy_generate``'s tokens.
Plain Python and numpy; ``observe`` also takes torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .profile import DEFAULT_LINK_GBPS
from .schedule import FleetSchedule


def _host(a, dtype=None) -> np.ndarray:
    """A torch tensor or array-like as a numpy array on the host."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        # widen first: numpy has no bfloat16, and the widening is exact
        a = (a.double() if dtype is not None else a).numpy()
    return np.asarray(a, dtype=dtype)


class GateStatsRecorder:
    """Per-MoE-layer expert routing statistics.

    ``counts[moe_index][expert]`` is how many (token, rank) routing
    decisions picked the expert, ``mass[moe_index][expert]`` the summed
    absolute gate weight, ``rows[moe_index]`` the token rows observed.
    Every update walks the experts in sorted order."""

    def __init__(self):
        self.counts: Dict[int, Dict[int, int]] = {}
        self.mass: Dict[int, Dict[int, float]] = {}
        self.rows: Dict[int, int] = {}

    def observe(self, moe_index: int, true, gates=None) -> None:
        """Record one step's routing for one MoE layer: ``true`` the (B, k)
        routed expert ids, ``gates`` the matching gate weights (optional:
        counts alone drive placement)."""
        true = _host(true)
        t = true.reshape(-1)
        g = np.abs(_host(gates, np.float64)).reshape(-1) if gates is not None else None
        c = self.counts.setdefault(moe_index, {})
        m = self.mass.setdefault(moe_index, {})
        upd: Dict[int, Tuple[int, float]] = {}
        for j, e in enumerate(int(x) for x in t):
            n, w = upd.get(e, (0, 0.0))
            upd[e] = (n + 1, w + (float(g[j]) if g is not None else 1.0))
        for e in sorted(upd):
            n, w = upd[e]
            c[e] = c.get(e, 0) + n
            m[e] = m.get(e, 0.0) + w
        self.rows[moe_index] = self.rows.get(moe_index, 0) + int(true.shape[0])

    def observe_trace(self, trace) -> None:
        """Replay a recorded engine ``Trace``."""
        for rec in trace.records:
            for lr in rec.layers:
                self.observe(lr.moe_index, lr.true, lr.gates)

    def merge(self, other: "GateStatsRecorder") -> "GateStatsRecorder":
        """Pool two recorders into a new one.  Counts are integer sums
        (commutative and associative); mass is float sums (commutative,
        associative to rounding), and placement reads counts only, so the
        merge order never changes a plan."""
        out = GateStatsRecorder()
        for src in (self, other):
            for moe, c in src.counts.items():
                oc = out.counts.setdefault(moe, {})
                om = out.mass.setdefault(moe, {})
                for e in sorted(c):
                    oc[e] = oc.get(e, 0) + c[e]
                    om[e] = om.get(e, 0.0) + src.mass[moe].get(e, 0.0)
            for moe in sorted(src.rows):
                out.rows[moe] = out.rows.get(moe, 0) + src.rows[moe]
        return out

    def freq(self, moe_index: int, num_experts: int) -> np.ndarray:
        """Routing probability per expert of one layer (uniform for a layer
        never observed)."""
        c = self.counts.get(moe_index, {})
        total = sum(c.values())
        if total <= 0:
            return np.full(num_experts, 1.0 / num_experts)
        p = np.zeros(num_experts, np.float64)
        for e, n in c.items():
            if 0 <= e < num_experts:
                p[e] = n / total
        return p

    @property
    def n_layers(self) -> int:
        return len(self.counts)


@dataclass(frozen=True)
class PlacementPlan:
    """Static expert placement for every MoE layer.

    ``orders[m]`` is the full worker preference order of the m-th MoE
    layer (every worker, home first); layers beyond ``len(orders)`` wrap
    modulo.  ``expert_workers[m][e]`` (optional) pins expert ``e`` to a
    worker, which ``FleetSchedule.place``/``assign`` honour while that
    worker is alive with a free slot.  Without affinity
    (``uniform_plan``) only the worker orders are fixed."""
    n_workers: int
    group_size: int
    orders: Tuple[Tuple[int, ...], ...]
    expert_workers: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        if not self.orders:
            raise ValueError("plan needs at least one layer order")
        for order in self.orders:
            if sorted(order) != list(range(self.n_workers)):
                raise ValueError("each layer order must be a permutation of all workers")
        if self.expert_workers is not None and len(self.expert_workers) != len(self.orders):
            raise ValueError("one expert->worker row per layer order")

    def order_for(self, moe_index: int) -> Tuple[int, ...]:
        return self.orders[moe_index % len(self.orders)]

    def worker_of(self, moe_index: int, expert: int) -> Optional[int]:
        if self.expert_workers is None:
            return None
        row = self.expert_workers[moe_index % len(self.expert_workers)]
        return row[expert] if 0 <= expert < len(row) else None


def uniform_plan(n_workers: int, group_size: int, n_moe: Optional[int] = None, *,
                 sched: Optional[FleetSchedule] = None) -> PlacementPlan:
    """The no-statistics plan: layer m's order is its ``m mod G`` home
    group, then the spill groups nearest first, with no expert affinity.
    ``sched`` snapshots a heterogeneous fleet's fast-first order within
    each group."""
    n_groups = n_workers // group_size
    orders = []
    for m in range(n_moe if n_moe else n_groups):
        order: List[int] = []
        for step in range(n_groups):
            g = (m + step) % n_groups
            seg = list(range(g * group_size, (g + 1) * group_size))
            order.extend(sched._fast_first(seg) if sched is not None else seg)
        orders.append(tuple(order))
    return PlacementPlan(n_workers, group_size, tuple(orders))


def _unit_load_s(sched: FleetSchedule, expert_bytes: float) -> List[float]:
    return [expert_bytes / (sched.link_gbps_of(w, DEFAULT_LINK_GBPS) * 1e9)
            for w in range(sched.n_workers)]


def optimize_placement(stats: GateStatsRecorder, sched: FleetSchedule, *, num_experts: int,
                       n_moe: Optional[int] = None,
                       expert_bytes: float = 1.0) -> PlacementPlan:
    """Greedy placement from recorded gate statistics.  Per layer, experts
    in descending routed probability (ties: lower id) each go to the
    worker whose ``L_w += p_e * bytes / link_gbps_of(w)`` grows least
    (ties: faster link, then lower index); the layer's worker order is
    descending placed load (same ties)."""
    n_moe = n_moe or max(stats.n_layers, 1)
    t_unit = _unit_load_s(sched, expert_bytes)
    orders: List[Tuple[int, ...]] = []
    affinity: List[Tuple[int, ...]] = []
    for m in range(n_moe):
        p = stats.freq(m, num_experts)
        load = [0.0] * sched.n_workers
        owner = [0] * num_experts
        for e in sorted(range(num_experts), key=lambda e: (-p[e], e)):
            w = min(range(sched.n_workers),
                    key=lambda w: (load[w] + p[e] * t_unit[w], t_unit[w], w))
            owner[e] = w
            load[w] += p[e] * t_unit[w]
        orders.append(tuple(sorted(range(sched.n_workers),
                                   key=lambda w: (-load[w], t_unit[w], w))))
        affinity.append(tuple(owner))
    return PlacementPlan(sched.n_workers, sched.group_size, tuple(orders), tuple(affinity))


def modulo_plan(sched: FleetSchedule, *, num_experts: int, n_moe: int) -> PlacementPlan:
    """The ``i mod G`` baseline as an explicit plan, for scoring: layer m's
    experts round-robin over its home group's workers by expert id, in
    the rotation's order."""
    base = uniform_plan(sched.n_workers, sched.group_size, n_moe)
    affinity = []
    for m in range(n_moe):
        home = base.orders[m][:sched.group_size]
        affinity.append(tuple(home[e % len(home)] for e in range(num_experts)))
    return PlacementPlan(sched.n_workers, sched.group_size, base.orders, tuple(affinity))


def expected_t_maxload(plan: PlacementPlan, stats: GateStatsRecorder, sched: FleetSchedule,
                       *, num_experts: int, n_moe: Optional[int] = None,
                       expert_bytes: float = 1.0) -> float:
    """Modelled expected per-wave load bound of a plan: the mean over
    layers of ``max_w sum_{e -> w} p_e * t_load_w(bytes)``, the quantity
    ``optimize_placement`` minimizes."""
    if plan.expert_workers is None:
        raise ValueError("plan has no expert->worker affinity to score")
    n_moe = n_moe or len(plan.orders)
    t_unit = _unit_load_s(sched, expert_bytes)
    total = 0.0
    for m in range(n_moe):
        p = stats.freq(m, num_experts)
        load = [0.0] * sched.n_workers
        for e in range(num_experts):
            w = plan.worker_of(m, e)
            load[w] += p[e] * t_unit[w]
        total += max(load)
    return total / max(n_moe, 1)
