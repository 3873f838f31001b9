"""ClusterRouter: N serving replicas over one shared worker fleet
(``repro.serve.cluster``).

One ``ServingLoop`` is one main node.  The router owns N replica loops
whose engines share what a cluster shares:

  * one ``ExpertStore`` (the weights are packed once) and one
    ``FleetSchedule``, so liveness, throttles and a placement plan are
    cluster-wide, and every replica schedules against one fleet state;
  * one ``worker_free`` timeline dict in every replica's ``DecodeClock``:
    a worker loading for replica A delays replica B's loads, the modelled
    form of fleet contention (each replica keeps its own main-node clock);
  * optionally one ``GateStatsRecorder``, so routing statistics pool
    across replicas for the placement optimizer.

Worker slots, predictors and prefetch executors (and their side streams)
stay private to each replica.  A fault fired by one replica's injector
fails that replica's slots only, while the liveness it sets lives in the
shared fleet state.

Routing is per request and online: the router replays arrivals in time
order and hands each to a replica by policy (``round_robin``,
``least_loaded``: fewest outstanding requests, or ``weighted``: least
outstanding tenant weight), and otherwise ticks the busy replica with the
earliest clock (ties to the lower index), so cluster time advances as
one discrete-event simulation.  Idle replicas park: their clock stands
until work is routed to them.  With ``autoscale``, pressure above
``high_load`` outstanding requests per active replica for ``sustain``
routing decisions activates a parked replica, and pressure below
``low_load`` drains the newest active one (it finishes its work but takes
no new requests); ``ClusterResult.autoscale_events`` records both.

Everything here is scheduling: each request decodes through ordinary
engine waves on the same round-tripped weights, so its tokens equal its
solo ``greedy_generate(..., transport=policy)`` whatever replica served
it, whatever plan placed its experts and however the fleet was contended.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import ODMoEEngine, ServingTimings

from .loop import ServeResult, ServingLoop
from .request import Request

ROUTING_POLICIES = ("round_robin", "least_loaded", "weighted")


@dataclass
class ClusterResult:
    """Per-replica results and their cluster-wide merge."""
    replicas: List[ServeResult]
    assignments: Dict[int, int] = field(default_factory=dict)   # rid -> replica
    autoscale_events: List[Dict] = field(default_factory=list)
    policy: str = "least_loaded"

    @property
    def states(self) -> Dict[int, object]:
        out = {}
        for r in self.replicas:
            out.update(r.states)
        return dict(sorted(out.items()))

    @property
    def outputs(self) -> Dict[int, np.ndarray]:
        """rid -> generated tokens, merged across replicas."""
        out = {}
        for r in self.replicas:
            out.update(r.outputs)
        return dict(sorted(out.items()))

    @property
    def timings(self) -> ServingTimings:
        """Cluster-wide timings in ascending request-id order."""
        states = self.states
        return ServingTimings(
            arrival_s=[s.request.arrival_s for s in states.values()],
            first_token_s=[s.first_token_s for s in states.values()],
            finish_s=[s.finish_s for s in states.values()],
            tokens=[len(s.generated) for s in states.values()],
            tenants=[s.request.tenant for s in states.values()],
            ttft_slo_s=[s.request.ttft_slo_s for s in states.values()],
            tpot_slo_s=[s.request.tpot_slo_s for s in states.values()])

    def report(self) -> Dict:
        """The cluster-wide percentile and SLO report, with per-replica rows."""
        rep = dict(self.timings.report())
        rep["replicas"] = len(self.replicas)
        rep["autoscale_events"] = len(self.autoscale_events)
        rep["per_replica"] = self.per_replica_report()
        return rep

    def per_replica_report(self) -> List[Dict]:
        return [dict(r.timings.report(), requests=len(r.states), mean_batch=r.mean_batch)
                for r in self.replicas]

    def tenant_report(self) -> Dict[str, Dict[str, float]]:
        return self.timings.per_tenant_report()


class ClusterRouter:
    """Route requests across N ``ServingLoop`` replicas and drive their
    ticks in cluster-time order (see the module docstring)."""

    def __init__(self, loops: Sequence[ServingLoop], *, policy: str = "least_loaded",
                 autoscale: bool = False, min_replicas: int = 1, high_load: float = 4.0,
                 low_load: float = 1.0, sustain: int = 3):
        if not loops:
            raise ValueError("a cluster needs at least one replica")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}")
        if not 1 <= min_replicas <= len(loops):
            raise ValueError("min_replicas must be in [1, n_replicas]")
        if high_load <= low_load:
            raise ValueError("high_load must exceed low_load")
        self.loops = list(loops)
        self.policy = policy
        self.autoscale = autoscale
        self.min_replicas = min_replicas
        self.high_load = high_load
        self.low_load = low_load
        self.sustain = max(1, int(sustain))

    # ------------------------------------------------------------ loads
    def _outstanding(self, i: int) -> int:
        return self._assigned[i] - len(self.loops[i].finished)

    def _outstanding_weight(self, i: int) -> float:
        done = sum(s.request.weight for s in self.loops[i].finished.values())
        return self._assigned_w[i] - done

    def _route(self, req: Request) -> int:
        cands = self._active
        if self.policy == "round_robin":
            idx = cands[self._rr % len(cands)]
            self._rr += 1
        elif self.policy == "weighted":
            idx = min(cands, key=lambda i: (self._outstanding_weight(i), i))
        else:
            idx = min(cands, key=lambda i: (self._outstanding(i), i))
        self._assigned[idx] += 1
        self._assigned_w[idx] += req.weight
        self._assignments[req.rid] = idx
        self.loops[idx].add_request(req)
        return idx

    def _autoscale_check(self, now: float) -> None:
        if not self.autoscale:
            return
        pressure = sum(self._outstanding(i) for i in self._active) / len(self._active)
        if pressure > self.high_load:
            self._hot, self._cold = self._hot + 1, 0
        elif pressure < self.low_load:
            self._hot, self._cold = 0, self._cold + 1
        else:
            self._hot = self._cold = 0
        parked = [i for i in range(len(self.loops)) if i not in self._active]
        if self._hot >= self.sustain and parked:
            self._active = sorted(self._active + parked[:1])
            self._hot = 0
            self.autoscale_events.append(dict(t=now, event="spawn", replica=parked[0],
                                              pressure=pressure))
        elif self._cold >= self.sustain and len(self._active) > self.min_replicas:
            drained = self._active[-1]
            self._active = self._active[:-1]
            self._cold = 0
            self.autoscale_events.append(dict(t=now, event="drain", replica=drained,
                                              pressure=pressure))

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> ClusterResult:
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        if not reqs:
            return ClusterResult(replicas=[l.run([]) for l in self.loops], policy=self.policy)
        cache_len = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 2
        # one fleet: every replica's clock shares these worker timelines
        shared_free: Dict[int, float] = defaultdict(float)
        for loop in self.loops:
            loop.start([], clock=loop._new_clock(shared_free), cache_len=cache_len)
        n_active = self.min_replicas if self.autoscale else len(self.loops)
        self._active = list(range(n_active))
        self._assigned = [0] * len(self.loops)
        self._assigned_w = [0.0] * len(self.loops)
        self._assignments: Dict[int, int] = {}
        self._rr = 0
        self._hot = self._cold = 0
        self.autoscale_events: List[Dict] = []
        pending = deque(reqs)
        while pending or any(l.has_work() for l in self.loops):
            busy = [i for i, l in enumerate(self.loops) if l.has_work()]
            nxt = min(busy, key=lambda i: (self.loops[i].clock.now, i)) if busy else None
            if pending and (nxt is None or pending[0].arrival_s <= self.loops[nxt].clock.now):
                # cluster time reached this arrival (or the cluster is idle):
                # route it now, while the loads reflect its arrival
                req = pending.popleft()
                self._autoscale_check(req.arrival_s)
                self._route(req)
            else:
                self.loops[nxt].tick()
        return ClusterResult(replicas=[l.finish() for l in self.loops],
                             assignments=dict(self._assignments),
                             autoscale_events=list(self.autoscale_events), policy=self.policy)


def make_cluster(cfg, params, *, replicas: int = 2, policy: str = "least_loaded",
                 engine_kw: Optional[Dict] = None, loop_kw: Optional[Dict] = None,
                 **router_kw) -> ClusterRouter:
    """A cluster of ``replicas`` serving loops whose engines share one
    expert store, one fleet schedule (so one fleet state and any placement
    plan) and one gate-stats recorder.  ``engine_kw`` and ``loop_kw`` go to
    ``ODMoEEngine`` and ``ServingLoop``."""
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    engine_kw = dict(engine_kw or {})
    loop_kw = dict(loop_kw or {})
    first = ODMoEEngine(cfg, params, **engine_kw)
    engines = [first]
    # the fleet, store and statistics are shared; slots, predictors and
    # prefetch executors stay per replica
    shared = dict(engine_kw, sched=first.sched, store=first.store, gate_stats=first.gate_stats)
    for key in ("profiles", "n_workers", "group_size"):
        shared.pop(key, None)
    for _ in range(replicas - 1):
        engines.append(ODMoEEngine(cfg, params, **shared))
    loops = [ServingLoop(eng, **loop_kw) for eng in engines]
    return ClusterRouter(loops, policy=policy, **router_kw)
