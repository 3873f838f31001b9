"""Scripted fault injection: kill, recover or throttle workers at chosen
decode steps (``repro.fleet.faults``).

Events are deterministic and seen by the engine: a *kill* marks the
worker dead in the shared ``FleetState`` and drops its resident experts
from ``WorkerSlots`` (the device is gone, so a predicted expert it held
is stranded and reloads on a survivor); *recover* brings it back empty;
*throttle* rescales its link bandwidth, which only the timing model
feels.  The rule is degraded but correct: a fault costs reloads and
time, never a token.

Two hook points, where failures bite in Fig. 2's pipeline:

  * step-scoped events (``moe_index is None``) fire before the decode
    step starts: the worker is simply absent from scheduling;
  * layer-scoped events fire mid-step, after that MoE layer's predicted
    experts were loaded and before the gate result claims them: the
    stranded-load window, where a death costs a reload on a survivor.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .profile import FleetState

KINDS = ("kill", "recover", "throttle")


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.  ``step`` compares against the engine's step
    counter (``generate``: token index ``n >= 1``; serving: the global
    composed-step index ``>= 0``)."""
    step: int
    worker: int
    kind: str                        # "kill" | "recover" | "throttle"
    factor: float = 1.0              # throttle: link-bandwidth multiplier
    moe_index: Optional[int] = None  # None: step start; else mid-step, after
    #                                  that MoE layer's predicted loads

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "throttle" and self.factor <= 0:
            raise ValueError("throttle factor must be positive")


def outage(worker: int, start_step: int, recover_step: Optional[int] = None,
           moe_index: Optional[int] = None) -> List[FaultEvent]:
    """Kill at ``start_step`` (mid-layer with ``moe_index``), recover at
    ``recover_step`` (None: stays dead)."""
    events = [FaultEvent(start_step, worker, "kill", moe_index=moe_index)]
    if recover_step is not None:
        if recover_step <= start_step:
            raise ValueError("recover_step must follow start_step")
        events.append(FaultEvent(recover_step, worker, "recover"))
    return events


def random_fault_script(seed: int, n_workers: int, n_steps: int, n_moe: int,
                        max_kills: Optional[int] = None) -> List[FaultEvent]:
    """A seeded random fault script: step-scoped and mid-layer kills (some
    recovered) and throttles, with at most ``max_kills`` (default: just
    under half the fleet) workers dead at once, so a layer always has
    workers to serve it.  Draws from ``random.Random(seed)`` in the JAX
    package's order, so a seed gives the same script in both packages."""
    rng = random.Random(seed)
    if max_kills is None:
        max_kills = max(1, (n_workers - 1) // 2)
    victims = rng.sample(range(n_workers), min(n_workers, max_kills + 2))
    events: List[FaultEvent] = []
    kills = 0
    for w in victims:
        kind = rng.choice(("kill", "throttle", "none"))
        if kind == "none":
            continue
        step = rng.randint(1, max(1, n_steps - 1))
        if kind == "throttle":
            events.append(FaultEvent(step, w, "throttle", factor=rng.choice((0.25, 0.5, 2.0))))
            continue
        if kills >= max_kills:
            continue
        kills += 1
        moe_index = (rng.randint(0, n_moe - 1) if n_moe and rng.random() < 0.5 else None)
        events.append(FaultEvent(step, w, "kill", moe_index=moe_index))
        if rng.random() < 0.5 and step + 1 < n_steps:
            events.append(FaultEvent(rng.randint(step + 1, n_steps), w, "recover"))
    return events


class FaultInjector:
    """Applies scripted ``FaultEvent``s once each, in script order.

    The engine calls ``apply`` at each decode-step start and
    ``apply_layer`` inside each MoE layer; a trace replay
    (``simulate_odmoe``), which has no layer hook, calls
    ``apply_step_all``.  ``applied`` keeps the fired events, in firing
    order."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: List[FaultEvent] = list(events)
        self._done = [False] * len(self.events)
        self.applied: List[FaultEvent] = []

    def reset(self) -> None:
        self._done = [False] * len(self.events)
        self.applied = []

    def _fire(self, i: int, state: FleetState, slots=None) -> None:
        ev = self.events[i]
        self._done[i] = True
        self.applied.append(ev)
        if ev.kind == "kill":
            state.kill(ev.worker)
            if slots is not None:
                slots.fail(ev.worker)
        elif ev.kind == "recover":
            state.recover(ev.worker)
            if slots is not None:
                slots.recover(ev.worker)
        else:
            state.throttle(ev.worker, ev.factor)

    def apply(self, step: int, state: FleetState, slots=None) -> None:
        """Step-start hook: fire the pending step-scoped events due by
        ``step`` (``<=``, so no event is lost when steps are skipped)."""
        for i, ev in enumerate(self.events):
            if not self._done[i] and ev.moe_index is None and ev.step <= step:
                self._fire(i, state, slots)

    def apply_layer(self, step: int, moe_index: int, state: FleetState, slots=None) -> None:
        """Mid-step hook: fire the events scoped to this MoE layer that are
        due by ``step``."""
        for i, ev in enumerate(self.events):
            if not self._done[i] and ev.moe_index == moe_index and ev.step <= step:
                self._fire(i, state, slots)

    def apply_step_all(self, step: int, state: FleetState, slots=None) -> None:
        """Trace-replay hook: fire everything due by ``step``, layer-scoped
        or not (a replay has no per-layer callback)."""
        for i, ev in enumerate(self.events):
            if not self._done[i] and ev.step <= step:
                self._fire(i, state, slots)
