"""Request lifecycle for continuous batching over the cacheless engine.

A ``Request`` is what arrives (prompt, token budget, arrival time); a
``RequestState`` is everything the serving loop carries for it between
composed decode steps: the main model's decode state (per-layer caches
with batch axis 1, position, last token), the request's own SEP shadow
state, a cached shadow peek (its prediction for the next step, computed
without committing the shadow, so a request can sit out composition
rounds without drifting), its tokens, and its timestamps on the timing
model's clock.  ``RequestQueue`` orders arrivals, admits them when the
clock reaches them and tracks the active and finished populations; which
active requests decode together is the ``BatchComposer``'s job.
(``repro.serve.request``.)
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import Trace, poisson_arrivals


@dataclass
class Request:
    """One serving request: ``prompt`` is a 1-D int32 token array.

    ``tenant``/``weight``/``ttft_slo_s``/``tpot_slo_s`` carry its service
    class (``serve.workload.TenantClass``): scheduling metadata, never
    arithmetic.  The defaults make one anonymous best-effort class."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    tenant: str = "default"
    weight: float = 1.0
    ttft_slo_s: float = math.inf
    tpot_slo_s: float = math.inf

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first token falls "
                             "out of prefill)")
        if self.weight <= 0:
            raise ValueError("weight must be > 0")


@dataclass
class RequestState:
    """Mutable per-request decode state between composed steps."""
    request: Request
    token: object                 # (1,) last emitted main token (tensor)
    cache_list: list              # per-layer caches with batch axis 1, or a paged handle
    pos: object                   # (1,) absolute position (tensor)
    shadow_state: Optional[dict] = None
    # cached shadow peek (preds_steps, snapshots, aligned_token, aligned_kv,
    # drafts), valid until the request's next committed step: S-long lists
    # of {layer: (1, k)} predictions and of the shadow state after each of
    # the S draft steps, and the (1, S-1) draft tokens (S = the engine's
    # ``speculate``; S = 1 is the one-token peek)
    pending: Optional[tuple] = None
    generated: List[int] = field(default_factory=list)
    last_experts: FrozenSet[Tuple[int, int]] = frozenset()
    trace: Trace = field(default_factory=Trace)
    admit_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    # paged serving: admission sequence number (the preemption priority,
    # youngest first) and whether the pages are swapped out to the host
    admit_seq: int = -1
    preempted: bool = False
    # chunked prefill: the prompt's modelled prefill cost charges one
    # chunk per iteration; the real prefill runs once, at the last chunk
    prefilling: bool = False
    prefill_chunks: List[int] = field(default_factory=list)
    prefill_chunk_s: List[float] = field(default_factory=list)
    # speculative decoding: verify waves taken and tokens they committed
    spec_waves: int = 0
    spec_committed: int = 0

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return (not self.prefilling
                and len(self.generated) >= self.request.max_new_tokens)

    def deadline_slack(self, now: float) -> float:
        """Seconds before the next token misses the TPOT SLO: token
        ``len(generated) + 1`` is due at ``first_token_s + tpot_slo_s *
        len(generated)``.  Infinite without a TPOT target and while
        prefilling."""
        slo = self.request.tpot_slo_s
        if math.isinf(slo) or self.prefilling:
            return math.inf
        return (self.first_token_s + slo * len(self.generated)) - now

    def predicted_experts(self) -> FrozenSet[Tuple[int, int]]:
        """(layer, expert) pairs the request is predicted to use on its
        next step, the composer's overlap signature; the previous step's
        true routing when no SEP peek exists."""
        if self.pending is not None:
            return frozenset((li, int(e)) for preds in self.pending[0]
                             for li, p in preds.items() for e in p.reshape(-1))
        return self.last_experts


def make_traffic(cfg, n: int, rate: float, prompt_len: int = 16, max_new: int = 10,
                 seed: int = 0) -> List[Request]:
    """The deterministic request mix of the CLI and the tests: prompt
    lengths in [prompt_len/2, prompt_len], budgets in [max_new/2, max_new],
    Poisson arrivals at ``rate`` req/s of modelled time (<= 0: all at
    t=0).  Same numpy draws as ``repro.serve.make_traffic``."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rate, n, seed=seed + 1)
    reqs = []
    for i in range(n):
        p_lo = min(max(2, prompt_len // 2), prompt_len)
        plen = int(rng.integers(p_lo, prompt_len + 1))
        b_lo = min(max(1, max_new // 2), max_new)
        budget = int(rng.integers(b_lo, max_new + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=budget,
                            arrival_s=arrivals[i]))
    return reqs


class RequestQueue:
    """Arrival-ordered admission and active/finished bookkeeping: pending
    arrivals in a heap keyed by ``(arrival_s, rid)``, active states in a
    dict whose insertion order is admission order."""

    def __init__(self, requests: Sequence[Request]):
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request ids must be unique")
        self._pending: List[Tuple[float, int, Request]] = [
            (r.arrival_s, r.rid, r) for r in requests]
        heapq.heapify(self._pending)
        self._active: Dict[int, RequestState] = {}
        self.finished: Dict[int, RequestState] = {}

    @property
    def active(self) -> List[RequestState]:
        """Active states in admission order (a view; membership changes go
        through ``activate`` and ``retire``)."""
        return list(self._active.values())

    def next_arrival_s(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    def add(self, req: Request) -> None:
        """Enqueue one more pending arrival (the cluster router feeds a
        started queue online); a request id already pending, active or
        finished is rejected."""
        if (req.rid in self._active or req.rid in self.finished
                or any(rid == req.rid for _, rid, _ in self._pending)):
            raise ValueError(f"request id {req.rid} already in the queue")
        heapq.heappush(self._pending, (req.arrival_s, req.rid, req))

    def pop_arrived(self, now: float) -> List[Request]:
        """Remove and return every pending request with ``arrival_s <=
        now``, in arrival order."""
        arrived = []
        while self._pending and self._pending[0][0] <= now:
            arrived.append(heapq.heappop(self._pending)[2])
        return arrived

    def activate(self, state: RequestState) -> None:
        self._active[state.rid] = state

    def retire(self, state: RequestState) -> None:
        del self._active[state.rid]
        self.finished[state.rid] = state

    def runnable(self) -> List[RequestState]:
        """Active requests that can decode next, in admission order
        (preempted and still-prefilling requests sit out)."""
        return [s for s in self._active.values()
                if not s.done and not s.preempted and not s.prefilling]

    def prefilling(self) -> List[RequestState]:
        return [s for s in self._active.values() if s.prefilling]

    def preempted(self) -> List[RequestState]:
        """Swapped-out requests, oldest admission first (the resume order)."""
        return [s for s in self._active.values() if s.preempted]

    def state_counts(self) -> Dict[str, int]:
        """One-pass population summary for the per-step records."""
        runnable = preempted = prefilling = 0
        for s in self._active.values():
            if s.prefilling:
                prefilling += 1
            elif s.preempted:
                preempted += 1
            elif not s.done:
                runnable += 1
        return {"pending": len(self._pending), "active": len(self._active),
                "runnable": runnable, "preempted": preempted,
                "prefilling": prefilling, "finished": len(self.finished)}

    @property
    def all_done(self) -> bool:
        return not self._pending and not self._active
