"""ServingLoop: continuous batching driven by the OD-MoE engine
(``repro.serve.loop``).

Each iteration (``tick``): (1) with a KV pool, resume preempted requests
and admit deferred ones as pages free up; then admit every request whose
arrival time the modelled clock has passed, running the real prefill on
admission (the first token falls out of prefill, so TTFT = admission
wait + prefill); with ``prefill_chunk=N`` a long prompt's modelled
prefill cost is paid one N-token chunk per iteration and the real
prefill runs once, at the last chunk; (2) refresh the runnable requests'
SEP peeks: every request lacking one is aligned on its own, the shadows
are composed and stepped as one batched decode (``_ensure_peeks``), and
each request keeps its prediction without committing its shadow, so a
request that waits never drifts (with ``engine.speculate=S`` the composed
shadow rolls out S draft steps instead, and each request keeps its
predictions, drafts and per-step shadow snapshots); (3) let the
``BatchComposer`` pick up to ``max_batch`` requests; (4) run one composed
``decode_batch_spec`` through the engine (a one-token step, or a verify
wave of B*S rows), with load events tagged by the batch's request ids,
and charge its duration on the ``DecodeClock``; (5) split the batch back
into per-request states (under speculation each request commits its own
accepted prefix, capped by its budget, and lands its shadow on the
matching snapshot) and retire finished requests.

KV memory is a budget when the loop carries a ``KVPool``: a request whose
prompt pages do not fit is deferred (FIFO, or by tenant weight under
``admit="priority"``); when a running request crosses a page boundary on
a full pool, a runnable victim (youngest, or the most TPOT-deadline slack
under ``preempt="slack"``) is swapped out to the host byte for byte
(``DecodeClock.charge_kv_swap`` prices it) and resumes, oldest first,
once retirements free pages.

Invariant: every request's tokens equal its solo ``greedy_generate``
under the engine's transport policy, whatever batches it rode in and
however often it was preempted.  Batch composition, deferral and
preemption are scheduling, never arithmetic: decode steps run their
row-local work in fixed row blocks (``rows.row_blocks``), and
the attention and expert kernels give each row bits that do not depend
on B or on the cache window.

An engine built with ``prefetch`` and ``residency`` serves the same
tokens and events; ``ServeResult.prefetch_stats`` carries its
``prefetch_report()``, and ``ServeResult.spec_stats`` the acceptance of a
speculating engine.

Serving survives fleet faults: when the engine carries a
``repro_torch.fleet.FaultInjector``, kills, recoveries and throttles fire
at the global composed-step index (``StepRecord.step``), every request
still equals its solo decode, ``StepRecord.alive_workers`` records the
fleet's liveness after each step's faults, and
``ServeResult.degraded_report()`` splits the modelled step times into
healthy- and degraded-fleet steps.  ``run`` is ``start``, ``tick`` until
nothing is left, ``finish``; the cluster router
(``repro_torch.serve.cluster``) instead starts each replica with a clock
of its own over a shared fleet timeline, feeds arrivals through
``add_request`` and interleaves the replicas' ticks.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (RTX3090_EDGE, AlignmentPolicy, DecodeClock, LayerRecord,
                              ODMoEEngine, ServingTimings, TokenRecord, Trace,
                              concat_cache_lists, concat_shadow_states, degraded_tpot_report,
                              recall_counts, simulate_prefill_odmoe, slice_cache_list,
                              slice_shadow_state, wave_preds)
from repro_torch.core.timing import HardwareProfile

from .composer import BatchComposer
from .kvpool import KVPool, PoolExhausted
from .request import Request, RequestQueue, RequestState


def preemption_victim(runnable: List[RequestState], policy: str,
                      now: float) -> RequestState:
    """The preemption victim among ``runnable``: the youngest admission
    (``youngest``, the default), or the request with the most deadline
    slack (``slack``; no TPOT SLO is infinite slack, ties go youngest)."""
    if policy == "slack":
        return max(runnable, key=lambda s: (s.deadline_slack(now), s.admit_seq))
    return max(runnable, key=lambda s: s.admit_seq)


class _AdmissionQueue:
    """Deferred admissions: strict arrival order (``fifo``), or descending
    tenant weight, FIFO within a weight (``priority``)."""

    def __init__(self, policy: str = "fifo"):
        self.policy = policy
        self._fifo: deque = deque()
        self._heap: list = []

    def push(self, req: Request) -> None:
        if self.policy == "priority":
            heapq.heappush(self._heap, (-req.weight, req.arrival_s, req.rid, req))
        else:
            self._fifo.append(req)

    def peek(self) -> Request:
        return self._heap[0][3] if self.policy == "priority" else self._fifo[0]

    def pop(self) -> Request:
        if self.policy == "priority":
            return heapq.heappop(self._heap)[3]
        return self._fifo.popleft()

    def __len__(self) -> int:
        return len(self._heap) + len(self._fifo)


@dataclass
class StepRecord:
    """One composed decode step: who rode, what it cost (modelled), and
    its measured wall time on the engine's device."""
    step: int
    request_ids: List[int]
    record: TokenRecord
    start_s: float
    duration_s: float
    stall_s: float
    alive_workers: int = -1      # fleet liveness after this step's faults
    kv_pages_used: int = -1      # pool occupancy after this step (paged)
    queue_counts: Optional[Dict[str, int]] = None
    wall_s: float = 0.0          # measured: host clock ending in a device sync


@dataclass
class ServeResult:
    outputs: Dict[int, np.ndarray]       # rid -> generated tokens
    timings: ServingTimings
    trace: Trace                         # composed-step trace (loads etc.)
    steps: List[StepRecord] = field(default_factory=list)
    states: Dict[int, RequestState] = field(default_factory=dict)
    n_workers: int = 0
    kv_stats: Optional[Dict] = None      # pool counters + swap seconds
    prefetch_stats: Optional[Dict] = None  # engine.prefetch_report(), when
    #                                        prefetch or residency ran
    # speculating engines: {"speculate", "waves", "committed", "acceptance",
    # "per_request": {rid: {"waves", "committed", "acceptance"}}}
    spec_stats: Optional[Dict] = None

    @property
    def mean_batch(self) -> float:
        if not self.steps:
            return 0.0
        return float(np.mean([len(s.request_ids) for s in self.steps]))

    def tenant_report(self) -> Dict[str, Dict[str, float]]:
        return self.timings.per_tenant_report()

    def degraded_report(self) -> Dict[str, float]:
        return degraded_tpot_report(
            [s.duration_s for s in self.steps],
            [s.alive_workers if s.alive_workers >= 0 else self.n_workers
             for s in self.steps], self.n_workers)


class ServingLoop:
    def __init__(self, engine: ODMoEEngine, *, max_batch: int = 4,
                 composer: Optional[BatchComposer] = None,
                 profile: HardwareProfile = RTX3090_EDGE,
                 policy: AlignmentPolicy = AlignmentPolicy(1, 1),
                 max_seq_len: int = 0, kv_pool: Optional[KVPool] = None,
                 prefill_chunk: int = 0, preempt: str = "youngest", admit: str = "fifo"):
        if preempt not in ("youngest", "slack"):
            raise ValueError(f"unknown preemption policy {preempt!r}")
        if admit not in ("fifo", "priority"):
            raise ValueError(f"unknown admission policy {admit!r}")
        self.engine = engine
        # the wave width rides on the engine; the loop rolls out the peeks
        # and commits per request
        self.speculate = engine.speculate
        self.kv_pool = kv_pool
        self.composer = composer or BatchComposer(max_batch, kv_pool=kv_pool)
        if kv_pool is not None and self.composer.kv_pool is None:
            self.composer.kv_pool = kv_pool
        self.profile = profile
        self.policy = policy
        self.max_seq_len = max_seq_len
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.preempt_policy = preempt
        self.admit_policy = admit

    # ------------------------------------------------------------- admit
    def _prefill(self, state: RequestState, cache_len: int) -> None:
        """The real prefill on the main node, and the shadow's."""
        eng, req = self.engine, state.request
        batch = {"tokens": torch.as_tensor(req.prompt, device=eng.device)[None, :]}
        state.token, state.cache_list, state.pos = eng.prefill_request(
            batch, cache_len, kv_pool=self.kv_pool,
            rid=req.rid if self.kv_pool is not None else None)
        state.generated.append(int(state.token[0]))
        if eng.shadow is not None:
            state.shadow_state = eng.shadow.prefill_state(batch, cache_len)

    def _admit(self, req: Request, cache_len: int, clock: DecodeClock) -> RequestState:
        """Prefill ``req`` (real compute, modelled time); its first token is
        emitted here."""
        eng = self.engine
        admit_s = clock.now
        clock.charge_prefill(simulate_prefill_odmoe(eng.cfg, self.profile, len(req.prompt),
                                                    n_workers=eng.sched.n_workers))
        state = RequestState(request=req, token=None, cache_list=[], pos=None,
                             admit_s=admit_s, first_token_s=clock.now)
        state.admit_seq = self._admit_seq
        self._admit_seq += 1
        self._prefill(state, cache_len)
        return state

    def _pool_fits_prompt(self, req: Request) -> bool:
        pool = self.kv_pool
        return pool is None or pool.can_alloc(pool.pages_for(len(req.prompt)))

    def _is_chunked(self, req: Request) -> bool:
        return bool(self.prefill_chunk and len(req.prompt) > self.prefill_chunk)

    def _admission_fits(self, req: Request) -> bool:
        # a chunked prompt claims its pages at its last chunk
        return self._is_chunked(req) or self._pool_fits_prompt(req)

    def _admit_or_retire(self, req: Request, cache_len: int, clock: DecodeClock,
                         queue: RequestQueue) -> None:
        if self._is_chunked(req):
            n, c = len(req.prompt), self.prefill_chunk
            chunks = [c] * (n // c) + ([n % c] if n % c else [])
            # slices of the one full-prompt cost (prefill cost is not
            # additive in prompt length); the last takes the remainder
            t_full = simulate_prefill_odmoe(self.engine.cfg, self.profile, n,
                                            n_workers=self.engine.sched.n_workers)
            costs = [t_full * ch / n for ch in chunks]
            costs[-1] = t_full - sum(costs[:-1])
            state = RequestState(request=req, token=None, cache_list=[], pos=None,
                                 admit_s=clock.now, prefilling=True, prefill_chunks=chunks,
                                 prefill_chunk_s=costs)
            state.admit_seq = self._admit_seq
            self._admit_seq += 1
            queue.activate(state)
            return
        state = self._admit(req, cache_len, clock)
        queue.activate(state)
        if state.done:                       # max_new_tokens == 1
            state.finish_s = clock.now
            self._retire(state, queue)

    # ------------------------------------------------ chunked prefill
    def _advance_prefills(self, queue: RequestQueue, clock: DecodeClock,
                          cache_len: int) -> bool:
        """Charge one chunk per mid-prefill request; finalize those whose
        last chunk landed."""
        progressed = False
        for state in queue.prefilling():
            if state.prefill_chunks:
                state.prefill_chunks.pop(0)
                clock.charge_prefill(state.prefill_chunk_s.pop(0))
                progressed = True
            if not state.prefill_chunks:
                progressed |= self._finalize_prefill(state, cache_len, clock, queue)
        return progressed

    def _finalize_prefill(self, state: RequestState, cache_len: int, clock: DecodeClock,
                          queue: RequestQueue) -> bool:
        """The real prefill of a fully charged chunked admission; on a full
        pool it retries as retirements free pages."""
        if not self._pool_fits_prompt(state.request):
            return False
        self._prefill(state, cache_len)
        state.first_token_s = clock.now
        state.prefilling = False
        if state.done:
            state.finish_s = clock.now
            self._retire(state, queue)
        return True

    def _retire(self, state: RequestState, queue: RequestQueue) -> None:
        if self.kv_pool is not None:
            self.kv_pool.release(state.rid)
        queue.retire(state)

    # --------------------------------------------- KV preemption / resume
    def _preempt(self, state: RequestState, clock: DecodeClock) -> None:
        nbytes = self.kv_pool.swap_out(state.rid)
        state.preempted = True
        self._swap_s += clock.charge_kv_swap(nbytes)

    def _resume_preempted(self, queue: RequestQueue, clock: DecodeClock) -> bool:
        """Swap preempted requests back in, oldest admission first, while
        their saved pages fit (a younger request never resumes past an
        older one)."""
        pool, resumed = self.kv_pool, False
        for state in queue.preempted():
            if not pool.can_alloc(pool.swapped_pages(state.rid)):
                break
            self._swap_s += clock.charge_kv_swap(pool.swap_in(state.rid))
            state.preempted = False
            resumed = True
        return resumed

    def _ensure_batch_pages(self, batch: List[RequestState], queue: RequestQueue,
                            clock: DecodeClock) -> List[RequestState]:
        """Every member gets the pages its next step writes into (a verify
        wave writes up to ``speculate`` slots), preempting one runnable
        request per exhaustion; each preemption shrinks the runnable set, so
        this ends."""
        pool = self.kv_pool
        for state in batch:
            if state.preempted:              # lost its pages to an older member
                continue
            while True:
                try:
                    pool.ensure(state.rid, int(state.pos[0]) + self.speculate)
                    break
                except PoolExhausted:
                    victim = preemption_victim(queue.runnable(), self.preempt_policy,
                                               clock.now)
                    self._preempt(victim, clock)
                    if victim is state:
                        break
        return [s for s in batch if not s.preempted]

    # -------------------------------------------------------- shadow peek
    def _ensure_peeks(self, runnable: List[RequestState]) -> None:
        """Step every runnable request lacking a peek as one composed shadow
        decode.  Alignment applies to each request's own shadow state first
        (at its own iteration index); the composed step is sliced back and
        cached until the request takes that step.  With ``speculate=S`` the
        composed shadow rolls out S steps: each request keeps S predictions,
        S snapshots (the rollback targets) and its S-1 drafts."""
        eng = self.engine
        if eng.shadow is None:
            return
        need = [s for s in runnable if s.pending is None]
        if not need:
            return
        aligned, flags = [], []
        for state in need:
            n = len(state.generated)
            at, ak = self.policy.align_token_at(n), self.policy.align_kv_at(n)
            sh = state.shadow_state
            if ak:
                sh = eng.shadow.align_kv_state(
                    sh, {"caches": eng._stack(state.cache_list), "pos": state.pos})
            aligned.append(dict(sh, token=state.token if at else sh["token"]))
            flags.append((at, ak))
        composed = concat_shadow_states(aligned)
        drafts, preds_steps, snapshots = eng.shadow.rollout_states(
            composed, composed["token"], self.speculate)
        for i, (state, (at, ak)) in enumerate(zip(need, flags)):
            p_i = [{li: p[i:i + 1] for li, p in preds.items()} for preds in preds_steps]
            s_i = [slice_shadow_state(st, i) for st in snapshots]
            state.pending = (p_i, s_i, at, ak, drafts[i:i + 1].clone())

    # --------------------------------------------------------------- run
    def start(self, requests: Sequence[Request], *, clock: Optional[DecodeClock] = None,
              cache_len: Optional[int] = None) -> None:
        """Set up a session without driving it: window, queue, clock and
        counters.  A cluster router passes each replica its own ``clock``
        (sharing one ``worker_free`` fleet timeline) and a cluster-wide
        ``cache_len``, which an empty request set requires; ``max_seq_len``
        and the KV pool's window apply after it."""
        eng = self.engine
        requests = list(requests)
        if cache_len is None:
            if not requests:
                raise ValueError("cache_len is required to start with an empty request set")
            cache_len = max(len(r.prompt) + r.max_new_tokens for r in requests) + 2
        cache_len = self.max_seq_len or cache_len
        if self.kv_pool is not None:
            self.kv_pool.reset()
            # one page-aligned window for every request (the extra tail
            # slots stay pos = -1, masked)
            cache_len = self.kv_pool.set_window(cache_len)
        self._cache_len = cache_len
        self._queue = RequestQueue(requests)
        self._clock = clock if clock is not None else self._new_clock()
        self._trace = Trace()
        self._steps: List[StepRecord] = []
        self._deferred = _AdmissionQueue(self.admit_policy)
        self._admit_seq = 0
        self._swap_s = 0.0
        self._step = 0

    def _new_clock(self, worker_free: Optional[Dict[int, float]] = None) -> DecodeClock:
        """The modelled clock this loop's engine is priced on; a cluster
        router passes the fleet's shared ``worker_free`` timelines."""
        eng = self.engine
        return DecodeClock(eng.cfg, eng.sched, self.profile,
                           shadow_scheme=(eng.shadow.scheme if eng.shadow else "int8"),
                           predictor=eng.predictor_kind, transport=eng.transport,
                           packed_compute=eng.packed_slots, worker_free=worker_free)

    def add_request(self, req: Request) -> None:
        """Enqueue a request into a started session; it is admitted when
        the clock passes its arrival, as an initial request is."""
        self._queue.add(req)

    def has_work(self) -> bool:
        """Whether the session has anything left to serve (what ``tick``
        checks first; a cluster router parks a replica without work)."""
        return not self._queue.all_done or bool(self._deferred)

    @property
    def clock(self) -> DecodeClock:
        return self._clock

    @property
    def finished(self) -> Dict[int, RequestState]:
        """The session's retired requests by id."""
        return self._queue.finished

    def tick(self) -> bool:
        """One iteration of the loop; False when nothing is left."""
        if not self.has_work():
            return False
        queue, clock = self._queue, self._clock
        deferred, cache_len = self._deferred, self._cache_len
        progressed = False
        if self.kv_pool is not None:
            progressed |= self._resume_preempted(queue, clock)
            while deferred and self._admission_fits(deferred.peek()):
                self._admit_or_retire(deferred.pop(), cache_len, clock, queue)
                progressed = True
        arrived = queue.pop_arrived(clock.now)
        if self.admit_policy == "priority":
            arrived.sort(key=lambda r: (-r.weight, r.arrival_s, r.rid))
        for req in arrived:
            # while an older request waits for pages, younger arrivals
            # queue behind it
            if deferred or not self._admission_fits(req):
                self.kv_pool.stats.deferred_admissions += 1
                deferred.push(req)
                continue
            self._admit_or_retire(req, cache_len, clock, queue)
            progressed = True
        if self.prefill_chunk:
            progressed |= self._advance_prefills(queue, clock, cache_len)
        runnable = queue.runnable()
        if not runnable:
            nxt = queue.next_arrival_s()
            if nxt is not None:
                clock.advance_to(nxt)        # idle until the next arrival
                return True
            if queue.all_done and not deferred:
                return False
            if progressed:
                return True                  # retirements freed pages; retry
            raise RuntimeError("KV pool deadlock: nothing runnable, resumable or "
                               "admittable (pool smaller than one request window?)")
        self._ensure_peeks(runnable)
        batch = self.composer.compose(runnable)
        if self.kv_pool is not None:
            batch = self._ensure_batch_pages(batch, queue, clock)
            if not batch:
                return True                  # preemptions freed pages
        self._decode_composed(batch, clock, queue.state_counts())
        for state in batch:
            if state.done:
                state.finish_s = clock.now
                self._retire(state, queue)
        self._step += 1
        return True

    def run(self, requests: Sequence[Request]) -> ServeResult:
        if not requests:
            return ServeResult(outputs={}, timings=ServingTimings([], [], [], []),
                               trace=Trace(), n_workers=self.engine.sched.n_workers)
        self.start(requests)
        while self.tick():
            pass
        return self.finish()

    def finish(self) -> ServeResult:
        """Close the session and build its ``ServeResult``; the engine's
        prefetch executor is joined (it starts again on a later fetch)."""
        eng, queue = self.engine, self._queue
        eng.close()
        prefetch_stats = (eng.prefetch_report()
                          if eng.prefetch is not None or eng.residency is not None else None)
        spec_stats = None
        if self.speculate > 1:
            per = {rid: {"waves": s.spec_waves, "committed": s.spec_committed,
                         "acceptance": (s.spec_committed / (s.spec_waves * self.speculate)
                                        if s.spec_waves else 0.0)}
                   for rid, s in sorted(queue.finished.items())}
            tw = sum(v["waves"] for v in per.values())
            tc = sum(v["committed"] for v in per.values())
            spec_stats = {"speculate": self.speculate, "waves": tw, "committed": tc,
                          "acceptance": tc / (tw * self.speculate) if tw else 0.0,
                          "per_request": per}
        kv_stats = None
        if self.kv_pool is not None:
            kv_stats = self.kv_pool.stats.as_dict()
            kv_stats.update(swap_s=self._swap_s, num_pages=self.kv_pool.num_pages,
                            page_tokens=self.kv_pool.page_tokens,
                            pool_bytes=self.kv_pool.pool_bytes())
        states = dict(sorted(queue.finished.items()))
        timings = ServingTimings(
            arrival_s=[s.request.arrival_s for s in states.values()],
            first_token_s=[s.first_token_s for s in states.values()],
            finish_s=[s.finish_s for s in states.values()],
            tokens=[len(s.generated) for s in states.values()],
            tenants=[s.request.tenant for s in states.values()],
            ttft_slo_s=[s.request.ttft_slo_s for s in states.values()],
            tpot_slo_s=[s.request.tpot_slo_s for s in states.values()])
        outputs = {rid: np.asarray(s.generated, np.int32) for rid, s in states.items()}
        return ServeResult(outputs=outputs, timings=timings, trace=self._trace,
                           steps=self._steps, states=states, n_workers=eng.sched.n_workers,
                           kv_stats=kv_stats, prefetch_stats=prefetch_stats,
                           spec_stats=spec_stats)

    # ------------------------------------------------------ composed step
    def _decode_composed(self, batch: List[RequestState], clock: DecodeClock,
                         queue_counts: Dict[str, int]) -> None:
        """One composed step over ``batch``: a one-token step, or under
        ``speculate=S`` a verify wave in which each request commits its own
        accepted prefix (capped by its remaining budget) and lands its
        shadow on the snapshot of that commit, so a rejection drops only
        that request's unconsumed drafts."""
        eng, S = self.engine, self.speculate
        pos = torch.cat([s.pos for s in batch])
        caches = concat_cache_lists([s.cache_list for s in batch])
        preds: Dict[int, np.ndarray] = {}
        at = ak = False
        if eng.shadow is not None:
            per_req = [wave_preds(s.pending[0]) for s in batch]
            for li in per_req[0]:
                preds[li] = np.concatenate([p[li] for p in per_req])
            at = any(s.pending[2] for s in batch)
            ak = any(s.pending[3] for s in batch)
        if S > 1:
            # column 0 the true last token, columns 1.. the drafts
            tokens = torch.cat([torch.cat([s.token[:, None], s.pending[4]], dim=1)
                                for s in batch])
            budget = [s.request.max_new_tokens - len(s.generated) for s in batch]
        else:
            tokens = torch.cat([s.token for s in batch])[:, None]
            budget = None
        # index == the engine step counter, as in generate()
        rec = TokenRecord(index=self._step, aligned_token=at, aligned_kv=ak)
        eng.slots.set_request_context([s.rid for s in batch])
        eng._sync()
        t0 = time.perf_counter()
        verified, commits, caches, pos = eng.decode_batch_spec(
            tokens, caches, pos, preds, self._step, rec, max_commit=budget)
        eng._sync()
        wall = time.perf_counter() - t0
        eng.slots.set_request_context(())
        start = clock.now                    # the decode itself moves no modelled time
        duration, stall = clock.step(rec)
        self._trace.records.append(rec)
        self._steps.append(StepRecord(
            step=self._step, request_ids=[s.rid for s in batch], record=rec, start_s=start,
            duration_s=duration, stall_s=stall, alive_workers=clock.alive_workers(),
            kv_pages_used=self.kv_pool.pages_used if self.kv_pool is not None else -1,
            queue_counts=queue_counts, wall_s=wall))
        out, commits = verified.cpu(), commits.cpu().tolist()
        sl = rec.spec_len                    # wave rows per request
        for i, state in enumerate(batch):
            ci = commits[i]
            state.token = verified[i, ci - 1:ci]
            state.cache_list = slice_cache_list(caches, i)
            state.pos = pos[i:i + 1]
            state.generated.extend(out[i, :ci].tolist())
            if state.pending is not None:
                # the snapshot that consumed exactly the accepted tokens
                state.shadow_state = state.pending[1][ci - 1]
            state.pending = None
            state.spec_waves += 1
            state.spec_committed += ci
            lo = i * sl                      # the request's wave rows; the accepted count
            state.last_experts = frozenset((lr.layer, int(e)) for lr in rec.layers
                                           for e in lr.true[lo:lo + ci].reshape(-1))
            sliced = self._slice_record(rec, lo, lo + ci)
            sliced.index = len(state.generated) - ci
            state.trace.records.append(sliced)

    @staticmethod
    def _slice_record(rec: TokenRecord, lo: int, hi: int) -> TokenRecord:
        """One request's view of a composed record: its accepted wave rows
        ``lo:hi`` (one row for a one-token step).
        Loads are shared across the batch, so it carries routing and recall
        only; load accounting lives in the composed trace and the event
        log."""
        out = TokenRecord(index=rec.index, aligned_token=rec.aligned_token,
                          aligned_kv=rec.aligned_kv, spec_len=hi - lo, committed=hi - lo)
        for lr in rec.layers:
            pred_i = None if lr.predicted is None else lr.predicted[lo:hi]
            true_i = lr.true[lo:hi]
            out.layers.append(LayerRecord(
                layer=lr.layer, moe_index=lr.moe_index, group=lr.group, predicted=pred_i,
                true=true_i,
                correct=recall_counts(pred_i, true_i) if pred_i is not None else 0,
                reloads=0, assignments=[],
                gates=None if lr.gates is None else lr.gates[lo:hi]))
        return out
