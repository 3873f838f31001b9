"""Async expert prefetch + opportunistic residency (``repro.core.prefetch``).

Every load splits into a *fetch* and a *commit*:

  * the **fetch** — ``ExpertStore.unpack_shard`` (or ``device_shard`` for
    packed-resident slots) — is a pure function of ``(layer, expert)``:
    ship the packed shard, dequantize on arrival.  It may run on any
    thread, in any order, at any time between prediction and use.  On
    the card it runs on a side CUDA stream and records an event after
    its copies and its dequantize, so transfers overlap the main
    stream's compute.
  * the **commit** — worker choice, slot insert, the ``LoadEvent`` log
    and ``bytes_moved`` — happens on the main thread at the synchronous
    engine's program points (``WorkerSlots.load``).  It consumes a
    fetched payload when one is ready, making the main stream wait on
    the payload's event (a device-side wait, no host synchronize), and
    fetches inline when none is.

Scheduling state changes only at commit points, so tokens, the event
log and byte accounting are identical under every executor and every
completion order: an executor moves WHEN bytes are fetched, never what
computes or what is recorded.  The same holds under fleet faults: a
fetched payload names no worker, and its commit places it on a worker
alive at that moment, where the synchronous engine would load it, so no
payload is ever committed onto a dead worker.  ``ChaosExecutor`` drives adversarial
schedules from one ``random.Random(seed)``, the same schedule as the JAX
package's for the same seed and call sequence.

``PrefetchExecutor`` is the SEP-peek-driven load queue: the engine
enqueues the predicted experts of every MoE layer within the peek
horizon as soon as predictions exist, and joins per layer at the wave
boundary.  ``LRUResidency`` / ``GateStatsResidency`` pick the victim
among *released* residents (``WorkerSlots.release``) when a full worker
needs its slot.  Everything here but the fetch is host-side Python.
"""
from __future__ import annotations

import functools
import random
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .predictor import layers_within_horizon
from .store import FetchedShard

Key = Tuple[int, int, int]           # (step, layer, expert)


# ------------------------------------------------------------ executors
class SyncExecutor:
    """Runs submitted fetches inline at collect time: the async plumbing
    with no concurrency, the baseline every other executor equals."""

    kind = "sync"

    def __init__(self) -> None:
        self._pending: "OrderedDict[Key, Callable[[], object]]" = OrderedDict()

    def submit(self, key: Key, fn: Callable[[], object]) -> None:
        self._pending.setdefault(key, fn)

    def collect(self, keys: Sequence[Key]) -> Dict[Key, object]:
        out = {}
        for k in keys:
            fn = self._pending.pop(k, None)
            if fn is not None:
                out[k] = fn()
        return out

    def discard(self, keys: Sequence[Key]) -> int:
        return sum(1 for k in keys if self._pending.pop(k, None) is not None)

    def close(self) -> None:
        self._pending.clear()


class ThreadedExecutor:
    """Background fetches on a thread pool, started at the first submit.
    ``collect`` joins the demanded futures (the wave boundary); the rest
    keep transferring while the main thread computes.  A fetch that
    raises fails the ``collect`` that joins it; one that raises after
    being discarded fails the next ``collect`` or ``close``."""

    kind = "thread"

    def __init__(self, max_workers: int = 4) -> None:
        self.max_workers = max_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futs: Dict[Key, object] = {}
        self._failures: List[BaseException] = []

    def submit(self, key: Key, fn: Callable[[], object]) -> None:
        if key not in self._futs:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.max_workers,
                                                thread_name_prefix="prefetch")
            self._futs[key] = self._pool.submit(fn)

    def _raise_failures(self) -> None:
        if self._failures:
            raise self._failures[0]

    def _note_failure(self, fut) -> None:
        if not fut.cancelled() and fut.exception() is not None:
            self._failures.append(fut.exception())

    def collect(self, keys: Sequence[Key]) -> Dict[Key, object]:
        self._raise_failures()
        out = {}
        for k in keys:
            fut = self._futs.pop(k, None)
            if fut is not None:
                out[k] = fut.result()
        return out

    def discard(self, keys: Sequence[Key]) -> int:
        n = 0
        for k in keys:
            fut = self._futs.pop(k, None)
            if fut is not None:
                if not fut.cancel():        # running or done: its result is dropped
                    fut.add_done_callback(self._note_failure)
                n += 1
        return n

    def close(self) -> None:
        """Join the pool; a later submit starts a new one."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._futs.clear()
        self._raise_failures()


class ChaosExecutor:
    """Deterministic adversarial executor for the chaos suite.

    At every ``collect`` it replays a seeded schedule over everything
    pending: a fresh permutation of completions; non-demanded tasks may
    complete *early*; demanded tasks may be *dropped* (failed transfer)
    or *deferred* (late: still pending, completed or discarded later),
    both of which send the commit to an inline fetch.  One
    ``random.Random(seed)`` drives it, so a seed replays its schedule,
    journaled in ``self.log``."""

    kind = "chaos"

    def __init__(self, seed: int, p_run_ahead: float = 0.5,
                 p_drop: float = 0.15, p_defer: float = 0.25) -> None:
        self.seed = seed
        self.rng = random.Random(seed)
        self.p_run_ahead = p_run_ahead
        self.p_drop = p_drop
        self.p_defer = p_defer
        self._pending: "OrderedDict[Key, Callable[[], object]]" = OrderedDict()
        self._done: Dict[Key, object] = {}
        self.log: List[Tuple[str, Key]] = []

    def submit(self, key: Key, fn: Callable[[], object]) -> None:
        if key not in self._pending and key not in self._done:
            self._pending[key] = fn
            self.log.append(("submit", key))

    def collect(self, keys: Sequence[Key]) -> Dict[Key, object]:
        demanded = set(keys)
        order = list(self._pending)
        self.rng.shuffle(order)                     # permuted completions
        out: Dict[Key, object] = {}
        for k in order:
            if k in demanded:
                r = self.rng.random()
                if r < self.p_drop:                 # failed transfer
                    self._pending.pop(k)
                    self.log.append(("drop", k))
                elif r < self.p_drop + self.p_defer:
                    self.log.append(("defer", k))   # late: inline now, completes later
                else:
                    out[k] = self._pending.pop(k)()
                    self.log.append(("run", k))
            elif self.rng.random() < self.p_run_ahead:
                self._done[k] = self._pending.pop(k)()   # early completion
                self.log.append(("early", k))
        for k in keys:                              # completed-early wins
            if k not in out and k in self._done:
                out[k] = self._done.pop(k)
                self.log.append(("join-early", k))
        return out

    def discard(self, keys: Sequence[Key]) -> int:
        n = 0
        for k in keys:
            if (self._pending.pop(k, None) is not None
                    or self._done.pop(k, None) is not None):
                self.log.append(("discard", k))
                n += 1
        return n

    def close(self) -> None:
        self._pending.clear()
        self._done.clear()


def make_executor(spec):
    """``None`` | ``'sync'`` | ``'thread'`` | an executor instance."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "sync":
            return SyncExecutor()
        if spec == "thread":
            return ThreadedExecutor()
        raise ValueError(f"unknown prefetch executor {spec!r}")
    if not (hasattr(spec, "submit") and hasattr(spec, "collect")):
        raise TypeError("prefetch executor needs submit()/collect()")
    return spec


# ----------------------------------------------------------- load queue
class PrefetchExecutor:
    """The SEP-peek-driven load queue.

    ``enqueue`` submits one worker-agnostic fetch per predicted (step,
    layer, expert) within the peek horizon; ``collect`` joins a layer's
    demanded experts at its wave boundary (a demanded expert with no
    payload loads inline at commit); ``fetch_now`` fans a wave's reload
    set out through the executor; ``finish_token`` retires fetches that
    never became loads (mispredictions and re-hits).  ``packed`` fetches
    ``DeviceShard``s for packed-resident slots.

    On the card every fetch runs on one side stream (set by the fetch
    itself, so executor threads need nothing of their own) and returns a
    ``FetchedShard`` carrying the event the commit waits on."""

    def __init__(self, store, executor, *, horizon: int = 0, packed: bool = False) -> None:
        self.store = store
        self.executor = executor
        self.horizon = horizon
        self.packed = packed
        device = getattr(store, "device", None)
        self.side = (torch.cuda.Stream(device=device)
                     if device is not None and device.type == "cuda" else None)
        self._enqueued: set = set()
        self.stats = {"submitted": 0, "demand_fetches": 0, "prefetched": 0,
                      "inline": 0, "stale": 0}

    def _fetch(self, layer: int, expert: int) -> FetchedShard:
        fetch = self.store.device_shard if self.packed else self.store.unpack_shard
        if self.side is None:
            return FetchedShard(fetch(layer, expert))
        with torch.cuda.stream(self.side):          # per thread: set here, in the fetch
            data = fetch(layer, expert)
            ready = torch.cuda.Event()
            ready.record(self.side)
        return FetchedShard(data, ready)

    def _fetch_fn(self, layer: int, expert: int):
        return functools.partial(self._fetch, layer, expert)

    def enqueue(self, step: int, current_layer: int, pending: Mapping[int, object],
                skip: Optional[Callable[[int, int], bool]] = None) -> None:
        """Submit fetches for every predicted expert of every MoE layer
        within the horizon; ``skip`` (residency) leaves out experts that
        are resident somewhere and will re-hit."""
        for tgt in layers_within_horizon(list(pending), current_layer, self.horizon):
            for e in dict.fromkeys(int(x) for x in pending[tgt].reshape(-1)):
                key = (step, tgt, e)
                if key in self._enqueued:
                    continue
                if skip is not None and skip(tgt, e):
                    continue
                self._enqueued.add(key)
                self.stats["submitted"] += 1
                self.executor.submit(key, self._fetch_fn(tgt, e))

    def collect(self, step: int, layer: int, experts: Sequence[int]) -> Dict[int, object]:
        """Join the layer's demanded experts: ``{expert: payload}`` for the
        fetches that completed."""
        keys = [(step, layer, int(e)) for e in experts]
        queued = [k for k in keys if k in self._enqueued]
        got = self.executor.collect(queued)
        for k in queued:
            self._enqueued.discard(k)
        self.stats["prefetched"] += len(got)
        self.stats["inline"] += len(keys) - len(got)
        return {k[2]: v for k, v in got.items()}

    def fetch_now(self, step: int, layer: int, experts: Sequence[int]) -> Dict[int, object]:
        """Demand-fetch a wave's reload set through the executor, so a
        threaded executor transfers the wave's misses together."""
        for e in experts:
            key = (step, layer, int(e))
            if key not in self._enqueued:
                self._enqueued.add(key)
                self.stats["demand_fetches"] += 1
            self.executor.submit(key, self._fetch_fn(layer, int(e)))
        return self.collect(step, layer, experts)

    def finish_token(self, step: int) -> None:
        """Token boundary: retire fetches that never became loads; their
        payloads are dropped unread."""
        stale = [k for k in self._enqueued if k[0] <= step]
        self.executor.discard(stale)
        for k in stale:
            self._enqueued.discard(k)
        self.stats["stale"] += len(stale)

    def close(self) -> None:
        """Join the executor and let the side stream drain."""
        self.executor.close()
        if self.side is not None:
            self.side.synchronize()


# ---------------------------------------------------- residency policies
class ResidencyPolicy:
    """Victim selection among released residents when a full worker needs
    its slot.  Keys are ``(layer, expert)``.  Policies are deterministic,
    since victim choices feed the byte accounting every executor must
    reproduce."""

    name = "base"

    def note(self, key: Tuple[int, int]) -> None:
        """The expert was loaded or re-hit (a use)."""

    def credit(self, key: Tuple[int, int], mass: float) -> None:
        """The gate routed probability mass through the expert."""
        self.note(key)

    def victim(self, candidates: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
        raise NotImplementedError

    def forget(self, key: Tuple[int, int]) -> None:
        """The expert was displaced or evicted."""


class LRUResidency(ResidencyPolicy):
    """Evict the least recently used released resident; recency is a
    logical clock bumped on every load, re-hit and gate credit."""

    name = "lru"

    def __init__(self) -> None:
        self._clock = 0
        self._last: Dict[Tuple[int, int], int] = {}

    def note(self, key) -> None:
        self._last[key] = self._clock
        self._clock += 1

    def victim(self, candidates):
        return min(candidates, key=lambda k: (self._last.get(k, -1), k))

    def forget(self, key) -> None:
        self._last.pop(key, None)


class GateStatsResidency(ResidencyPolicy):
    """Evict the released resident with the least accumulated gate mass;
    popularity survives displacement, recency then key break ties."""

    name = "gate"

    def __init__(self) -> None:
        self._clock = 0
        self._mass: Dict[Tuple[int, int], float] = {}
        self._last: Dict[Tuple[int, int], int] = {}

    def note(self, key) -> None:
        self._last[key] = self._clock
        self._clock += 1

    def credit(self, key, mass: float) -> None:
        self._mass[key] = self._mass.get(key, 0.0) + float(mass)
        self.note(key)

    def victim(self, candidates):
        return min(candidates, key=lambda k: (self._mass.get(k, 0.0),
                                              self._last.get(k, -1), k))

    def forget(self, key) -> None:
        self._last.pop(key, None)          # popularity survives


def resolve_residency(spec) -> Optional[ResidencyPolicy]:
    """``None`` | ``'lru'`` | ``'gate'`` | a policy instance."""
    if spec is None:
        return None
    if isinstance(spec, ResidencyPolicy):
        return spec
    if spec == "lru":
        return LRUResidency()
    if spec == "gate":
        return GateStatsResidency()
    raise ValueError(f"unknown residency policy {spec!r}")
