"""Host expert store + device expert slots (the "cacheless" memory model).

``ExpertStore`` holds every routed expert's FFN weights off the device,
packed once in the transport policy's wire format — in pinned host
memory when the model lives on the card (the paper's CPU-DRAM tier).
``WorkerSlots`` models the worker fleet: each worker owns one device
expert slot, or ``capacity`` of them under a fleet profile
(``repro_torch.fleet``).  ``load`` really copies the packed shard to the
device (``.to(device, non_blocking=True)`` from pinned memory), so engine
compute consumes slot contents; eviction drops the slot — there is no
cache.  A slot holds one of two things: by default the full-width
weights, dequantized on arrival; with ``packed_resident=True`` a
``DeviceShard``, the wire codes and scales in their tile-aligned device
layout, which the CUDA kernel dequantizes in registers (same bits, 4-8x
fewer slot bytes at int8/nf4).  Every load is logged as a ``LoadEvent``
with its exact packed payload; ``bytes_moved`` sums them.

Stats (as in ``repro.core.store``): ``evictions`` counts every resident
displaced on a live worker, by a capacity overwrite or an explicit
``evict``; ``hits`` counts loads that found their expert already
resident; ``failures`` / ``recoveries`` count workers lost and rejoined,
and ``failure_drops`` the residents a failure lost (not evictions).

Opportunistic residency (``repro_torch.core.prefetch``): ``release``
marks a worker's residents *released* instead of evicting them; they
keep their slots, and a later load of the same expert re-hits in place
(no event, zero bytes).  Only a full worker taking a new load evicts, the
residency policy naming the victim among released residents.  Its
counters live in ``residency_stats``, beside ``stats``.  A load may
commit a payload fetched earlier (``FetchedShard``) instead of fetching
inline.  A failed worker (``fail``) is dead until ``recover``: it holds
nothing, takes no load and serves no wave.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.config import MOE_FF, ModelConfig
from repro_torch.models.transformer import layer_params
from repro_torch.quant.transport import (EXPERT_WEIGHT_NAMES, PackedWeight,
                                         device_layout, resolve_policy, tileable)


@dataclass
class LoadEvent:
    token: int              # decoding iteration (serving: global step index)
    layer: int              # absolute layer index
    expert: int
    worker: int
    predicted: bool         # True: loaded on a prediction; False: reload
    bytes: int              # packed transport payload that crossed the link
    scheme: str = "fp32"    # transport precision this load shipped at
    requests: Tuple[int, ...] = ()   # serving: request ids sharing this load
    profile: Optional[object] = None  # fleet: the worker's WorkerProfile


@dataclass(frozen=True)
class DeviceShard:
    """One expert's packed-resident slot contents: the wire codes and
    scales in the tile-aligned device layout the packed kernel reads.
    ``scheme == "fp32"`` marks the fallback for shapes or dtypes with no
    such layout: its parts are the full-width weights dequantized on
    arrival (``repro.core.store.DeviceShard``)."""
    scheme: str
    parts: Dict[str, Tuple[torch.Tensor, ...]]   # weight name -> device-layout parts
    nbytes: int                                  # resident device bytes of this shard


def _slot_tensors(data) -> List[torch.Tensor]:
    """The device tensors of one slot's contents (a weight dict or a
    ``DeviceShard``)."""
    if isinstance(data, DeviceShard):
        return [t for ps in data.parts.values() for t in ps]
    return list(data.values())


@dataclass
class FetchedShard:
    """One expert fetched ahead of its commit: the slot contents that
    ``unpack_shard`` or ``device_shard`` returned and, on the card, the
    event recorded on the side stream after its copies and dequantize."""
    data: object
    ready: Optional[torch.cuda.Event] = None

    def commit(self, device: torch.device):
        """The contents, safe to read on ``device``'s current stream: that
        stream waits for the event (on the device, the host does not
        block), and the caching allocator learns that the stream uses the
        tensors, so freeing the slot cannot hand their memory back to the
        side stream while a kernel still reads it."""
        if self.ready is not None:
            main = torch.cuda.current_stream(device)
            main.wait_event(self.ready)
            for t in _slot_tensors(self.data):
                t.record_stream(main)
        return self.data


def _pack_to_host(codec, w: torch.Tensor) -> PackedWeight:
    """Pack ``w`` where it lives and keep the wire parts on the host:
    pinned when they come from the card, so a load back is an
    asynchronous DMA."""
    pw = codec.pack(w)
    parts = []
    for p in pw.parts:
        host = torch.empty(p.shape, dtype=p.dtype, pin_memory=p.is_cuda)
        host.copy_(p)
        parts.append(host)
    return PackedWeight(pw.scheme, pw.shape, pw.dtype, tuple(parts))


class ExpertStore:
    """Per-(layer, expert) wire-format shards of the expert FFN weights,
    packed once under ``policy`` (a ``PrecisionPolicy``, a scheme name
    or ``None`` = fp32).  Shards are quantized where the parameters live
    and kept on the host; the device they load onto is the parameters'."""

    def __init__(self, cfg: ModelConfig, params, policy=None):
        self.cfg = cfg
        self.policy = resolve_policy(policy)
        self.device = params["embed"]["table"].device
        self.moe_layers: List[int] = [
            i for i, (_, ff) in enumerate(cfg.layer_kinds()) if ff == MOE_FF]
        self._packed: Dict[Tuple[int, int], Dict[str, PackedWeight]] = {}
        self._params = params         # the full-width weights, for get_host (no copy)
        self.expert_bytes = 0         # full-width bytes of one expert
        with torch.no_grad():
            for li in self.moe_layers:
                ff = layer_params(cfg, params, li)["ff"]
                for e in range(cfg.num_experts):
                    codec = self.policy.codec_for(li, e)
                    self._packed[(li, e)] = {
                        n: _pack_to_host(codec, ff[n][e]) for n in EXPERT_WEIGHT_NAMES}
                self.expert_bytes = sum(ff[n][0].numel() * ff[n][0].element_size()
                                        for n in EXPERT_WEIGHT_NAMES)
        # tile-aligned layouts of the pinned wire parts (packed-resident
        # slots), built on first use
        self._device_host: Dict[Tuple[int, int], Dict[str, Tuple[torch.Tensor, ...]]] = {}

    def get_host(self, layer: int, expert: int) -> Dict[str, torch.Tensor]:
        """One routed expert's full-width weights on the host (copies when
        the parameters live on the card); ``KeyError`` for a layer without
        experts or an expert the router cannot pick."""
        if (layer, expert) not in self._packed:
            raise KeyError((layer, expert))
        ff = layer_params(self.cfg, self._params, layer)["ff"]
        return {n: ff[n][expert].cpu() for n in EXPERT_WEIGHT_NAMES}

    def get_packed(self, layer: int, expert: int) -> Dict[str, PackedWeight]:
        """The cached wire-format shard (packed once at construction)."""
        return self._packed[(layer, expert)]

    def scheme_of(self, layer: int, expert: int) -> str:
        return self.policy.scheme_for(layer, expert)

    def packed_bytes(self, layer: int, expert: int) -> int:
        """Exact transport payload of one expert under the policy."""
        return sum(pw.nbytes for pw in self._packed[(layer, expert)].values())

    def unpack_shard(self, layer: int, expert: int) -> Dict[str, torch.Tensor]:
        """Ship the packed shard to the device and dequantize it there."""
        codec = self.policy.codec_for(layer, expert)
        out = {}
        for n, pw in self._packed[(layer, expert)].items():
            parts = tuple(p.to(self.device, non_blocking=True) for p in pw.parts)
            out[n] = codec.unpack(pw, parts)
        return out

    def resident_tileable(self, layer: int, expert: int) -> bool:
        """Whether this expert can stay in wire format in its slot: every
        weight has the tile-aligned layout AND the deployment dtype is
        fp32, since the kernel dequantizes to fp32 and a narrower dtype
        needs the round-cast of dequantize-on-arrival to keep its bits."""
        return all(tileable(pw.scheme, pw.shape) and pw.dtype == torch.float32
                   for pw in self._packed[(layer, expert)].values())

    def resident_nbytes(self, layer: int, expert: int) -> int:
        """Device bytes this expert holds in a packed-resident slot: the
        exact packed payload when tileable (the layout is a reshape of
        the wire bytes), else the full-width fallback."""
        if self.resident_tileable(layer, expert):
            return self.packed_bytes(layer, expert)
        return self.expert_bytes

    def device_shard(self, layer: int, expert: int) -> DeviceShard:
        """Packed-resident twin of :meth:`unpack_shard`: ship the wire
        bytes in their tile-aligned layout (a view of the pinned parts,
        made once) and keep them as they land, with no dequantization.
        Untileable experts fall back to dequantize-on-arrival, tagged
        ``scheme="fp32"``."""
        key = (layer, expert)
        if not self.resident_tileable(layer, expert):
            full = self.unpack_shard(layer, expert)
            return DeviceShard("fp32", {n: (full[n],) for n in full}, self.expert_bytes)
        # two prefetch threads may both build an entry: equal views, either wins
        if key not in self._device_host:
            self._device_host[key] = {n: device_layout(pw)
                                      for n, pw in self._packed[key].items()}
        parts = {n: tuple(p.to(self.device, non_blocking=True) for p in ps)
                 for n, ps in self._device_host[key].items()}
        return DeviceShard(self.scheme_of(layer, expert), parts,
                           self.packed_bytes(layer, expert))

    def router_weights(self, params) -> Dict[int, torch.Tensor]:
        """Routers live on the main node (non-expert parameters)."""
        return {li: layer_params(self.cfg, params, li)["ff"]["router"]
                for li in self.moe_layers}


class WorkerSlots:
    """``n_workers`` sets of device expert slots with load, evict and
    failure accounting.  ``profiles`` (``repro_torch.fleet.WorkerProfile``)
    give each worker its slot capacity and tag its load events; without
    them every worker has the paper's one slot.  ``packed_resident=True``
    keeps each slot's shard in wire format (``ExpertStore.device_shard``)
    instead of dequantizing on arrival.  ``residency`` (a
    ``ResidencyPolicy``) turns ``release`` into opportunistic residency;
    without one it evicts (cacheless)."""

    def __init__(self, store: ExpertStore, n_workers: int, packed_resident: bool = False,
                 residency=None, profiles: Optional[Sequence] = None):
        self.store = store
        self.n_workers = n_workers
        self.packed_resident = packed_resident
        self.residency = residency
        self.profiles = list(profiles) if profiles else None
        if self.profiles is not None and len(self.profiles) != n_workers:
            raise ValueError("one profile per worker required")
        self.capacity: List[int] = ([p.capacity for p in self.profiles] if self.profiles
                                    else [1] * n_workers)
        self.alive: List[bool] = [True] * n_workers
        # per worker: its occupied slots' keys, oldest first (a full worker
        # overwrites the oldest unless the residency policy names a released
        # victim), their device contents, and the released ones (kept, free
        # for a re-hit or displacement)
        self._occupied: List[List[Tuple[int, int]]] = [[] for _ in range(n_workers)]
        self._data: List[Dict[Tuple[int, int], object]] = [{} for _ in range(n_workers)]
        self._released: List[set] = [set() for _ in range(n_workers)]
        self.events: List[LoadEvent] = []
        self.stats = {"loads": 0, "predicted_loads": 0, "reloads": 0, "hits": 0,
                      "evictions": 0, "failures": 0, "recoveries": 0, "failure_drops": 0}
        self.bytes_moved: int = 0
        # ``rehit_bytes_saved``: the packed payload re-hits did not move;
        # ``evicted_bytes``: the slot bytes every eviction freed
        self.residency_stats = {"released": 0, "rehits": 0, "rehit_bytes_saved": 0,
                                "displaced": 0, "evicted_bytes": 0}
        self._request_context: Tuple[int, ...] = ()

    @property
    def resident(self) -> List[Optional[object]]:
        """Per worker: ``None`` when empty, the ``(layer, expert)`` when one
        expert is resident, else a tuple of them, oldest first."""
        return [None if not occ else occ[0] if len(occ) == 1 else tuple(occ)
                for occ in self._occupied]

    def set_request_context(self, request_ids) -> None:
        """Tag the following load events with the composed batch's request
        ids: one physical load then carries every request it serves, the
        amortization the serving report counts."""
        self._request_context = tuple(int(r) for r in request_ids)

    def load(self, token: int, layer: int, expert: int, worker: int,
             predicted: bool, payload: Optional[FetchedShard] = None) -> bool:
        """Ship (layer, expert)'s packed shard into a slot of ``worker``.  A
        full worker evicts a resident: the residency policy's victim among
        its released residents when there is one, else the oldest (the
        cacheless overwrite); either is an eviction.  ``payload`` is a
        fetch made earlier by the prefetch executor: the commit uses it
        instead of fetching inline and accounts the same packed bytes.
        Returns ``True`` when the load shipped, ``False`` on a hit or a
        re-hit.  A dead worker takes no load (``RuntimeError``)."""
        if not self.alive[worker]:
            raise RuntimeError(f"load onto dead worker {worker}")
        key = (layer, expert)
        if key in self._data[worker]:
            if key in self._released[worker]:
                self._reactivate(worker, key)      # residency re-hit
            else:
                self.stats["hits"] += 1
            return False
        if len(self._occupied[worker]) >= self.capacity[worker]:
            victim = None
            if self.residency is not None:
                released = [k for k in self._occupied[worker] if k in self._released[worker]]
                if released:
                    victim = self.residency.victim(released)
                    self.residency_stats["displaced"] += 1
            if victim is None:
                victim = self._occupied[worker][0]
            self._evict_key(worker, victim)
        if payload is not None:
            data = payload.commit(self.store.device)
        elif self.packed_resident:
            data = self.store.device_shard(layer, expert)
        else:
            data = self.store.unpack_shard(layer, expert)
        self._data[worker][key] = data
        self._occupied[worker].append(key)
        self.stats["loads"] += 1
        self.stats["predicted_loads" if predicted else "reloads"] += 1
        nbytes = self.store.packed_bytes(layer, expert)
        self.bytes_moved += nbytes
        if self.residency is not None:
            self.residency.note(key)
        self.events.append(LoadEvent(token, layer, expert, worker, predicted, nbytes,
                                     self.store.scheme_of(layer, expert),
                                     requests=self._request_context,
                                     profile=self.profiles[worker] if self.profiles else None))
        return True

    def _drop(self, worker: int, key: Tuple[int, int]) -> None:
        """Free ``key``'s slot on ``worker``: the one path by which slot
        tensors are released, for an eviction and for a failure alike.  A
        tensor filled on the prefetch side stream was recorded on the
        compute stream at commit (``FetchedShard.commit``), so the caching
        allocator does not hand its memory back while a queued kernel
        still reads it."""
        if self.residency is not None:
            self.residency.forget(key)
        self._occupied[worker].remove(key)
        self._released[worker].discard(key)
        del self._data[worker][key]

    def _evict_key(self, worker: int, key: Tuple[int, int]) -> None:
        self.stats["evictions"] += 1
        self.residency_stats["evicted_bytes"] += self._resident_nbytes(key)
        self._drop(worker, key)

    # ---------------------------------------------------------- residency
    def _reactivate(self, worker: int, key: Tuple[int, int]) -> None:
        """A released resident is used again: un-release it in place.  The
        re-hit saved exactly the packed payload a reload would move."""
        self._released[worker].discard(key)
        self.residency_stats["rehits"] += 1
        self.residency_stats["rehit_bytes_saved"] += self.store.packed_bytes(*key)
        if self.residency is not None:
            self.residency.note(key)

    def reactivate(self, layer: int, expert: int) -> Optional[int]:
        """Claim a resident copy of (layer, expert) anywhere in the alive
        fleet: a re-hit when it was released, a plain claim when it is
        active.  Returns the worker, or ``None`` when nothing holds it."""
        w = self.worker_with(layer, expert)
        if w is not None:
            self.claim_resident(layer, expert, w)
        return w

    def claim_resident(self, layer: int, expert: int, worker: int) -> bool:
        """Wave-time claim of an expert resident on ``worker``: un-release
        it when released (a reload avoided).  Returns whether that
        re-hit happened."""
        if self.is_released(worker, layer, expert):
            self._reactivate(worker, (layer, expert))
            return True
        return False

    def is_released(self, worker: int, layer: int, expert: int) -> bool:
        return (layer, expert) in self._released[worker]

    def release(self, worker: int) -> None:
        """Opportunistic residency: mark the worker's residents released;
        they keep their slots until displaced, and a matching load
        re-hits.  Without a policy this is ``evict`` (cacheless)."""
        if self.residency is None:
            self.evict(worker)
            return
        newly = [k for k in self._occupied[worker] if k not in self._released[worker]]
        self.residency_stats["released"] += len(newly)
        self._released[worker].update(newly)

    def observe_gates(self, layer: int, true, gates) -> None:
        """Feed the router's realized routing to the residency policy (gate
        popularity), accumulated per key and credited in ascending key
        order."""
        if self.residency is None:
            return
        mass: Dict[Tuple[int, int], float] = {}
        t, g = np.asarray(true), np.asarray(gates)
        for b in range(t.shape[0]):
            for j in range(t.shape[1]):
                key = (layer, int(t[b, j]))
                mass[key] = mass.get(key, 0.0) + abs(float(g[b, j]))
        for key in sorted(mass):
            self.residency.credit(key, mass[key])

    def _resident_nbytes(self, key: Tuple[int, int]) -> int:
        """Device bytes one resident occupies: full width, or the packed
        payload in packed-resident mode."""
        if self.packed_resident:
            return self.store.resident_nbytes(*key)
        return self.store.expert_bytes

    def resident_slot_bytes(self, worker: int) -> int:
        """Device bytes ``worker``'s occupied slots hold (active or
        released)."""
        return sum(self._resident_nbytes(k) for k in self._occupied[worker])

    def slot(self, worker: int, layer: int, expert: int):
        """The device contents of (layer, expert) on ``worker``, which must
        be alive and hold it: the slot is selected by key, so a multi-slot
        worker gives the right expert."""
        if not self.alive[worker]:
            raise RuntimeError(f"worker {worker} is dead")
        data = self._data[worker].get((layer, expert))
        if data is None:
            raise RuntimeError(f"expert {expert} of layer {layer} is not "
                               f"resident on worker {worker}")
        return data

    def gather_stack(self, layer: int, wave: Dict[int, int]) -> Tuple[List[int], Dict]:
        """Stack one wave's resident expert weights for the grouped FFN:
        ``wave`` maps expert -> serving worker; returns ``(experts,
        {w_gate/w_up: (E_wave, d, f), w_down: (E_wave, f, d)})`` in
        ascending expert order.  Reads through :meth:`slot`, so the
        computation consumes genuine slot contents, never the store."""
        experts = sorted(wave)
        shards = [self.slot(wave[e], layer, e) for e in experts]
        return experts, {name: torch.stack([s[name] for s in shards])
                         for name in EXPERT_WEIGHT_NAMES}

    def gather_stack_packed(self, layer: int, wave: Dict[int, int]):
        """Packed-resident twin of :meth:`gather_stack`: stack each wave
        expert's device-layout parts.  A tiered policy can mix schemes in
        one wave, and untileable experts are full width, so the wave
        splits into one group per scheme, in order of first appearance.
        Returns ``(experts, [(scheme, expert_ids, parts), ...])``, where
        ``parts`` maps each weight name to its stacked part tuple."""
        experts = sorted(wave)
        shards = [self.slot(wave[e], layer, e) for e in experts]
        groups = []
        for scheme in dict.fromkeys(s.scheme for s in shards):
            sel = [(e, s) for e, s in zip(experts, shards) if s.scheme == scheme]
            parts = {name: tuple(torch.stack([s.parts[name][j] for _, s in sel])
                                 for j in range(len(sel[0][1].parts[name])))
                     for name in EXPERT_WEIGHT_NAMES}
            groups.append((scheme, [e for e, _ in sel], parts))
        return experts, groups

    def worker_with(self, layer: int, expert: int) -> Optional[int]:
        """The first alive worker holding (layer, expert), or ``None``."""
        key = (layer, expert)
        return next((w for w in range(self.n_workers)
                     if self.alive[w] and key in self._data[w]), None)

    def evict(self, worker: int) -> None:
        """Prompt eviction after the expert computation (cacheless rule):
        drop everything resident on ``worker``."""
        for key in list(self._occupied[worker]):
            self._evict_key(worker, key)

    # ------------------------------------------------------------ failures
    def fail(self, worker: int) -> None:
        """The worker's device is gone: mark it dead and lose its residents
        (``failure_drops``, not evictions); what it held reloads elsewhere
        on a miss."""
        if not self.alive[worker]:
            return
        self.alive[worker] = False
        self.stats["failures"] += 1
        self.stats["failure_drops"] += len(self._occupied[worker])
        for key in list(self._occupied[worker]):
            self._drop(worker, key)

    def recover(self, worker: int) -> None:
        """The worker rejoins with empty slots."""
        if self.alive[worker]:
            return
        self.alive[worker] = True
        self.stats["recoveries"] += 1

    # -------------------------------------------------------------- memory
    def transient_packed_bytes(self) -> int:
        """Largest packed shard live on a worker beside its full-width
        slot while it dequantizes on arrival.  fp32 shards alias, and
        packed-resident tileable experts never dequantize, so neither
        counts."""
        store = self.store
        return max((store.packed_bytes(li, e) for li in store.moe_layers
                    for e in range(store.cfg.num_experts)
                    if store.scheme_of(li, e) != "fp32"
                    and not (self.packed_resident and store.resident_tileable(li, e))),
                   default=0)

    def slot_unit_bytes(self) -> int:
        """Device bytes one slot must provision: a full-width expert, or in
        packed-resident mode the largest resident shard."""
        if not self.packed_resident:
            return self.store.expert_bytes
        store = self.store
        return max((store.resident_nbytes(li, e) for li in store.moe_layers
                    for e in range(store.cfg.num_experts)), default=store.expert_bytes)

    def device_bytes_per_worker(self) -> int:
        """Peak device bytes per worker, the paper's "<1 GB per worker"
        quantity: the slots of the fleet's largest capacity plus the
        transient packed buffer."""
        return self.slot_unit_bytes() * max(self.capacity) + self.transient_packed_bytes()
