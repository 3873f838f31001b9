"""Host expert store + device expert slots (the "cacheless" memory model).

``ExpertStore`` holds every routed expert's FFN weights off the device,
packed once in the transport policy's wire format — in pinned host
memory when the model lives on the card (the paper's CPU-DRAM tier).
``WorkerSlots`` models the worker fleet: each worker owns one device
expert slot.  ``load`` really copies the packed shard to the device
(``.to(device, non_blocking=True)`` from pinned memory), so engine
compute consumes slot contents; eviction drops the slot — there is no
cache.  A slot holds one of two things: by default the full-width
weights, dequantized on arrival; with ``packed_resident=True`` a
``DeviceShard``, the wire codes and scales in their tile-aligned device
layout, which the CUDA kernel dequantizes in registers (same bits, 4-8x
fewer slot bytes at int8/nf4).  Every load is logged as a ``LoadEvent``
with its exact packed payload; ``bytes_moved`` sums them.

Stats (as in ``repro.core.store``): ``evictions`` counts every resident
displaced, by a capacity overwrite or an explicit ``evict``; ``hits``
counts loads that found their expert already resident.  Residency,
multi-slot profiles and worker failure wait (ROADMAP.md queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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
    """``n_workers`` single-expert device slots with load/evict accounting.
    ``packed_resident=True`` keeps each slot's shard in wire format
    (``ExpertStore.device_shard``) instead of dequantizing on arrival."""

    def __init__(self, store: ExpertStore, n_workers: int, packed_resident: bool = False):
        self.store = store
        self.n_workers = n_workers
        self.packed_resident = packed_resident
        # per worker: the resident (layer, expert) and its device weights
        self.resident: List[Optional[Tuple[int, int]]] = [None] * n_workers
        self._data: List[Optional[dict]] = [None] * n_workers
        self.events: List[LoadEvent] = []
        self.stats = {"loads": 0, "predicted_loads": 0, "reloads": 0,
                      "hits": 0, "evictions": 0}
        self.bytes_moved: int = 0
        self._request_context: Tuple[int, ...] = ()

    def set_request_context(self, request_ids) -> None:
        """Tag the following load events with the composed batch's request
        ids: one physical load then carries every request it serves, the
        amortization the serving report counts."""
        self._request_context = tuple(int(r) for r in request_ids)

    def load(self, token: int, layer: int, expert: int, worker: int,
             predicted: bool) -> bool:
        """Ship (layer, expert)'s packed shard into ``worker``'s slot,
        overwriting (evicting) whatever it held.  Returns ``True`` when
        the load shipped, ``False`` on a hit."""
        key = (layer, expert)
        if self.resident[worker] == key:
            self.stats["hits"] += 1
            return False
        if self.resident[worker] is not None:
            self.stats["evictions"] += 1
        self._data[worker] = None                 # free the old slot first
        self._data[worker] = (self.store.device_shard(layer, expert) if self.packed_resident
                              else self.store.unpack_shard(layer, expert))
        self.resident[worker] = key
        self.stats["loads"] += 1
        self.stats["predicted_loads" if predicted else "reloads"] += 1
        nbytes = self.store.packed_bytes(layer, expert)
        self.bytes_moved += nbytes
        self.events.append(LoadEvent(token, layer, expert, worker, predicted, nbytes,
                                     self.store.scheme_of(layer, expert),
                                     requests=self._request_context))
        return True

    def slot(self, worker: int, layer: int, expert: int) -> dict:
        if self.resident[worker] != (layer, expert):
            raise RuntimeError(f"expert {expert} of layer {layer} is not "
                               f"resident on worker {worker}")
        return self._data[worker]

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
        key = (layer, expert)
        return next((w for w in range(self.n_workers) if self.resident[w] == key),
                    None)

    def evict(self, worker: int) -> None:
        """Prompt eviction after the expert computation (cacheless rule)."""
        if self.resident[worker] is not None:
            self.stats["evictions"] += 1
        self.resident[worker] = None
        self._data[worker] = None

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
        quantity: one slot plus the transient packed buffer."""
        return self.slot_unit_bytes() + self.transient_packed_bytes()
