"""Host expert store + device expert slots (the "cacheless" memory model).

``ExpertStore`` holds every routed expert's FFN weights off the device,
packed once in the transport policy's wire format — in pinned host
memory when the model lives on the card (the paper's CPU-DRAM tier).
``WorkerSlots`` models the worker fleet: each worker owns one device
expert slot.  ``load`` really copies the packed shard to the device
(``.to(device, non_blocking=True)`` from pinned memory) and dequantizes
it there, so engine compute consumes slot contents; eviction drops the
slot — there is no cache.  Every load is logged as a ``LoadEvent`` with
its exact packed payload; ``bytes_moved`` sums them.

Stats (as in ``repro.core.store``): ``evictions`` counts every resident
displaced, by a capacity overwrite or an explicit ``evict``; ``hits``
counts loads that found their expert already resident.  Residency,
packed-resident slots, multi-slot profiles and worker failure wait
(ROADMAP.md queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import MOE_FF, ModelConfig
from repro_torch.models.transformer import layer_params
from repro_torch.quant.transport import (EXPERT_WEIGHT_NAMES, PackedWeight,
                                         resolve_policy)


@dataclass
class LoadEvent:
    token: int              # decoding iteration
    layer: int              # absolute layer index
    expert: int
    worker: int
    predicted: bool         # True: loaded on a prediction; False: reload
    bytes: int              # packed transport payload that crossed the link
    scheme: str = "fp32"    # transport precision this load shipped at


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

    def router_weights(self, params) -> Dict[int, torch.Tensor]:
        """Routers live on the main node (non-expert parameters)."""
        return {li: layer_params(self.cfg, params, li)["ff"]["router"]
                for li in self.moe_layers}


class WorkerSlots:
    """``n_workers`` single-expert device slots with load/evict accounting."""

    def __init__(self, store: ExpertStore, n_workers: int):
        self.store = store
        self.n_workers = n_workers
        # per worker: the resident (layer, expert) and its device weights
        self.resident: List[Optional[Tuple[int, int]]] = [None] * n_workers
        self._data: List[Optional[dict]] = [None] * n_workers
        self.events: List[LoadEvent] = []
        self.stats = {"loads": 0, "predicted_loads": 0, "reloads": 0,
                      "hits": 0, "evictions": 0}
        self.bytes_moved: int = 0

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
        self._data[worker] = self.store.unpack_shard(layer, expert)
        self.resident[worker] = key
        self.stats["loads"] += 1
        self.stats["predicted_loads" if predicted else "reloads"] += 1
        nbytes = self.store.packed_bytes(layer, expert)
        self.bytes_moved += nbytes
        self.events.append(LoadEvent(token, layer, expert, worker, predicted,
                                     nbytes, self.store.scheme_of(layer, expert)))
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

    def device_bytes_per_worker(self) -> int:
        """Peak device bytes per worker: one full-width expert slot plus,
        for a non-fp32 policy, the packed shard live while it dequantizes."""
        store = self.store
        transient = max((store.packed_bytes(li, e) for li in store.moe_layers
                         for e in range(store.cfg.num_experts)
                         if store.scheme_of(li, e) != "fp32"), default=0)
        return store.expert_bytes + transient
