"""Paged KV-cache pool: KV memory as an explicit per-node budget.

The dense serving path gives every admitted request a full window of KV
at prefill.  This module replaces those buffers with one fixed pool of
``num_pages`` pages of ``page_tokens`` slots each, as tensors on the
engine's device (``repro.serve.kvpool``):

  * ``KVPool``: per-attention-layer page tensors, a free list and one page
    table per request.  Pages are allocated as a request decodes past a
    page boundary and returned when it retires.  A preempted request's
    pages are swapped out to host memory byte for byte and restored on
    resume, so preemption is scheduling, never arithmetic.
  * ``PagedRequestCache`` / ``PagedCacheBatch``: stand-ins for the
    engine's per-layer ``cache_list``.  Indexing ``caches[li]`` of an
    attention layer gathers the members' pages into the dense
    ``(B, W, ...)`` view ``attn_decode`` reads; assigning ``caches[li] =
    new`` scatters the pages back.  Logical pages past a request's table
    read a permanent zero null page (``pos = -1``), which is what the
    dense buffer's untouched tail holds, so the gathered view equals the
    dense cache it replaces.  A Mamba layer's ``{"h", "conv"}`` state is
    O(1) per request and stays dense in the handle's ``states``; a
    preempted request's pages are swapped, its states stay where they are.

Budget: one page holds ``page_tokens`` slots of one layer's K and V plus
the ``pos`` lane; a page set spans every attention layer, and the pool's
device footprint is ``num_pages * page_set_bytes``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.transformer import tree_concat, tree_map


class PoolExhausted(RuntimeError):
    """An allocation the free list cannot satisfy (the serving loop turns
    it into deferral or preemption)."""


@dataclass
class KVPoolStats:
    allocated_pages: int = 0
    released_pages: int = 0
    preemptions: int = 0
    resumes: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    peak_pages_used: int = 0
    deferred_admissions: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class KVPool:
    """Fixed-size paged KV storage for every attention layer.

    Physical page ``num_pages`` (one past the end) is the null page:
    always zero K/V with ``pos = -1``, never on the free list, never
    written; unallocated logical pages gather from it."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_tokens: int, device="cuda"):
        if num_pages < 1 or page_tokens < 1:
            raise ValueError("num_pages and page_tokens must be >= 1")
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.device = resolve_device(device)
        self.attn_layers: List[int] = [i for i, (mixer, _) in enumerate(cfg.layer_kinds())
                                       if mixer == ATTN]
        if not self.attn_layers:
            raise ValueError("KVPool needs at least one attention layer (pure-SSM "
                             "states are O(1) and stay dense)")
        dt = getattr(torch, cfg.dtype)
        nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        n = num_pages + 1                      # + the null page
        self.k: Dict[int, torch.Tensor] = {
            li: torch.zeros((n, page_tokens, nkv, hd), dtype=dt, device=self.device)
            for li in self.attn_layers}
        self.v: Dict[int, torch.Tensor] = {
            li: torch.zeros((n, page_tokens, nkv, hd), dtype=dt, device=self.device)
            for li in self.attn_layers}
        self.pos: Dict[int, torch.Tensor] = {
            li: torch.full((n, page_tokens), -1, dtype=torch.int32, device=self.device)
            for li in self.attn_layers}
        kv_lane = 2 * page_tokens * nkv * hd * dt.itemsize
        pos_lane = page_tokens * 4
        # a page set spans every attention layer: logical page j of a
        # request lives at the same physical index in every layer
        self.page_set_bytes = (kv_lane + pos_lane) * len(self.attn_layers)
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}
        self.swapped: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
        self.stats = KVPoolStats()
        self.window_pages = 0                  # serving window, fixed per run

    def reset(self) -> None:
        """A fresh run: drop every table, swap and counter (pages are
        zeroed again when allocated)."""
        self.free = list(range(self.num_pages - 1, -1, -1))
        self.tables = {}
        self.swapped = {}
        self.stats = KVPoolStats()

    # ------------------------------------------------------------ geometry
    def pages_for(self, n_slots: int) -> int:
        """Pages covering KV slots ``[0, n_slots)``."""
        return max(0, -(-n_slots // self.page_tokens))

    def set_window(self, cache_len: int) -> int:
        """Fix the serving window; returns it rounded up to whole pages."""
        self.window_pages = self.pages_for(cache_len)
        if self.window_pages > self.num_pages:
            raise ValueError(f"pool of {self.num_pages} pages cannot hold even one "
                             f"request's window of {self.window_pages} pages: no "
                             "admission order could make progress")
        return self.window_pages * self.page_tokens

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def pages_used(self) -> int:
        return self.num_pages - len(self.free)

    def pool_bytes(self) -> int:
        """Device footprint of the whole pool (the KV budget)."""
        return self.num_pages * self.page_set_bytes

    def table_pages(self, rid: int) -> int:
        return len(self.tables.get(rid, ()))

    def growth_need(self, rid: int, n_slots: int) -> int:
        """New pages ``rid`` needs to cover ``n_slots`` slots."""
        return max(0, self.pages_for(n_slots) - self.table_pages(rid))

    def can_alloc(self, n_new: int) -> bool:
        return n_new <= len(self.free)

    # ---------------------------------------------------------- allocation
    def _take_pages(self, n: int) -> List[int]:
        """Pop ``n`` pages off the free list and zero them (a fresh page
        reads like the dense buffer's untouched slots: zero K/V,
        ``pos = -1``)."""
        pages = [self.free.pop() for _ in range(n)]
        if pages:
            idx = torch.tensor(pages, device=self.device)
            for li in self.attn_layers:
                self.k[li][idx] = 0
                self.v[li][idx] = 0
                self.pos[li][idx] = -1
        return pages

    def ensure(self, rid: int, n_slots: int) -> int:
        """Grow ``rid``'s table to cover ``n_slots`` slots; returns the pages
        added.  Raises ``PoolExhausted``, allocating nothing, when the free
        list cannot supply them all."""
        need = self.growth_need(rid, n_slots)
        if need > len(self.free):
            raise PoolExhausted(f"request {rid} needs {need} page(s), "
                                f"{len(self.free)} free")
        if need:
            self.tables.setdefault(rid, []).extend(self._take_pages(need))
            self.stats.allocated_pages += need
            self.stats.peak_pages_used = max(self.stats.peak_pages_used, self.pages_used)
        return need

    def release(self, rid: int) -> None:
        """Return every page ``rid`` holds (request retired)."""
        pages = self.tables.pop(rid, [])
        self.free.extend(reversed(pages))
        self.stats.released_pages += len(pages)
        self.swapped.pop(rid, None)

    # ---------------------------------------------------- preempt / resume
    def swap_out(self, rid: int) -> int:
        """Preemption: copy ``rid``'s pages to host memory byte for byte and
        free them.  Returns the bytes that crossed."""
        pages = self.tables.pop(rid, [])
        if not pages:
            return 0
        idx = torch.tensor(pages, device=self.device)
        self.swapped[rid] = {li: {"k": self.k[li][idx].cpu(), "v": self.v[li][idx].cpu(),
                                  "pos": self.pos[li][idx].cpu()}
                             for li in self.attn_layers}
        self.free.extend(reversed(pages))
        nbytes = len(pages) * self.page_set_bytes
        self.stats.preemptions += 1
        self.stats.swap_out_bytes += nbytes
        return nbytes

    def swapped_pages(self, rid: int) -> int:
        saved = self.swapped.get(rid)
        if not saved:
            return 0
        return saved[self.attn_layers[0]]["k"].shape[0]

    def swap_in(self, rid: int) -> int:
        """Resume: reallocate pages and restore the saved bytes.  Returns
        the bytes that crossed."""
        saved = self.swapped.get(rid)
        if saved is None:
            raise KeyError(f"request {rid} has no swapped pages")
        n = saved[self.attn_layers[0]]["k"].shape[0]
        if n > len(self.free):
            raise PoolExhausted(f"resume of request {rid} needs {n} page(s), "
                                f"{len(self.free)} free")
        pages = [self.free.pop() for _ in range(n)]
        idx = torch.tensor(pages, device=self.device)
        for li in self.attn_layers:
            self.k[li][idx] = saved[li]["k"].to(self.device)
            self.v[li][idx] = saved[li]["v"].to(self.device)
            self.pos[li][idx] = saved[li]["pos"].to(self.device)
        del self.swapped[rid]
        self.tables[rid] = pages
        nbytes = n * self.page_set_bytes
        self.stats.resumes += 1
        self.stats.swap_in_bytes += nbytes
        self.stats.allocated_pages += n
        self.stats.peak_pages_used = max(self.stats.peak_pages_used, self.pages_used)
        return nbytes

    # ------------------------------------------------------ gather/scatter
    def _padded_table(self, rid: int) -> List[int]:
        table = self.tables.get(rid, [])
        return (table + [self.num_pages] * (self.window_pages - len(table)))[:self.window_pages]

    def gather_layer(self, li: int, rids: Sequence[int]) -> dict:
        """Dense ``(B, W, ...)`` view of layer ``li`` for ``rids``, equal to
        the dense buffers it replaces (unallocated pages read the null
        page)."""
        pt, wp = self.page_tokens, self.window_pages
        idx = torch.tensor([self._padded_table(r) for r in rids], device=self.device)
        b = len(rids)
        k, v, pos = self.k[li][idx], self.v[li][idx], self.pos[li][idx]
        return {"k": k.reshape(b, wp * pt, *k.shape[3:]),
                "v": v.reshape(b, wp * pt, *v.shape[3:]),
                "pos": pos.reshape(b, wp * pt)}

    def scatter_layer(self, li: int, rids: Sequence[int], dense: dict) -> None:
        """Write an updated dense view back into each request's allocated
        pages (the null-page tail is never written: the loop makes sure
        the decoded slot is covered before each step)."""
        pt = self.page_tokens
        for i, rid in enumerate(rids):
            table = self.tables.get(rid)
            if not table:
                raise PoolExhausted(f"scatter for request {rid} with no pages "
                                    "(preempted?)")
            n = len(table)
            idx = torch.tensor(table, device=self.device)
            k, v = dense["k"][i, :n * pt], dense["v"][i, :n * pt]
            self.k[li][idx] = k.reshape(n, pt, *k.shape[1:])
            self.v[li][idx] = v.reshape(n, pt, *v.shape[1:])
            self.pos[li][idx] = dense["pos"][i, :n * pt].reshape(n, pt)

    # ------------------------------------------------------------ adoption
    def adopt(self, rid: int, cache_list: List[dict], prompt_len: int) -> "PagedRequestCache":
        """Move a freshly prefilled request's KV (batch axis 1) into pool
        pages and return the paged stand-in the serving loop carries; the
        other layers' states stay dense in the handle."""
        self.ensure(rid, prompt_len)
        handle = PagedRequestCache(self, rid, len(cache_list))
        for li, cache in enumerate(cache_list):
            if li in self.k:
                self.scatter_layer(li, [rid], cache)
            else:
                handle.states[li] = cache
        return handle


class PagedRequestCache:
    """One request's per-layer cache stand-in: attention layers live in the
    pool (through the request's page table), anything else (Mamba state)
    stays dense in ``states``.  It keeps the ``caches[li]`` /
    ``caches[li] = x`` protocol of a dense cache list, so the engine's
    decode path does not see paging."""

    def __init__(self, pool: KVPool, rid: int, n_layers: int):
        self.pool = pool
        self.rid = rid
        self.n_layers = n_layers
        self.states: Dict[int, dict] = {}

    def __len__(self) -> int:
        return self.n_layers

    def __getitem__(self, li: int):
        if li in self.pool.k:
            return self.pool.gather_layer(li, [self.rid])
        return self.states[li]

    def __setitem__(self, li: int, value) -> None:
        if li in self.pool.k:
            self.pool.scatter_layer(li, [self.rid], value)
        else:
            self.states[li] = value

    @staticmethod
    def compose(handles: Sequence["PagedRequestCache"]) -> "PagedCacheBatch":
        """The batch view ``core.engine.concat_cache_lists`` builds."""
        return PagedCacheBatch(list(handles))


class PagedCacheBatch:
    """Composed-batch view over member handles: gathers and scatters the
    attention layers through the members' page tables, and concatenates
    and splits the dense states of the others.  ``member(i)`` returns the
    handle; the step's scatter already committed its pages and states."""

    def __init__(self, members: List[PagedRequestCache]):
        if not members:
            raise ValueError("empty paged batch")
        self.members = members
        self.pool = members[0].pool
        self.rids = [m.rid for m in members]
        self.n_layers = members[0].n_layers

    def __len__(self) -> int:
        return self.n_layers

    def __getitem__(self, li: int):
        if li in self.pool.k:
            return self.pool.gather_layer(li, self.rids)
        per = [m.states[li] for m in self.members]
        return per[0] if len(per) == 1 else tree_concat(per)

    def __setitem__(self, li: int, value) -> None:
        if li in self.pool.k:
            self.pool.scatter_layer(li, self.rids, value)
            return
        # each member's state gets storage of its own, so a member that is
        # preempted does not keep the whole composed batch's state alive
        for i, m in enumerate(self.members):
            m.states[li] = (value if len(self.members) == 1
                            else tree_map(lambda a: a[i:i + 1].clone(), value))

    def member(self, i: int) -> PagedRequestCache:
        return self.members[i]


def dense_cache_footprint(cfg: ModelConfig, cache_len: int, n_requests: int) -> int:
    """Bytes the dense serving path pins for ``n_requests`` live requests at
    window ``cache_len``, the baseline a pool budget is sized against.
    Attention KV only, as in the reference: Mamba states are not counted."""
    itemsize = getattr(torch, cfg.dtype).itemsize
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n_attn = sum(1 for mixer, _ in cfg.layer_kinds() if mixer == ATTN)
    per_layer = 2 * cache_len * nkv * hd * itemsize + cache_len * 4
    return n_requests * n_attn * per_layer
