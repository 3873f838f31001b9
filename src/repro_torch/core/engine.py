"""ODMoEEngine — cacheless on-demand MoE decoding (the paper's system).

The engine runs the full-precision model layer by layer as the main node
does, while a quantized SEP shadow decodes in lockstep and supplies
whole-token expert predictions.  Expert weights live in the host
``ExpertStore``; each worker owns one device slot into which predicted
experts are loaded just in time and from which they are evicted right
after their layer computes (no cache).  Mispredictions trigger reloads,
the paper's fallback path.  ``generate`` decodes one fixed batch end to
end (the paper's single-stream experiment); ``prefill_request`` +
``decode_batch`` are its steps, and the request-level API the
continuous-batching serving loop (``repro_torch.serve``) is built on:
per-request caches stay apart between iterations and join with
``concat_cache_lists`` for each composed step, so requests join and
retire between steps while sharing one worker fleet and one store.

Correctness invariant: greedy tokens equal ``greedy_generate(...,
transport=policy)`` on the same weights.  Decode-time expert compute
reads only worker-slot contents, one ``grouped_topk_contrib`` call per
wave on the wave's stacked slot weights, and the per-(row, rank)
contributions reduce through the shared fixed-order ``combine_topk`` —
the functions the reference dispatch calls.  Per-pair values do not
depend on which experts share a call (see ``csrc/moe_ffn_common.cuh``),
so wave partitioning never changes a token.  With ``packed_slots=True``
the slots keep wire-format codes and scales and each wave runs one
``grouped_topk_contrib_packed`` call per resident scheme; in-register
dequantization is exact, so the tokens are the same.

``prefetch`` (``"sync"``, ``"thread"`` or an executor such as
``ChaosExecutor``) fetches the predicted experts ahead of their layer
on a side CUDA stream, and ``residency`` (``"lru"`` or ``"gate"``)
releases a layer's experts instead of evicting them, so a later load of
the same expert re-hits (``repro_torch.core.prefetch``).  Neither
changes a token; prefetch changes no record either, residency only
removes loads.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md
queue 1): speculative decoding (``decode_batch_spec`` runs one-token
waves only), fleet profiles and faults, compute-vs-ship, and the
per-pair ``loop`` wave oracle.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.moe_gemm import (combine_topk, grouped_topk_contrib,
                                          grouped_topk_contrib_packed)
from repro_torch.models.api import prefill
from repro_torch.models.blocks import block_decode
from repro_torch.models.config import ATTN, MOE_FF, NO_FF, ModelConfig
from repro_torch.models.layers import apply_norm, embed
from repro_torch.models.moe import route
from repro_torch.models.transformer import (decode_logits, layer_params, tree_concat,
                                            tree_leaves, tree_map, tree_stack)
from repro_torch.quant.quantize import shadow_nbytes
from repro_torch.quant.transport import resolve_policy, transport_params
from repro_torch.rows import row_blocks

from .align import AlignmentPolicy
from .prefetch import PrefetchExecutor, make_executor, resolve_residency
from .predictor import (FrequencyPredictor, GateExtrapolator, RandomPredictor,
                        SEPShadow, moe_layer_indices, recall_counts)
from .schedule import GroupSchedule
from .store import ExpertStore, WorkerSlots


@dataclass
class LayerRecord:
    layer: int
    moe_index: int
    group: int
    predicted: Optional[np.ndarray]      # (B,k) or None
    true: np.ndarray                     # (B,k)
    correct: int                         # sum_b |pred_b ∩ true_b|
    reloads: int
    assignments: List[Tuple[int, int]]   # (expert, worker)
    waves: Optional[List[List[Tuple[int, int]]]] = None  # per-wave subsets
    touched: Tuple[int, ...] = ()        # every worker that took a load
    gates: Optional[np.ndarray] = None   # (B,k) gate weights
    # under residency: the predicted experts that physically shipped
    # (re-hits excluded), which the timing model prices; None otherwise
    shipped: Optional[Tuple[int, ...]] = None
    rehits: int = 0                      # residency re-hits this layer


@dataclass
class TokenRecord:
    index: int
    aligned_token: bool
    aligned_kv: bool
    layers: List[LayerRecord] = field(default_factory=list)
    seconds: float = 0.0                 # measured wall time of this step
    # positions a wave carried per request and tokens it committed (1 and
    # B for the one-token step; the timing model prices the wave width)
    spec_len: int = 1
    committed: int = 1


@dataclass
class Trace:
    records: List[TokenRecord] = field(default_factory=list)

    def recall(self) -> Optional[float]:
        """Overall recall, Eq. (3), over the layers that had a
        prediction; ``None`` when nothing was predicted."""
        num = den = 0
        for tr in self.records:
            for lr in tr.layers:
                if lr.predicted is not None:
                    num += lr.correct
                    den += lr.true.size
        return num / den if den else None

    def recall_per_token(self) -> List[Optional[float]]:
        """recall(n), Eq. (2); ``None`` for tokens with no prediction."""
        out = []
        for tr in self.records:
            num = sum(lr.correct for lr in tr.layers if lr.predicted is not None)
            den = sum(lr.true.size for lr in tr.layers if lr.predicted is not None)
            out.append(num / den if den else None)
        return out

    def reload_fraction(self) -> float:
        loads = reloads = 0
        for tr in self.records:
            for lr in tr.layers:
                reloads += lr.reloads
                loads += len(lr.assignments)
        return reloads / loads if loads else 0.0


def wave_preds(preds_steps: List[Dict[int, np.ndarray]]) -> Dict[int, np.ndarray]:
    """Fold per-step predictions into wave-row order: {layer -> (B*S, k)}
    with row ``b*S + s`` = request ``b``, wave position ``s``
    (``repro.core.specdecode.wave_preds``)."""
    out: Dict[int, np.ndarray] = {}
    for li in preds_steps[0]:
        stacked = np.stack([np.asarray(p[li]) for p in preds_steps], axis=1)   # (B, S, k)
        out[li] = stacked.reshape(-1, stacked.shape[-1])
    return out


# ------------------------------------------------------- batch membership
def concat_cache_lists(cache_lists: Sequence):
    """Join per-request per-layer caches along the batch axis.

    Dense cache lists concatenate their KV tensors and Mamba states
    (every request was prefilled with the same window).  Paged handles
    (``repro_torch.serve.kvpool.PagedRequestCache``) compose into a batch
    view instead: nothing is copied here, each layer gathers from the pool
    through the members' page tables when the step indexes it and
    scatters back on assignment.  An empty batch raises ``ValueError``;
    mixing paged and dense members raises ``TypeError``."""
    if not cache_lists:
        raise ValueError("cannot compose an empty batch of caches")
    first = cache_lists[0]
    paged = [hasattr(c, "compose") for c in cache_lists]
    if any(paged) and not all(paged):
        raise TypeError("cannot mix paged and dense caches in one composed batch")
    if paged[0]:
        return first.compose(cache_lists)
    if len(cache_lists) == 1:
        return list(first)
    return [tree_concat(list(per_layer)) for per_layer in zip(*cache_lists)]


def slice_cache_list(cache_list, i: int):
    """Request ``i`` of a composed cache list (batch of 1), in storage of
    its own: a view would keep the whole composed batch alive for as long
    as the request is stored.  A paged batch returns the member's handle:
    the step's scatter already committed its pages."""
    if hasattr(cache_list, "member"):
        return cache_list.member(i)
    return [tree_map(lambda a: a[i:i + 1].clone(memory_format=torch.contiguous_format), c)
            for c in cache_list]


def _not_ported(feature: str, item: str):
    raise NotImplementedError(f"{feature} is not ported yet (ROADMAP.md "
                              f"queue 1, {item})")


class ODMoEEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_workers: int = 8,
                 group_size: int = 0, predictor: str = "sep",
                 shadow_scheme: str = "int8", lookahead: int = 4, seed: int = 0,
                 transport=None, device="cuda", speculate: int = 1,
                 prefetch=None, residency=None, peek_horizon: int = 0,
                 packed_slots: bool = False, store=None, profiles=None, faults=None,
                 compute_vs_ship=None, wave_compute: str = "grouped"):
        if cfg.is_encoder_decoder:
            raise ValueError("engine drives decoder-only models")
        if speculate < 1:
            raise ValueError("speculate must be >= 1")
        if (prefetch is not None or residency is not None) and wave_compute != "grouped":
            raise ValueError("prefetch/residency require the grouped wave path")
        if packed_slots and wave_compute != "grouped":
            # the loop oracle reads full-width slot dicts
            raise ValueError("packed_slots requires the grouped wave path")
        if speculate > 1:
            if any(mixer != ATTN for mixer, _ in cfg.layer_kinds()):
                raise ValueError("speculate > 1 requires all-attention mixers (SSM "
                                 "states cannot fork per wave row)")
            _not_ported("speculate > 1", "core/specdecode.py")
        if profiles is not None or faults is not None:
            _not_ported("fleet profiles / faults", "fleet/")
        if compute_vs_ship is not None:
            _not_ported("compute_vs_ship", "fleet/ and serve/")
        if wave_compute != "grouped":
            _not_ported(f"wave_compute={wave_compute!r}", "core/engine.py loop oracle")
        self.predictor_kind = predictor
        self.device = resolve_device(device)
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"params live on {params['embed']['table'].device}, "
                             f"the engine runs on {self.device}")
        # True: slots keep the wire-format codes and scales and the packed
        # kernel dequantizes in registers (same bits, fewer slot bytes)
        self.packed_slots = packed_slots
        self.cfg = cfg
        # ``transport`` fixes each expert's wire precision.  Slots receive the
        # store's round-tripped experts and prefill runs on the same
        # round-tripped tree the reference decodes with, so tokens match
        # greedy_generate(transport=...).
        self.transport = resolve_policy(transport)
        self.moe_layers = moe_layer_indices(cfg)
        g = group_size or max(cfg.top_k, 1)
        if n_workers % g:
            n_workers = g * max(1, n_workers // g)
        self.sched = GroupSchedule(n_workers, g)
        # a prebuilt ``store`` (engines over the same parameters may share
        # one) must carry this engine's transport policy, or slot contents
        # would diverge from its compute params
        if store is not None:
            if store.policy is not self.transport and \
                    store.policy.describe() != self.transport.describe():
                raise ValueError("shared store transport policy differs from the engine's")
            self.store = store
        else:
            self.store = ExpertStore(cfg, params, policy=self.transport)
        self.params = (params if self.transport.trivial
                       else transport_params(cfg, params, self.transport,
                                             packed=self.store.get_packed))
        # opportunistic residency and async prefetch; None keeps the
        # cacheless synchronous engine (release evicts, loads fetch inline)
        self.residency = resolve_residency(residency)
        self.slots = WorkerSlots(self.store, n_workers, packed_resident=packed_slots,
                                 residency=self.residency)
        executor = make_executor(prefetch)
        self.prefetch: Optional[PrefetchExecutor] = (
            None if executor is None
            else PrefetchExecutor(self.store, executor, horizon=peek_horizon,
                                  packed=packed_slots))
        self._layer_params = [layer_params(cfg, self.params, li)
                              for li in range(cfg.num_layers)]
        self.shadow: Optional[SEPShadow] = None
        self.fly: Optional[GateExtrapolator] = None
        self.freq: Optional[FrequencyPredictor] = None
        self.rand: Optional[RandomPredictor] = None
        if predictor == "sep":
            self.shadow = SEPShadow(cfg, params, shadow_scheme)
        elif predictor in ("nextgate", "multigate"):
            la = 1 if predictor == "nextgate" else lookahead
            self.fly = GateExtrapolator(cfg, self.store.router_weights(params), la)
        elif predictor == "freq":
            self.freq = FrequencyPredictor(cfg)
        elif predictor == "random":
            self.rand = RandomPredictor(cfg, seed)
        elif predictor != "none":
            raise ValueError(f"unknown predictor {predictor!r}")

    # -------------------------------------------------------------- caches
    def _unstack(self, caches):
        pattern, _ = self.cfg.pattern()
        return [tree_map(lambda a: a[li // len(pattern)], caches[li % len(pattern)])
                for li in range(self.cfg.num_layers)]

    def _stack(self, cache_list):
        pattern, reps = self.cfg.pattern()
        return tuple(tree_stack([cache_list[r * len(pattern) + pos] for r in range(reps)])
                     for pos in range(len(pattern)))

    # ----------------------------------------------------------- requests
    def prefill_request(self, batch, max_cache_len: int, *, kv_pool=None,
                        rid: Optional[int] = None):
        """Prefill on the main node (the full model, as the reference's
        engine does).  Returns ``(first_token (B,), cache_list, pos (B,))``.

        With ``kv_pool`` (a ``repro_torch.serve.kvpool.KVPool``) the
        prefilled KV moves into pool pages and ``cache_list`` is the paged
        stand-in: one request (B=1) keyed by ``rid``, whose prompt pages
        the caller has made sure fit."""
        logits, state = prefill(self.cfg, self.params, batch, max_cache_len)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        cache_list = self._unstack(state["caches"])
        if kv_pool is not None:
            if batch["tokens"].shape[0] != 1 or rid is None:
                raise ValueError("paged prefill adopts one request (B=1) with its "
                                 "request id")
            cache_list = kv_pool.adopt(rid, cache_list, batch["tokens"].shape[1])
        return token, cache_list, state["pos"]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ generate
    @torch.no_grad()
    def generate(self, batch, num_tokens: int,
                 policy: AlignmentPolicy = AlignmentPolicy(1, 1)):
        """End-to-end greedy generation, one token per step.

        The KV cache is sized like ``greedy_generate``'s (prompt +
        tokens), so engine and reference attend over identical shapes and
        no reduction can change order between them."""
        batch = {"tokens": batch["tokens"].to(self.device)}
        max_cache_len = batch["tokens"].shape[1] + num_tokens
        main_token, cache_list, pos = self.prefill_request(batch, max_cache_len)
        if self.shadow is not None:
            self.shadow.reset(batch, max_cache_len)
        tokens_out = [main_token]
        trace = Trace()
        for n in range(1, num_tokens):
            t0 = time.perf_counter()
            preds: Dict[int, np.ndarray] = {}
            at = ak = False
            if self.shadow is not None:
                at = policy.align_token_at(n)
                ak = policy.align_kv_at(n)
                if ak:
                    self.shadow.align_kv({"caches": self._stack(cache_list),
                                          "pos": pos})
                preds = self.shadow.step(main_token if at else self.shadow.token)
            rec = TokenRecord(index=n, aligned_token=at, aligned_kv=ak)
            main_token, cache_list, pos = self.decode_batch(
                main_token, cache_list, pos, preds, n, rec)
            self._sync()
            rec.seconds = time.perf_counter() - t0
            tokens_out.append(main_token)
            trace.records.append(rec)
        return torch.stack(tokens_out, dim=1), trace

    # ---------------------------------------------------------- one token
    @torch.no_grad()
    def decode_batch(self, token, cache_list, pos, preds, step_idx,
                     rec: TokenRecord):
        """One decode iteration.  ``preds`` maps layer -> (B,k) predicted
        experts for this iteration.  Non-MoE layers and each MoE layer's
        mixer + router run on the main node; expert FFNs run from worker
        slots in ``_serve_and_compute``."""
        cfg = self.cfg
        x = embed(token[:, None], self.params["embed"])
        pending: Dict[int, np.ndarray] = dict(preds)
        # SEP predictions cover the whole token: queue their fetches now, so
        # the transfers overlap everything before each layer's waves
        if self.prefetch is not None and pending:
            self.prefetch.enqueue(step_idx, 0, pending, skip=self._resident_skip())
        moe_i = -1
        for li, kinds in enumerate(cfg.layer_kinds()):
            lp = self._layer_params[li]
            if kinds[1] != MOE_FF:
                x, cache_list[li], _ = block_decode(cfg, lp, kinds, x,
                                                    cache_list[li], pos)
                continue
            moe_i += 1
            x, cache_list[li], _ = block_decode(cfg, lp, (kinds[0], NO_FF), x,
                                                cache_list[li], pos)
            # the router input in fixed row blocks, as block_decode computes it
            h = row_blocks(lambda t: apply_norm(cfg, t, lp["norm2"]), x)[:, 0]
            topk_idx, topk_gate = route(cfg, lp["ff"], h)
            x = self._moe_bookkeeping(step_idx, li, moe_i, pending,
                                      topk_idx.cpu().numpy(), h, topk_gate, x, rec)
        if self.prefetch is not None:
            self.prefetch.finish_token(step_idx)
        logits = decode_logits(cfg, self.params, x)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache_list, pos + 1

    @torch.no_grad()
    def decode_batch_spec(self, tokens, cache_list, pos, preds, step_idx,
                          rec: TokenRecord):
        """A draft-verify-accept wave for the (possibly composed) batch,
        ``tokens`` (B, S).  Only S = 1 is ported: it is the one-token step,
        and returns ``(tokens (B, 1), commits (B,) of ones, cache_list,
        pos + 1)`` with ``rec.spec_len, rec.committed = 1, B``.  S > 1
        raises (ROADMAP.md queue 1, item 3)."""
        b, s_w = tokens.shape
        if s_w != 1:
            _not_ported("speculative verify waves (S > 1)", "core/specdecode.py")
        tok, cache_list, pos = self.decode_batch(tokens[:, 0], cache_list, pos, preds,
                                                 step_idx, rec)
        rec.spec_len, rec.committed = 1, b
        return (tok[:, None], torch.ones((b,), dtype=torch.int32, device=tok.device),
                cache_list, pos)

    def _resident_skip(self):
        """Prefetch skip predicate under residency: an expert still resident
        somewhere will re-hit, so fetching it is waste.  ``None`` without
        residency (no resident outlives its layer)."""
        if self.residency is None:
            return None
        return lambda layer, e: self.slots.worker_with(layer, e) is not None

    def _moe_bookkeeping(self, step_idx, li, moe_i, pending, true, h,
                         topk_gate, x, rec: TokenRecord):
        """On-the-fly predictors, serve + compute, the trace record and the
        cacheless eviction of every worker touched by this layer (under
        residency, their release)."""
        b = true.shape[0]
        if self.fly is not None:
            pending.update(self.fly.predict_from(li, h))
        if self.freq is not None:
            pending[li] = self.freq.predict(li, b)
        if self.rand is not None:
            pending[li] = self.rand.predict(li, b)
        if self.prefetch is not None and pending:
            # on-the-fly predictors only just predicted this layer (and
            # their lookahead): queue what is new in the window
            self.prefetch.enqueue(step_idx, li, pending, skip=self._resident_skip())
        pred = pending.get(li)
        lr, y = self._serve_and_compute(step_idx, li, moe_i, pred, true, h,
                                        topk_gate)
        rec.layers.append(lr)
        if self.freq is not None:
            self.freq.observe(li, true)
        if self.residency is not None:
            self.slots.observe_gates(li, true, lr.gates)
        x = x + y[:, None].to(x.dtype)
        used = set(lr.touched)
        used.update(w for _, w in lr.assignments)
        used.update(self.sched.workers_of_group(lr.group))
        for w in sorted(used):
            if self.residency is not None:
                self.slots.release(w)
            else:
                self.slots.evict(w)
        return x

    # ------------------------------------------------------ serve+compute
    def _serve_and_compute(self, step_idx, layer, moe_i, pred, true, h,
                           gates) -> Tuple[LayerRecord, torch.Tensor]:
        """Load the routed experts and compute their FFNs from worker
        slots, in waves when the batch needs more unique experts than the
        fleet holds at once (each wave assigns distinct workers)."""
        group = self.sched.group_of(moe_i)
        touched: set = set()
        rehits = 0
        shipped: List[int] = []
        # 1) predicted experts load ahead of the gate; overflow beyond the
        # fleet's slots falls through to the reload path.  Under residency,
        # predicted experts still resident re-hit in place first, and the
        # rest go onto the remaining slots.  Every scheduling decision is
        # made here, on the main thread: an executor only changes when a
        # payload was fetched.
        if pred is not None:
            pred_experts = list(dict.fromkeys(int(e) for e in pred.reshape(-1)))
            rest: List[int] = []
            reserved: Dict[int, int] = {}
            if self.residency is not None:
                for e in pred_experts:
                    w = self.slots.reactivate(layer, e)
                    if w is None:
                        rest.append(e)
                    else:                      # re-hit: the slot is live
                        rehits += 1
                        touched.add(w)
                        reserved[w] = reserved.get(w, 0) + 1
            else:
                rest = pred_experts
            pairs = self.sched.place(moe_i, rest, reserved)
            payloads = (self.prefetch.collect(step_idx, layer, [e for e, _ in pairs])
                        if self.prefetch is not None and pairs else {})
            for e, w in pairs:
                if self.slots.load(step_idx, layer, e, w, predicted=True,
                                   payload=payloads.get(e)):
                    shipped.append(e)
                touched.add(w)
        # 2) the gate result is ground truth: reload anything missing
        order = self.sched.serving_order(moe_i)
        needed = list(dict.fromkeys(int(e) for e in true.reshape(-1)))
        reloads = 0
        assignments: List[Tuple[int, int]] = []
        waves: List[List[Tuple[int, int]]] = []
        contrib = None                                    # (B, k, d) fp32
        remaining = needed
        while remaining:
            wave: Dict[int, int] = {}
            claimed: set = set()
            for e in remaining:                           # correct predictions
                w = self.slots.worker_with(layer, e)
                if w is not None and w not in claimed:
                    if (self.residency is not None
                            and self.slots.claim_resident(layer, e, w)):
                        rehits += 1               # mispredicted but still resident
                        touched.add(w)
                    wave[e] = w
                    claimed.add(w)
            free = [w for w in order if w not in claimed]
            if not wave and not free:
                raise RuntimeError(f"no workers left to serve layer {layer}")
            # assign the wave's misses first, fetch them together through
            # the executor, then commit in assignment order: the worker
            # choices and event order of the synchronous path
            loads: List[Tuple[int, int]] = []
            for e in remaining:
                if e in wave or self.slots.worker_with(layer, e) is not None:
                    continue
                if not free:
                    break                                 # overflow -> next wave
                loads.append((e, free.pop(0)))
            payloads = (self.prefetch.fetch_now(step_idx, layer, [e for e, _ in loads])
                        if self.prefetch is not None and loads else {})
            for e, w in loads:
                self.slots.load(step_idx, layer, e, w, predicted=False,
                                payload=payloads.get(e))
                touched.add(w)
                reloads += 1
                wave[e] = w
            contrib = self._compute_wave(layer, h, true, gates, wave, contrib)
            done = [(e, wave[e]) for e in remaining if e in wave]
            assignments.extend(done)
            waves.append(done)
            remaining = [e for e in remaining if e not in wave]
        y = combine_topk(contrib)
        lr = LayerRecord(layer=layer, moe_index=moe_i, group=group,
                         predicted=pred, true=true,
                         correct=recall_counts(pred, true) if pred is not None else 0,
                         reloads=reloads, assignments=assignments, waves=waves,
                         touched=tuple(sorted(touched)),
                         gates=gates.cpu().numpy(),
                         shipped=tuple(shipped) if self.residency is not None else None,
                         rehits=rehits)
        return lr, y

    def _compute_wave(self, layer, h, true, gates, wave: Dict[int, int], contrib):
        """One grouped-FFN call on the wave's stacked slot weights: every
        (row, rank) pair routed to a wave expert maps onto the stacked
        axis, the rest are masked to exact zeros, so summing waves is
        order-free.  Packed-resident slots make one call per resident
        scheme: pairs routed to another group's experts are masked, so the
        split is more wave partitioning and changes no bits."""
        if self.packed_slots:
            _, groups = self.slots.gather_stack_packed(layer, wave)
            wc = None
            for scheme, eids, parts in groups:
                gc = grouped_topk_contrib_packed(h, parts, self._slot_map(true, eids, h),
                                                 gates, scheme=scheme)
                wc = gc if wc is None else wc + gc
        else:
            experts, stacked = self.slots.gather_stack(layer, wave)
            wc = grouped_topk_contrib(h, stacked["w_gate"], stacked["w_up"],
                                      stacked["w_down"], self._slot_map(true, experts, h),
                                      gates)
        return wc if contrib is None else contrib + wc

    @staticmethod
    def _slot_map(true, experts, h) -> torch.Tensor:
        """(B, k) index of each routed pair's expert in ``experts``, -1
        where it is not one of them."""
        match = true[..., None] == np.asarray(experts)      # (B, k, E_wave)
        slot_map = np.where(match.any(-1), match.argmax(-1), -1)
        return torch.as_tensor(slot_map, device=h.device)

    # ---------------------------------------------------- prefetch report
    def prefetch_report(self) -> dict:
        """Prefetch and residency counters: what the executor fetched ahead
        or inline, and what re-hits saved.  ``rehit_rate`` is re-hits over
        all slot fills (loads + re-hits)."""
        rs = self.slots.residency_stats
        denom = self.slots.stats["loads"] + rs["rehits"]
        rep = {"residency": getattr(self.residency, "name", None),
               "rehit_rate": rs["rehits"] / denom if denom else 0.0,
               "bytes_moved": self.slots.bytes_moved}
        rep.update({f"residency_{k}": v for k, v in rs.items()})
        if self.prefetch is not None:
            rep["executor"] = self.prefetch.executor.kind
            rep.update({f"prefetch_{k}": v for k, v in self.prefetch.stats.items()})
        return rep

    def close(self) -> None:
        """Join the prefetch executor and drain its side stream (nothing
        without prefetch).  The engine stays usable: a later fetch starts
        the executor again."""
        if self.prefetch is not None:
            self.prefetch.close()

    # ------------------------------------------------------------- memory
    def memory_report(self) -> dict:
        """Bytes by node type — the paper's Table 2 part (ii) quantities."""
        total = sum(t.numel() * t.element_size() for t in tree_leaves(self.params))
        expert_total = (len(self.moe_layers) * self.cfg.num_experts
                        * self.store.expert_bytes)
        main = total - expert_total
        shadow = (shadow_nbytes(self.shadow.params, self.shadow.scheme)
                  if self.shadow is not None else 0)
        # peak, not steady state: while a shard dequantizes on arrival its
        # packed buffer and the full-width slot are both live
        fleet_bytes = self.sched.n_workers * (self.slots.slot_unit_bytes()
                                              + self.slots.transient_packed_bytes())
        transport_max = max((self.store.packed_bytes(li, e) for li in self.moe_layers
                             for e in range(self.cfg.num_experts)), default=0)
        return {
            "main_node_bytes": main,
            "per_worker_bytes": self.slots.device_bytes_per_worker(),
            "n_workers": self.sched.n_workers,
            "shadow_node_bytes": shadow,
            "total_bytes": main + shadow + fleet_bytes,
            "fully_cached_bytes": total,
            "expert_transport_bytes": transport_max,
        }
