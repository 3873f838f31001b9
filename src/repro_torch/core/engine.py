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

``speculate=k`` decodes in draft-verify-accept waves
(``repro_torch.core.specdecode``): the SEP shadow drafts ``k`` tokens,
one ``decode_batch_spec`` wave verifies them as B*k ordinary decode
rows, and the longest agreeing prefix is committed.  Same tokens, fewer
steps.

``profiles`` (``repro_torch.fleet.WorkerProfile``s: link bandwidth and
slot capacity per worker) and ``faults`` (a ``FaultInjector``) run the
heterogeneous, fault-tolerant fleet on a ``FleetSchedule``: dead workers
drop out of every order, multi-slot workers absorb extra predicted
experts, and a worker that dies mid-layer strands its predicted experts,
which reload on a survivor.  Faults cost reloads and time, never a token.
A ``sched=FleetSchedule(plan=...)`` places predicted experts by a
gate-statistics plan (``repro_torch.fleet.placement``), whose statistics
``gate_stats=`` (a ``GateStatsRecorder``) collects; cluster replicas
(``repro_torch.serve.cluster``) share one store, schedule and recorder.

``compute_vs_ship`` (``True`` = 42 GB/s, or a host-memory rate in GB/s)
prices each cold expert both ways: shipping its packed bytes over the
candidate worker's link, or streaming its full-width weights from host
memory to compute on the main node.  A hosted expert is stacked from the
store's round-tripped shard for one ``grouped_topk_contrib`` call and
freed after it: no slot, no load event, no bytes moved, the same bits.

Not ported yet, raising ``NotImplementedError`` (ROADMAP.md queue 1, "the
wave_compute='loop' oracle"): the per-pair ``loop`` wave oracle.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.moe_gemm import (combine_topk, grouped_topk_contrib,
                                          grouped_topk_contrib_packed)
from repro_torch.models.api import prefill
from repro_torch.models.blocks import block_decode, block_decode_router
from repro_torch.models.config import ATTN, MOE_FF, ModelConfig
from repro_torch.models.layers import embed
from repro_torch.models.transformer import (decode_logits, layer_params, tree_concat,
                                            tree_leaves, tree_map, tree_stack)
from repro_torch.quant.quantize import shadow_nbytes
from repro_torch.quant.transport import EXPERT_WEIGHT_NAMES, resolve_policy, transport_params

from .align import AlignmentPolicy
from .prefetch import PrefetchExecutor, make_executor, resolve_residency
from .predictor import (FrequencyPredictor, GateExtrapolator, RandomPredictor,
                        SEPShadow, moe_layer_indices, recall_counts, slice_rollout)
from .schedule import GroupSchedule
from .specdecode import accept_prefix, select_commit, spec_attn_decode, wave_preds
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
    # compute-vs-ship: cold experts computed on the main node from host
    # memory instead of shipped (the same weights; priced as host compute)
    hosted: Tuple[int, ...] = ()


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
                              f"queue 1: {item})")


class ODMoEEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_workers: int = 8,
                 group_size: int = 0, predictor: str = "sep",
                 shadow_scheme: str = "int8", lookahead: int = 4, seed: int = 0,
                 transport=None, device="cuda", speculate: int = 1,
                 prefetch=None, residency=None, peek_horizon: int = 0,
                 packed_slots: bool = False, store=None, profiles=None, faults=None,
                 sched=None, gate_stats=None, compute_vs_ship=None,
                 wave_compute: str = "grouped"):
        if cfg.is_encoder_decoder:
            raise ValueError("engine drives decoder-only models")
        if wave_compute not in ("grouped", "loop"):
            raise ValueError("wave_compute must be 'grouped' or 'loop'")
        if speculate < 1:
            raise ValueError("speculate must be >= 1")
        if speculate > 1:
            # the SEP shadow is the draft model, the verify wave folds S
            # positions into the batch axis of the grouped path, and the
            # wave's slots must be distinct within the cache window
            if predictor != "sep":
                raise ValueError("speculate > 1 requires the SEP shadow (it is the "
                                 "draft model)")
            if wave_compute != "grouped":
                raise ValueError("speculate > 1 requires the grouped wave path")
            if any(mixer != ATTN for mixer, _ in cfg.layer_kinds()):
                raise ValueError("speculate > 1 requires all-attention mixers (SSM "
                                 "states cannot fork per wave row)")
            if cfg.sliding_window and cfg.sliding_window < speculate:
                raise ValueError("speculate must fit the sliding window")
        self.speculate = speculate
        if (prefetch is not None or residency is not None) and wave_compute != "grouped":
            raise ValueError("prefetch/residency require the grouped wave path")
        if packed_slots and wave_compute != "grouped":
            # the loop oracle reads full-width slot dicts
            raise ValueError("packed_slots requires the grouped wave path")
        # compute-vs-ship: None always ships; a rate in GB/s hosts a cold
        # expert whose host-memory stream beats its worker's link
        if compute_vs_ship is True:
            compute_vs_ship = 42.0        # RTX3090_EDGE.cpu_mem_gbps
        if compute_vs_ship is not None and compute_vs_ship <= 0:
            raise ValueError("compute_vs_ship must be a positive GB/s")
        if compute_vs_ship is not None and wave_compute != "grouped":
            raise ValueError("compute_vs_ship requires the grouped wave path")
        self.cvs_gbps = compute_vs_ship
        if wave_compute != "grouped":
            _not_ported(f"wave_compute={wave_compute!r}", "the wave_compute='loop' oracle")
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
        if sched is not None:
            # a prebuilt schedule, whose fleet state the caller shares
            if profiles is not None:
                raise ValueError("pass profiles via the prebuilt sched")
            self.sched = sched
            n_workers = sched.n_workers
        else:
            g = group_size or max(cfg.top_k, 1)
            if profiles is not None:
                profiles = tuple(profiles)
                n_workers = len(profiles)
                if n_workers % g:
                    raise ValueError("len(profiles) must be divisible by the group size")
            elif n_workers % g:
                n_workers = g * max(1, n_workers // g)
            if profiles is not None or faults is not None or compute_vs_ship is not None:
                # lazy: repro_torch.fleet imports repro_torch.core.schedule.
                # Compute-vs-ship prices links with FleetSchedule.t_load_s; a
                # uniform fleet orders exactly like GroupSchedule
                from repro_torch.fleet import FleetSchedule, uniform_profiles
                self.sched = FleetSchedule(n_workers, g,
                                           profiles=profiles or uniform_profiles(n_workers))
            else:
                self.sched = GroupSchedule(n_workers, g)
        self.faults = faults
        # a GateStatsRecorder (duck-typed) observing every step's routing;
        # it records only
        self.gate_stats = gate_stats
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
                                 residency=self.residency,
                                 profiles=getattr(self.sched, "profiles", None))
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
        logits, state = prefill(self.cfg, self.params, batch, max_cache_len,
                                moe_method="grouped")
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
        """End-to-end greedy generation: one token per step, or with
        ``speculate=k`` draft-verify-accept waves (same tokens, fewer
        steps).

        The KV cache is sized like ``greedy_generate``'s (prompt +
        tokens), so engine and reference attend over identical shapes and
        no reduction can change order between them."""
        batch = {"tokens": batch["tokens"].to(self.device)}
        if self.speculate > 1:
            return self._generate_spec(batch, num_tokens, policy)
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

    def _generate_spec(self, batch, num_tokens: int, policy: AlignmentPolicy):
        """Speculative generation: the shadow drafts ``speculate`` tokens a
        wave and one verify wave commits the accepted prefix.  The batch
        commits in lockstep (the least accepted prefix of its rows), so
        ``pos`` stays uniform as in :meth:`generate`.  The alignment policy
        sees each wave's first token index as its step.  A wave writes at
        most position ``prompt + num_tokens - 2`` (its width is cut to the
        tokens left), so the cache is ``greedy_generate``'s width and never
        wraps."""
        max_cache_len = batch["tokens"].shape[1] + num_tokens
        main_token, cache_list, pos = self.prefill_request(batch, max_cache_len)
        self.shadow.reset(batch, max_cache_len)
        tokens_out = [main_token]
        trace = Trace()
        n = 1
        while n < num_tokens:
            t0 = time.perf_counter()
            s_w = min(self.speculate, num_tokens - n)
            at, ak = policy.align_token_at(n), policy.align_kv_at(n)
            if ak:
                self.shadow.align_kv({"caches": self._stack(cache_list), "pos": pos})
            first = main_token if at else self.shadow.token
            st0 = dict(self.shadow.state, token=self.shadow.token)
            drafts, preds_steps, roll = self.shadow.rollout_states(st0, first, s_w)
            wave_in = torch.cat([main_token[:, None], drafts], dim=1)
            rec = TokenRecord(index=n, aligned_token=at, aligned_kv=ak, spec_len=s_w)
            verified, c, cache_list, pos = self.decode_batch_spec(
                wave_in, cache_list, pos, wave_preds(preds_steps), n, rec, lockstep=True)
            ci = rec.committed // verified.shape[0]     # lockstep: the same for every row
            tokens_out.extend(verified[:, s] for s in range(ci))
            main_token = verified[:, ci - 1]
            # roll the shadow back to the accepted prefix: step ci-1 consumed
            # exactly [first, true tokens 0..ci-2], no rejected draft
            st = slice_rollout(roll, ci - 1)
            self.shadow.token = st["token"]
            self.shadow.state = {"caches": st["caches"], "pos": st["pos"]}
            self._sync()
            rec.seconds = time.perf_counter() - t0
            trace.records.append(rec)
            n += ci
        return torch.stack(tokens_out, dim=1), trace

    # ---------------------------------------------------------- one token
    @torch.no_grad()
    def decode_batch(self, token, cache_list, pos, preds, step_idx,
                     rec: TokenRecord):
        """One decode iteration.  ``preds`` maps layer -> (B,k) predicted
        experts for this iteration.  Non-MoE layers and each MoE layer's
        mixer + router run on the main node; expert FFNs run from worker
        slots in ``_serve_and_compute``.  Step-scoped faults fire first,
        layer-scoped ones inside ``_serve_and_compute``."""
        cfg = self.cfg
        self._apply_faults(step_idx)
        x = embed(token[:, None], self.params["embed"])
        x = self._decode_layers(x, cache_list, cache_list, pos, preds, step_idx, rec)
        logits = decode_logits(cfg, self.params, x)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache_list, pos + 1

    def _decode_layers(self, x, cache_list, out, pos, preds, step_idx, rec: TokenRecord,
                       wave: int = 0):
        """The layers of a decode step over the rows ``x``, reading each
        layer's cache from ``cache_list`` and storing the new one in
        ``out[li]``.  ``wave=S`` runs a verify wave: the same blocks with
        ``specdecode.spec_attn_decode`` as their attention, whose B*S rows
        are a batch like any other to the expert machinery."""
        cfg = self.cfg
        attn = partial(spec_attn_decode, S=wave) if wave else None
        pending: Dict[int, np.ndarray] = dict(preds)
        # SEP predictions cover the whole token: queue their fetches now, so
        # the transfers overlap everything before each layer's waves
        if self.prefetch is not None and pending:
            self.prefetch.enqueue(step_idx, 0, pending, skip=self._resident_skip())
        moe_i = -1
        for li, kinds in enumerate(cfg.layer_kinds()):
            lp = self._layer_params[li]
            if kinds[1] != MOE_FF:
                x, out[li] = block_decode(cfg, lp, kinds, x, cache_list[li], pos, attn=attn)[:2]
                continue
            moe_i += 1
            x, out[li], h, topk_idx, topk_gate = block_decode_router(
                cfg, lp, kinds, x, cache_list[li], pos, attn=attn)
            x = self._moe_bookkeeping(step_idx, li, moe_i, pending,
                                      topk_idx.cpu().numpy(), h, topk_gate, x, rec)
        if self.prefetch is not None:
            self.prefetch.finish_token(step_idx)
        return x

    @torch.no_grad()
    def decode_batch_spec(self, tokens, cache_list, pos, preds, step_idx,
                          rec: TokenRecord, *, max_commit=None, lockstep: bool = False):
        """One draft-verify-accept wave for the (possibly composed) batch
        (``repro_torch.core.specdecode``).

        ``tokens`` (B, S): column 0 each request's true last token, columns
        1.. the shadow's drafts; ``preds``: {layer -> (B*S, k)} in wave-row
        order (row ``b*S + s`` = request ``b``, position ``s``).  The B*S
        rows go through ``_moe_bookkeeping`` unchanged, so loads, prefetch,
        residency and packed slots behave as for a composed batch of that
        size.  A paged batch view gathers each layer dense, the wave
        replicates and selects it, and the assignment scatters the
        committed rows back through the page tables.

        Returns ``(verified (B, S), c (B,), cache_list, pos + c)``: request
        ``b`` committed ``verified[b, :c_b]``.  ``max_commit`` (B,) caps the
        commits (serving budgets); ``lockstep=True`` commits the batch
        minimum everywhere (fixed-batch generate).  ``rec.spec_len`` is
        S and ``rec.committed`` the sum of ``c``; ``S == 1`` is the
        one-token step, with ``rec.spec_len, rec.committed = 1, B``."""
        cfg = self.cfg
        b, s_w = tokens.shape
        if s_w == 1:
            tok, cache_list, pos = self.decode_batch(tokens[:, 0], cache_list, pos, preds,
                                                     step_idx, rec)
            rec.spec_len, rec.committed = 1, b
            return (tok[:, None], torch.ones((b,), dtype=torch.int32, device=tok.device),
                    cache_list, pos)
        self._apply_faults(step_idx)
        x = embed(tokens.reshape(-1, 1), self.params["embed"])
        pos_rows = (pos[:, None] + torch.arange(s_w, dtype=pos.dtype,
                                                device=pos.device)).reshape(-1)
        # each wave row verifies against its own copy of its request's cache;
        # nothing is written back before the commit selects a row
        spec_caches: Dict[int, dict] = {}
        x = self._decode_layers(x, cache_list, spec_caches, pos_rows, preds, step_idx, rec,
                                wave=s_w)
        verified = torch.argmax(decode_logits(cfg, self.params, x), dim=-1).to(
            torch.int32).reshape(b, s_w)
        # the commit counts drive host control flow: one copy to the host
        both = torch.cat([tokens.to(torch.int32), verified], dim=1).cpu()
        c = accept_prefix(both[:, :s_w], both[:, s_w:])
        if max_commit is not None:
            c = torch.minimum(c, torch.as_tensor(max_commit, dtype=torch.int32))
        if lockstep:
            c = torch.full_like(c, int(c.min()))
        rec.spec_len, rec.committed = s_w, int(c.sum())
        c = c.to(pos.device)
        for li in range(cfg.num_layers):
            cache_list[li] = select_commit(spec_caches[li], c, s_w)
        return verified, c, cache_list, pos + c

    def _apply_faults(self, step_idx) -> None:
        """Fire the step-scoped faults due by ``step_idx``."""
        if self.faults is not None:
            self.faults.apply(step_idx, self.sched.state, self.slots)

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
        if self.gate_stats is not None:
            self.gate_stats.observe(moe_i, true, lr.gates)
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
        fleet holds at once (each wave assigns distinct workers: a
        multi-slot worker computes one of its experts per wave)."""
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
        # mid-step faults: a worker dying here strands the predicted experts
        # it just loaded, and the gate pass below reloads them on a survivor
        if self.faults is not None:
            self.faults.apply_layer(step_idx, moe_i, self.sched.state, self.slots)
        # 2) the gate result is ground truth: reload anything missing
        order = self.sched.serving_order(moe_i)         # alive workers only
        needed = list(dict.fromkeys(int(e) for e in true.reshape(-1)))
        reloads = 0
        assignments: List[Tuple[int, int]] = []
        waves: List[List[Tuple[int, int]]] = []
        hosted: List[int] = []
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
                raise RuntimeError(f"no alive workers left to serve layer {layer}")
            # assign the wave's misses first, fetch them together through
            # the executor, then commit in assignment order: the worker
            # choices and event order of the synchronous path
            loads: List[Tuple[int, int]] = []
            wave_hosted: List[int] = []
            for e in remaining:
                if e in wave:
                    continue
                if self.slots.worker_with(layer, e) is not None:
                    continue        # resident on a busy multi-slot worker: it
                    #                 computes in the next wave, no reload
                if not free:
                    break                                 # overflow -> next wave
                # compute-vs-ship: host it when that beats the candidate's
                # link; the candidate stays free for the next miss
                if self._prefer_host(layer, e, free[0]):
                    wave_hosted.append(e)
                    continue
                loads.append((e, free.pop(0)))
            payloads = (self.prefetch.fetch_now(step_idx, layer, [e for e, _ in loads])
                        if self.prefetch is not None and loads else {})
            for e, w in loads:
                self.slots.load(step_idx, layer, e, w, predicted=False,
                                payload=payloads.get(e))
                touched.add(w)
                reloads += 1
                wave[e] = w
            if wave:                       # an all-hosted wave skips the slot call
                contrib = self._compute_wave(layer, h, true, gates, wave, contrib)
            if wave_hosted:
                contrib = self._compute_hosted(layer, h, true, gates, wave_hosted, contrib)
            done = [(e, wave[e]) for e in remaining if e in wave]
            assignments.extend(done)
            waves.append(done)
            hosted.extend(wave_hosted)
            skip = set(wave) | set(wave_hosted)
            remaining = [e for e in remaining if e not in skip]
        y = combine_topk(contrib)
        lr = LayerRecord(layer=layer, moe_index=moe_i, group=group,
                         predicted=pred, true=true,
                         correct=recall_counts(pred, true) if pred is not None else 0,
                         reloads=reloads, assignments=assignments, waves=waves,
                         touched=tuple(sorted(touched)),
                         gates=gates.cpu().numpy(),
                         shipped=tuple(shipped) if self.residency is not None else None,
                         rehits=rehits, hosted=tuple(hosted))
        return lr, y

    # ---------------------------------------------------- compute-vs-ship
    def _prefer_host(self, layer: int, expert: int, worker: int) -> bool:
        """Whether streaming the expert's full-width weights from host
        memory beats shipping its packed payload over ``worker``'s
        (throttled) link, priced by ``FleetSchedule.t_load_s`` as the
        timing clock prices it."""
        if self.cvs_gbps is None:
            return False
        t_ship = self.sched.t_load_s(worker, self.store.packed_bytes(layer, expert))
        t_host = self.store.expert_bytes / (self.cvs_gbps * 1e9)
        return t_host < t_ship

    def _compute_hosted(self, layer, h, true, gates, experts: List[int], contrib):
        """The main-node twin of ``_compute_wave``: the stack comes from
        the store's shards (``unpack_shard``, the round trip a slot holds)
        instead of slot contents, for one grouped-FFN call, so the
        contributions are the slots' bits.  The stack is a transient device
        tensor, not a slot: it records no load and is freed on return."""
        experts = sorted(experts)
        stacked: Dict[str, torch.Tensor] = {}
        for i, e in enumerate(experts):
            # copied in one expert at a time: one shard lives beside the stack
            shard = self.store.unpack_shard(layer, e)
            for name in EXPERT_WEIGHT_NAMES:
                w = shard[name]
                if name not in stacked:
                    stacked[name] = w.new_empty((len(experts),) + tuple(w.shape))
                stacked[name][i].copy_(w)
            del shard
        wc = grouped_topk_contrib(h, stacked["w_gate"], stacked["w_up"], stacked["w_down"],
                                  self._slot_map(true, experts, h), gates)
        return wc if contrib is None else contrib + wc

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
        fleet_bytes = (sum(self.slots.capacity) * self.slots.slot_unit_bytes()
                       + self.sched.n_workers * self.slots.transient_packed_bytes())
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
