"""Expert-overlap batch composition (``repro.serve.composer``).

Between decode steps the composer picks which runnable requests decode
together.  A cacheless system pays one slot load per unique (layer,
expert) a composed batch activates, so the win is grouping requests whose
predicted expert sets overlap: one load then serves several requests.

  * ``overlap``: seed with the oldest runnable request, then greedily add
    the candidate sharing the most predicted (layer, expert) pairs with
    the growing union (FIFO on ties), up to ``max_batch``.  Signatures
    come from each request's cached SEP peek, so composing never advances
    a shadow.
  * ``fifo``: the ``max_batch`` oldest requests.
  * ``fair``: per-tenant deficit round-robin; the head of the line seeds
    the batch, then seats go to the fitting candidate whose tenant has
    used the least weight-normalized service so far.

With a ``kv_pool`` the composer also stops adding candidates once the
batch's page growth reaches the free list (the seed is exempt: the loop
preempts to page it).  Composition is policy only: whatever subset is
chosen, each request's tokens equal its solo decode.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from .request import RequestState


class BatchComposer:
    def __init__(self, max_batch: int = 4, policy: str = "overlap", kv_pool=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if policy not in ("overlap", "fifo", "fair"):
            raise ValueError(f"unknown composition policy {policy!r}")
        self.max_batch = max_batch
        self.policy = policy
        self.kv_pool = kv_pool
        # ``fair``: weight-normalized seats used per tenant (persists)
        self._tenant_debt: Dict[str, float] = defaultdict(float)

    # ----------------------------------------------------------- KV budget
    def _growth(self, state: RequestState) -> int:
        """Pages ``state`` must acquire before its next step (the step
        writes slot ``pos``, so it needs ``pos + 1`` slots)."""
        if self.kv_pool is None:
            return 0
        return self.kv_pool.growth_need(state.rid, int(state.pos[0]) + 1)

    def _fits(self, state: RequestState, spent: int) -> bool:
        return (self.kv_pool is None
                or spent + self._growth(state) <= self.kv_pool.free_pages)

    def _seed_spent(self, seed: RequestState) -> int:
        """The seed rides regardless, so it charges the budget only what
        the free list can supply."""
        if self.kv_pool is None:
            return 0
        return min(self._growth(seed), self.kv_pool.free_pages)

    def _charge(self, state: RequestState) -> None:
        """One seat used: a weight-``w`` tenant's debt grows by ``1/w``."""
        req = state.request
        self._tenant_debt[req.tenant] += 1.0 / req.weight

    # -------------------------------------------------------------- choose
    def compose(self, runnable: List[RequestState]) -> List[RequestState]:
        """Pick up to ``max_batch`` requests for the next step.  ``runnable``
        comes in admission order, and the chosen subset keeps it, so the
        batch-row mapping is deterministic."""
        if not runnable:
            return []
        seed, candidates = runnable[0], list(runnable[1:])
        chosen, spent = [seed], self._seed_spent(seed)
        if self.policy == "fifo":
            for cand in candidates:
                if len(chosen) >= self.max_batch:
                    break
                if not self._fits(cand, spent):
                    continue
                spent += self._growth(cand)
                chosen.append(cand)
            return chosen
        if self.policy == "fair":
            self._charge(seed)

            def score(cand, union):
                return -self._tenant_debt[cand.request.tenant]
        else:
            sig = {s.rid: s.predicted_experts() for s in runnable}

            def score(cand, union):
                return len(union & sig[cand.rid])
        union = set() if self.policy == "fair" else set(sig[seed.rid])
        while len(chosen) < self.max_batch and candidates:
            best_i, best = -1, None
            for i, cand in enumerate(candidates):
                if not self._fits(cand, spent):
                    continue
                sc = score(cand, union)
                if best is None or sc > best:          # ties keep the oldest
                    best_i, best = i, sc
            if best_i < 0:                             # nothing fits the budget
                break
            pick = candidates.pop(best_i)
            spent += self._growth(pick)
            if self.policy == "fair":
                self._charge(pick)
            else:
                union |= sig[pick.rid]
            chosen.append(pick)
        chosen_ids = {s.rid for s in chosen}
        return [s for s in runnable if s.rid in chosen_ids]
