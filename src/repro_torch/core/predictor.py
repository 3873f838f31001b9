"""Expert-activation predictors: SEP (the paper's) + reproduced baselines.

SEP (Scaled Emulative Prediction): a quantized *shadow* copy of the model
decodes in lockstep and its own observed routing decisions — for every
layer of the token at once — are the predictions.  Baselines (§2.3):

  * ``nextgate``  — feed layer l's router input to layer l+1's gate.
  * ``multigate`` — the same, up to ``lookahead`` layers ahead.
  * ``freq``      — historical per-layer expert popularity.
  * ``random``    — random prefetch (ablation Case 5).
  * ``none``      — no prefetch; load after gating (ablation Case 6).

Recall is Eq. (2)/(3): correctly predicted experts / (k · L · tokens).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models.api import prefill
from repro_torch.models.config import MOE_FF, ModelConfig
from repro_torch.models.moe import top_k
from repro_torch.models.transformer import lm_decode, tree_concat, tree_map
from repro_torch.quant import shadow_params


def moe_layer_indices(cfg: ModelConfig) -> List[int]:
    return [i for i, (_, ff) in enumerate(cfg.layer_kinds()) if ff == MOE_FF]


def layers_within_horizon(moe_layers: Sequence[int], current_layer: int,
                          horizon: int) -> List[int]:
    """The peek window of the prefetch load queue: MoE layer indices at or
    after ``current_layer``, the first ``horizon`` of them (``0`` = all of
    them; the SEP shadow predicts the whole token at once)."""
    ahead = [li for li in sorted(moe_layers) if li >= current_layer]
    return ahead if horizon <= 0 else ahead[:horizon]


def topk_to_layer_dict(cfg: ModelConfig, topk_tuple) -> Dict[int, np.ndarray]:
    """Map ``lm_decode`` aux["topk"] (per MoE pattern position, (R,B,1,k))
    to {absolute_layer: (B,k)}."""
    pattern, _ = cfg.pattern()
    moe_positions = [i for i, kinds in enumerate(pattern) if kinds[1] == MOE_FF]
    out = {}
    for j, pos in enumerate(moe_positions):
        arr = np.asarray(topk_tuple[j].cpu())             # (R, B, [1,] k)
        for r in range(arr.shape[0]):
            out[r * len(pattern) + pos] = arr[r].reshape(arr.shape[1], -1)
    return out


def recall_counts(pred: np.ndarray, true: np.ndarray) -> int:
    """c(q,n,l): correctly predicted experts.  pred/true: (B,k)."""
    return sum(len(set(map(int, pred[b])) & set(map(int, true[b])))
               for b in range(true.shape[0]))


# ------------------------------------------------------------------ SEP
class SEPShadow:
    """The quantized shadow model: an emulator that decodes in lockstep.

    Two call styles share one implementation:

      * stateful (``reset`` / ``step`` / ``align_*``) — one shadow
        tracking one fixed batch, used by ``ODMoEEngine.generate``;
      * functional (``prefill_state`` / ``step_state`` /
        ``align_kv_state``) — the state ``{"caches", "pos", "token"}`` is
        owned by the caller.
    """

    def __init__(self, cfg: ModelConfig, params, scheme: str = "int8"):
        self.cfg = cfg
        self.scheme = scheme
        self.params = shadow_params(params, scheme)
        self.state = None
        self.token = None

    # ------------------------------------------------------- functional
    @torch.no_grad()
    def prefill_state(self, batch, max_cache_len: int) -> dict:
        logits, state = prefill(self.cfg, self.params, batch, max_cache_len,
                                moe_method="grouped")
        return dict(state, token=torch.argmax(logits, dim=-1).to(torch.int32))

    @torch.no_grad()
    def step_state(self, state: dict, token):
        """One shadow decode step consuming ``token``; returns
        ``({layer: predicted (B,k)}, new_state)``."""
        logits, caches, aux = lm_decode(self.cfg, self.params, token,
                                        state["caches"], state["pos"])
        new = dict(state, caches=caches, pos=state["pos"] + 1,
                   token=torch.argmax(logits, dim=-1).to(torch.int32))
        return topk_to_layer_dict(self.cfg, aux["topk"]), new

    @torch.no_grad()
    def rollout_states(self, state: dict, token, S: int):
        """``S`` chained :meth:`step_state` calls: consume ``token``, then
        the shadow's own greedy continuations.  Returns ``(drafts (B,
        S-1), preds_steps, states)``, ``states[s]`` being the state after
        ``s + 1`` tokens (:func:`slice_rollout`).  Each state's tensors
        are its step's own, so a state kept after rollback holds none of
        the others."""
        preds_steps, states = [], []
        st, tok = state, token
        for _ in range(S):
            preds, st = self.step_state(st, tok)
            preds_steps.append(preds)
            states.append(st)
            tok = st["token"]
        drafts = (torch.stack([s["token"] for s in states[:-1]], dim=1) if S > 1
                  else torch.zeros((token.shape[0], 0), dtype=torch.int32,
                                   device=token.device))
        return drafts, preds_steps, states

    @staticmethod
    def align_kv_state(state: dict, main_state: dict) -> dict:
        """``state`` with caches/pos taken from the main model (§3.2 KV
        alignment).  Cache updates are out of place, so sharing the main
        model's tensors is safe."""
        return dict(state, caches=main_state["caches"], pos=main_state["pos"])

    # --------------------------------------------------------- stateful
    def reset(self, batch, max_cache_len: int):
        st = self.prefill_state(batch, max_cache_len)
        self.token = st.pop("token")
        self.state = st
        return self.token

    def step(self, token) -> Dict[int, np.ndarray]:
        preds, new = self.step_state(self.state, token)
        self.token = new.pop("token")
        self.state = new
        return preds

    def align_tokens(self, main_token):
        self.token = main_token

    def align_kv(self, main_state):
        self.state = self.align_kv_state(self.state, main_state)


def slice_rollout(stacked, s: int) -> dict:
    """Per-step state ``s`` of a :meth:`SEPShadow.rollout_states` rollout:
    the state after consuming ``s + 1`` tokens, as chained ``step_state``
    calls return it (the rollback target after committing ``c`` is
    ``slice_rollout(stacked, c - 1)``)."""
    st = stacked[s]
    return {"caches": st["caches"], "pos": st["pos"], "token": st["token"]}


def concat_shadow_states(states) -> dict:
    """Join per-request shadow states along the batch axis: caches are
    stacked per pattern position with a leading repeat axis, so their
    batch axis is 1; ``pos`` and ``token`` are (B,).  States must share
    one cache length (the serving loop prefills every request with the
    same window)."""
    if len(states) == 1:
        return states[0]
    caches = tuple(tree_concat([s["caches"][p] for s in states], dim=1)
                   for p in range(len(states[0]["caches"])))
    return {"caches": caches, "pos": torch.cat([s["pos"] for s in states]),
            "token": torch.cat([s["token"] for s in states])}


def slice_shadow_state(state: dict, i: int) -> dict:
    """Request ``i`` of a composed shadow state (batch of 1), every leaf in
    storage of its own, so a pending snapshot does not keep the composed
    batch alive."""
    def own(a):
        return a.clone(memory_format=torch.contiguous_format)

    caches = tuple(tree_map(lambda a: own(a[:, i:i + 1]), c) for c in state["caches"])
    return {"caches": caches, "pos": own(state["pos"][i:i + 1]),
            "token": own(state["token"][i:i + 1])}


# ------------------------------------------------------- on-the-fly
class GateExtrapolator:
    """nextgate / multigate: apply future layers' routers to the current
    router input.  Called by the engine during the main decode."""

    def __init__(self, cfg: ModelConfig, routers: Dict[int, torch.Tensor],
                 lookahead: int = 1):
        self.cfg = cfg
        self.routers = routers          # {layer: (d, E)}
        self.lookahead = lookahead
        self.layers = sorted(routers)

    def predict_from(self, layer: int, router_input) -> Dict[int, np.ndarray]:
        """Predict the next ``lookahead`` MoE layers after ``layer``."""
        idx = self.layers.index(layer)
        x = router_input.float()
        preds = {}
        for nxt in self.layers[idx + 1: idx + 1 + self.lookahead]:
            _, topk = top_k(x @ self.routers[nxt].float(), self.cfg.top_k)
            preds[nxt] = topk.cpu().numpy()
        return preds


class FrequencyPredictor:
    """Per-layer historical expert popularity (EdgeMoE/fMoE-style)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.counts: Dict[int, np.ndarray] = defaultdict(
            lambda: np.zeros(cfg.num_experts, np.int64))

    def observe(self, layer: int, true_topk: np.ndarray):
        for e in true_topk.reshape(-1):
            self.counts[layer][int(e)] += 1

    def predict(self, layer: int, batch: int) -> np.ndarray:
        top = np.argsort(-self.counts[layer])[: self.cfg.top_k]
        return np.tile(top, (batch, 1))


class RandomPredictor:
    """Ablation Case 5: prefetch uniformly random experts (numpy RNG, so
    the draws equal the reference's for the same seed)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def predict(self, layer: int, batch: int) -> np.ndarray:
        return np.stack([self.rng.choice(self.cfg.num_experts, self.cfg.top_k,
                                         replace=False)
                         for _ in range(batch)])
