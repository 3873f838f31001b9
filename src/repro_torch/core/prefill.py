"""Prefilling-stage batched processing (§3.3, Fig. 7): each worker hosts
one expert per layer and batched embeddings ship in mini-batches, so LAN
transfer pipelines with the expert GEMMs.  The latency is modelled in
``timing.simulate_prefill_odmoe``.  Plain Python, copied from
``repro.core.prefill``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.models.config import ModelConfig


def prefill_expert_assignment(cfg: ModelConfig, n_workers: int) -> Dict[int, List[int]]:
    """worker -> experts it hosts for EVERY layer during prefill."""
    if n_workers < 1:
        raise ValueError(f"prefill needs at least one worker, got n_workers={n_workers}")
    out: Dict[int, List[int]] = {w: [] for w in range(n_workers)}
    for e in range(cfg.num_experts):
        out[e % n_workers].append(e)
    return out


def split_minibatches(n_tokens: int, n_minibatches: int) -> List[slice]:
    """Contiguous mini-batch slices (Fig. 7b pipelining units)."""
    if n_minibatches < 1:
        raise ValueError(f"n_minibatches must be >= 1, got {n_minibatches}")
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    sizes = [n_tokens // n_minibatches] * n_minibatches
    for i in range(n_tokens % n_minibatches):
        sizes[i] += 1
    out, start = [], 0
    for s in sizes:
        out.append(slice(start, start + s))
        start += s
    return [s for s in out if s.stop > s.start]


def experts_activated(topk_idx: np.ndarray, num_experts: int) -> float:
    """Fraction of experts a batched prefill activates (§3.3: nearly all
    of them for long prompts)."""
    return len(np.unique(topk_idx)) / num_experts
