"""Synthetic data pipeline: learnable Markov token streams + packing.

The port's own copy of ``repro.data.synthetic`` (numpy only): from the
same seed its streams and batches equal the reference's bit for bit.

The stream has genuine structure (a sparse random Markov chain over the
vocabulary, Zipf-weighted) so cross-entropy demonstrably decreases when
the examples train — a flat random stream would leave nothing to learn.
Deterministic per seed; an infinite iterator yields fixed-shape batches
(the contract a train step runs against).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    branching: int = 4          # successors per state (lower = learnable)
    zipf: float = 1.1
    seed: int = 0
    frontend_tokens: int = 0    # >0: also emit modality embeddings
    frontend_dim: int = 0


def _transition_table(cfg: SyntheticConfig, rng) -> np.ndarray:
    """(V, branching) successor table, Zipf-weighted choices."""
    p = 1.0 / np.arange(1, cfg.vocab_size + 1) ** cfg.zipf
    p /= p.sum()
    return rng.choice(cfg.vocab_size, size=(cfg.vocab_size, cfg.branching),
                      p=p)


def markov_tokens(cfg: SyntheticConfig, n_tokens: int,
                  seed_offset: int = 0) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    table = _transition_table(cfg, rng)
    rng2 = np.random.default_rng(cfg.seed + 1 + seed_offset)
    out = np.empty(n_tokens, np.int32)
    s = int(rng2.integers(cfg.vocab_size))
    for i in range(n_tokens):
        out[i] = s
        s = int(table[s, rng2.integers(cfg.branching)])
    return out


def pack_documents(docs: List[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> np.ndarray:
    """Greedy packing of variable-length docs into fixed (N, seq_len)."""
    rows, cur = [], []
    used = 0
    for d in docs:
        d = list(d)
        while d:
            take = min(len(d), seq_len - used)
            cur.extend(d[:take])
            d = d[take:]
            used += take
            if used == seq_len:
                rows.append(np.array(cur, np.int32))
                cur, used = [], 0
    if cur:
        rows.append(np.pad(np.array(cur, np.int32),
                           (0, seq_len - len(cur)),
                           constant_values=pad_id))
    return np.stack(rows) if rows else np.zeros((0, seq_len), np.int32)


def batch_iterator(cfg: SyntheticConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite fixed-shape batches: {"tokens", ("frontend_embeds")}."""
    step = 0
    rng = np.random.default_rng(cfg.seed + 97)
    while True:
        toks = markov_tokens(cfg, cfg.batch_size * cfg.seq_len,
                             seed_offset=step)
        batch = {"tokens": toks.reshape(cfg.batch_size, cfg.seq_len)}
        if cfg.frontend_tokens:
            batch["frontend_embeds"] = rng.standard_normal(
                (cfg.batch_size, cfg.frontend_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        step += 1
        yield batch
