"""Stub modality frontends, as in the reference (``repro.models.frontends``).

The [vlm] and [audio] configs specify only the transformer backbone; the
vision encoder and the audio codec are not implemented.  These helpers
make the embedding tensors a real frontend would emit (shape, dtype and
unit scale), so the backbone consumes what a ViT or a codec would give it.
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def frontend_embed_shape(cfg: ModelConfig, batch: int):
    """Shape of the precomputed frame or patch embeddings: (B, N, fd),
    N = ``frontend_tokens`` or 256, fd = ``frontend_dim`` or d_model."""
    return (batch, cfg.frontend_tokens or 256, cfg.frontend_dim or cfg.d_model)


def synthetic_frontend_embeds(cfg: ModelConfig, gen: torch.Generator, batch: int,
                              dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Random unit-scale embeddings standing in for ViT or codec output,
    drawn from ``gen`` (a ``torch.Generator`` on ``device``)."""
    return torch.randn(frontend_embed_shape(cfg, batch), generator=gen,
                       dtype=torch.float32, device=device).to(dtype)
