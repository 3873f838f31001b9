"""Helpers shared by the port's parity tests: JAX config and parameters
across to ``repro_torch``, always through numpy (``jax.random`` cannot be
replayed in torch, so every comparison runs on bridged weights)."""
import dataclasses

import jax
import numpy as np

import repro_torch.models as tm


def torch_cfg(cfg):
    """The port's ``ModelConfig`` with the same field values."""
    return tm.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def bridge(params, device="cpu"):
    """JAX parameter pytree -> port parameters, leaf for leaf."""
    return tm.from_numpy(jax.tree.map(np.asarray, params), device)


def prompt(cfg, seed: int, length: int = 12):
    """A numpy-seeded prompt (1, length) int32, fed to both packages."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, length)).astype(np.int32)
