"""Device selection shared by the port's entry points.

Every entry point runs on the card unless the caller names the CPU:
``device`` defaults to ``"cuda"`` and a host without CUDA raises
instead of silently computing elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` (a bare ``"cuda"`` becomes the
    current card, so it compares equal to tensors' devices); raises when
    it names CUDA and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run the plain "
            "PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
