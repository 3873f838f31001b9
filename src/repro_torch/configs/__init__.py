"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

One module per assigned architecture (exact values from the assignment
block, source cited in ``source``), plus the paper's own Mixtral-8x7B.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "llama3_8b", "mamba2_2p7b", "chatglm3_6b", "jamba_v01_52b",
    "internvl2_26b", "qwen3_moe_30b_a3b", "granite_moe_3b_a800m",
    "seamless_m4t_large_v2", "qwen2p5_3b", "command_r_35b",
    "mixtral_8x7b",
]

# CLI ids use dashes / dots as given in the assignment.
_ALIASES = {
    "llama3-8b": "llama3_8b",
    "mamba2-2.7b": "mamba2_2p7b",
    "chatglm3-6b": "chatglm3_6b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "internvl2-26b": "internvl2_26b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2.5-3b": "qwen2p5_3b",
    "command-r-35b": "command_r_35b",
    "mixtral-8x7b": "mixtral_8x7b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_archs(include_paper_model: bool = True) -> List[str]:
    ids = [a for a in _ALIASES if a != "mixtral-8x7b" or include_paper_model]
    return ids
