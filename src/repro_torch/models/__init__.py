from .api import decode_step, from_numpy, greedy_generate, init_params, loss_fn, prefill
from .config import (ATTN, DENSE_FF, INPUT_SHAPES, MAMBA, MOE_FF, NO_FF,
                     InputShape, ModelConfig)

__all__ = [
    "ATTN", "DENSE_FF", "INPUT_SHAPES", "MAMBA", "MOE_FF", "NO_FF",
    "InputShape", "ModelConfig", "decode_step", "from_numpy",
    "greedy_generate", "init_params", "loss_fn", "prefill",
]
