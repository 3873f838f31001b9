"""chatglm3-6b — dense GQA (kv=2) with 2d RoPE (partial rotary) and QKV
bias.  [arXiv:2406.12793]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rope_theta=10000.0, rope_fraction=0.5, qkv_bias=True,
    dtype="bfloat16",
    source="arXiv:2406.12793",
)
