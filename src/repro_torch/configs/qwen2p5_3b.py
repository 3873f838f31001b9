"""qwen2.5-3b — dense GQA (kv=2) with QKV bias, tied embeddings.
[hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    rope_theta=1000000.0, qkv_bias=True, tie_embeddings=True,
    dtype="bfloat16",
    source="hf:Qwen/Qwen2.5-0.5B",
)
