"""qwen3-moe-30b-a3b — fine-grained MoE: 128 experts, top-8, per-expert
FFN hidden 768.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, top_k=8, d_expert=768,
    rope_theta=1000000.0, dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B",
)
