"""mixtral-8x7b — the paper's base model: 8 experts, top-2.
[arXiv:2401.04088]  Reference config for every OD-MoE benchmark."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    num_experts=8, top_k=2, d_expert=14336, padded_experts=16,
    rope_theta=1000000.0, dtype="bfloat16",
    source="arXiv:2401.04088",
)
