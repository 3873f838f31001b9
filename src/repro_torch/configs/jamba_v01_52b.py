"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE
(16 experts, top-2) on every second layer.  [arXiv:2403.19887]

Layer pattern (period 8, scanned 4x): attention at in-block index 4,
Mamba elsewhere; MoE FFN on odd layers.  The Mamba mixer here is our
Mamba2/SSD block (see DESIGN.md hardware-adaptation notes).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, top_k=2, d_expert=14336, moe_every=2, moe_offset=1,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    attn_every=8, attn_offset=4,
    rope_theta=10000.0, dtype="bfloat16",
    source="arXiv:2403.19887",
)
