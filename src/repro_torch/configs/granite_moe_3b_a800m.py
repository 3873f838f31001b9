"""granite-moe-3b-a800m — small-expert MoE: 40 experts, top-8, per-expert
FFN hidden 512.  [hf:ibm-granite/granite-3.0-3b-a800m-base]

The widths are granite-3.0-3b-a800m's.  ``source`` keeps the reference
config's string, which names the 1b-a400m model (32 experts, D=1024, 24
layers): the port's configs hold every field equal to the reference's."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8, d_expert=512, padded_experts=48,
    rope_theta=10000.0, tie_embeddings=True, dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
