"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B-style
dense GQA backbone.  [arXiv:2404.16821]

The vision encoder is the spec-allowed stub: ``input_specs`` provides 256
precomputed patch embeddings (InternViT-6B hidden size 3200) per image,
projected into the LM by the trained frontend projector.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    rope_theta=1000000.0,
    frontend="vision", frontend_tokens=256, frontend_dim=3200,
    dtype="bfloat16",
    source="arXiv:2404.16821",
)
