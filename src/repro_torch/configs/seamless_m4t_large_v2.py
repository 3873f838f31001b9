"""seamless-m4t-large-v2 — encoder-decoder audio->text backbone.
[arXiv:2308.11596]

The mel-spectrogram + conformer feature frontend is the spec-allowed
STUB: ``input_specs`` provides precomputed frame embeddings (dim 1024);
this config covers the 24-layer speech encoder + 24-layer text decoder
transformer backbone (GQA kv=16 == MHA at 16 heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    is_encoder_decoder=True, num_encoder_layers=24,
    frontend="audio", frontend_tokens=0, frontend_dim=1024,
    norm_type="layernorm", dtype="bfloat16",
    source="arXiv:2308.11596",
)
