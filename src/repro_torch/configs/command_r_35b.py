"""command-r-35b — wide dense GQA, no biases, LayerNorm, tied
embeddings.  [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    rope_theta=8000000.0, norm_type="layernorm", tie_embeddings=True,
    dtype="bfloat16",
    source="hf:CohereForAI/c4ai-command-r-v01",
)
