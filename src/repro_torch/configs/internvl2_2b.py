"""internvl2-2b [vlm]: InternLM2 decoder backbone; ViT frontend is a STUB
(input_specs supplies precomputed patch embeddings).
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553  [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,  # padded to 92672 internally for TP sharding
    rope_theta=1000000.0,
    layer_pattern=("global",),
    frontend="patch",
    n_frontend_tokens=256,
    subquadratic=False,  # pure full attention: long_500k skipped (DESIGN.md)
)
