"""qwen3-0.6b [dense]: qk-norm, GQA.
28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    layer_pattern=("global",),
    subquadratic=False,  # pure full attention: long_500k skipped (DESIGN.md)
)
