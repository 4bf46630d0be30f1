"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, qk-norm GQA.
94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert vocab=151936  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1000000.0,
    layer_pattern=("global",),
    tie_embeddings=False,
    subquadratic=False,  # pure full attention: long_500k skipped (DESIGN.md)
)
