"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert vocab=32000  [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    moe_virtual_split=2,  # 8 experts x 2 halves = EP-16 on the model axis
    window=4096,
    layer_pattern=("local",),
    rope_theta=1000000.0,
    tie_embeddings=False,
    subquadratic=True,  # SWA: KV bounded by the window
)
