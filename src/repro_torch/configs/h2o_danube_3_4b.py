"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000  [arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    window=4096,
    layer_pattern=("local",),
    rope_theta=10000.0,
    subquadratic=True,  # SWA: KV bounded by the window
)
