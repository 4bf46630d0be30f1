"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.
48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    subquadratic=True,  # O(1) decode state
)
