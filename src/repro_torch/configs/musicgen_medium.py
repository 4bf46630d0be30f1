"""musicgen-medium [audio]: decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB (vocab is the codebook; delay-pattern flattening assumed).
48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048  [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10000.0,
    layer_pattern=("global",),
    frontend="frames",
    subquadratic=False,  # pure full attention: long_500k skipped (DESIGN.md)
)
