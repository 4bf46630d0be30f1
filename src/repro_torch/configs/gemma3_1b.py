"""gemma3-1b [dense]: 5:1 local:global interleave, 128k context.
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=512,
    qk_norm=True,
    rope_theta=1000000.0,
    subquadratic=True,  # 5:1 local; global layers use seq-sharded decode
)
