"""smollm-135m [dense]: llama-arch small; also the e2e-training example arch.
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    layer_pattern=("global",),
    subquadratic=False,  # pure full attention: long_500k skipped (DESIGN.md)
)
