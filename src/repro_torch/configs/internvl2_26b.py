"""internvl2-26b — InternLM2 backbone; InternViT frontend is a STUB:
input_specs provides precomputed (B, 256, d) patch embeddings [2404.16821]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="internvl2-26b", kind="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, head_dim=128,
    n_vis_tokens=256,
)
SMOKE = smoke_of(CONFIG)
