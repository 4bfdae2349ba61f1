"""qwen3-4b — dense GQA with qk_norm, tied embeddings [hf:Qwen/Qwen3-8B]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="qwen3-4b", kind="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, tie_embeddings=True, rope_theta=1e6,
)
SMOKE = smoke_of(CONFIG)
