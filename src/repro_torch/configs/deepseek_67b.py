"""deepseek-67b — llama-arch dense GQA [arXiv:2401.02954]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="deepseek-67b", kind="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=102400, head_dim=128,
    rope_theta=1e4,
)
SMOKE = smoke_of(CONFIG)
