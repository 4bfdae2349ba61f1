"""command-r-35b — dense GQA, no-bias, 256k vocab [hf:CohereForAI]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="command-r-35b", kind="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000, head_dim=128,
    rope_theta=8e6,
)
SMOKE = smoke_of(CONFIG)
