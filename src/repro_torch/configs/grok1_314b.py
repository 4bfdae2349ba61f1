"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="grok-1-314b", kind="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, experts_per_tok=2,
)
SMOKE = smoke_of(CONFIG)
