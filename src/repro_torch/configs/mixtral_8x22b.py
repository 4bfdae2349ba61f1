"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attn [2401.04088]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="mixtral-8x22b", kind="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, experts_per_tok=2, window=4096, rope_theta=1e6,
)
SMOKE = smoke_of(CONFIG)
