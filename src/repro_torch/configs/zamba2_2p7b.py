"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers with ONE shared (param-reused) attention+MLP block applied
every 6 layers (9 invocations). GQA kv=32 == MHA per the assignment.
"""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="zamba2-2.7b", kind="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_heads=80, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=6,
)
SMOKE = smoke_of(CONFIG)
