"""mamba2-2.7b — attention-free SSD stack [arXiv:2405.21060]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="mamba2-2.7b", kind="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=80, ssm_head_dim=64, ssm_expand=2,
)
SMOKE = smoke_of(CONFIG, n_heads=4, n_kv_heads=4)
