"""whisper-small — enc-dec backbone; conv frontend is a STUB: input_specs
provides precomputed (B, 1500, d) frame embeddings [arXiv:2212.04356]."""
from ..models.config import ModelConfig
from .base import smoke_of

CONFIG = ModelConfig(
    name="whisper-small", kind="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, head_dim=64,
    n_enc_layers=12, enc_seq=1500,
)
SMOKE = smoke_of(CONFIG)
