"""Config helpers: shape grid shared by all LM-family archs + smoke reducer."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig

# The assigned input-shape set (seq_len, global_batch, mode).
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (SSM/hybrid/SWA)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


def smoke_of(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    d = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(
            1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
        d_ff=128, vocab=512, head_dim=16,
    )
    if cfg.kind == "moe":
        d.update(n_experts=4, experts_per_tok=2)
    if cfg.kind in ("ssm", "hybrid"):
        d.update(ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_chunk=16,
                 d_model=64)  # d_in = 128 = 8*16
    if cfg.kind == "hybrid":
        d.update(n_layers=4, hybrid_attn_every=2)
    if cfg.kind == "encdec":
        d.update(n_enc_layers=2, enc_seq=32)
    if cfg.kind == "vlm":
        d.update(n_vis_tokens=8)
    if cfg.window is not None:
        d.update(window=32)
    d.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **d)
