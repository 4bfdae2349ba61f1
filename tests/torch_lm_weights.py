"""Language-model weights and prompts from a numpy seed, in the reference's
layout, for the parity tests and ``chip_smoke.py`` (numpy only: the card's
machine has no JAX).

:func:`lm_weights` returns the tree ``repro.models.lm.init_params`` builds
(f32 masters, layers stacked on a leading axis) with the same
distributions for the matrices; norm weights are drawn near 1 rather than
set to 1, so that a norm applied to the wrong axis or not at all shows.
The JAX side takes the tree as it is; the port takes it through
``repro_torch.convert.lm_params_from_jax``.
"""
from __future__ import annotations

import numpy as np

#: The committed serve reference (src/repro_torch/testdata/
#: llama3_smoke_serve_ref.json): llama3-8b SMOKE in f32, weights from
#: ``lm_weights(cfg, SERVE_REF["seed"])``, prompt from ``prompt(...)``.
SERVE_REF = dict(arch="llama3-8b", seed=0, batch=2, steps=8)


def lm_weights(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, ff, V, L, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers, cfg.hd
    H, K = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    def norm(shape):
        return (1.0 + normal(shape, 0.1)).astype(np.float32)

    attn = {"wq": normal((L, d, H * hd), d ** -0.5),
            "wk": normal((L, d, K * hd), d ** -0.5),
            "wv": normal((L, d, K * hd), d ** -0.5),
            "wo": normal((L, H * hd, d), (H * hd) ** -0.5)}
    if cfg.qk_norm:
        attn["q_norm"] = norm((L, hd))
        attn["k_norm"] = norm((L, hd))
    p = {"embed": normal((V, d), 0.02), "final_norm": norm((d,)),
         "layers": {"ln1": norm((L, d)), "attn": attn, "ln2": norm((L, d)),
                    "mlp": {"wg": normal((L, d, ff), d ** -0.5),
                            "wu": normal((L, d, ff), d ** -0.5),
                            "wd": normal((L, ff, d), ff ** -0.5)}}}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, V), d ** -0.5)
    return p


def prompt(cfg, seed: int, batch: int, length: int) -> np.ndarray:
    """int32 (batch, length) tokens in [0, vocab)."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab, (batch, length)).astype(np.int32)
