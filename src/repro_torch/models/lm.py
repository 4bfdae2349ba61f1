"""The dense language model (the reference's ``repro/models/lm.py``,
``kind="dense"``): pre-norm GQA transformer blocks with a SwiGLU MLP
(llama3, qwen3 with qk_norm and tied embeddings, deepseek, command-r).

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless tied, and ``layers``, a list with one dict per
layer (``ln1``, ``attn``, ``ln2``, ``mlp``) where the reference stacks the
layers on a leading axis and scans.  Matrix weights are in ``cfg.dtype``,
norm weights in f32.  The other kinds raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import layers as L
from .config import ModelConfig

_NOT_PORTED = {
    "moe": "ROADMAP A13: MoE, with mixtral's SWA decode ring",
    "ssm": "ROADMAP A13: ssm/hybrid, carrying B6 ssd_scan",
    "hybrid": "ROADMAP A13: ssm/hybrid, carrying B6 ssd_scan",
    "encdec": "ROADMAP A13: encdec and vlm",
    "vlm": "ROADMAP A13: encdec and vlm",
}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.kind != "dense":
        raise NotImplementedError(
            f"repro_torch: model kind {cfg.kind!r} ({cfg.name}) is not ported "
            f"yet ({_NOT_PORTED.get(cfg.kind, 'unknown kind')})")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = L.dtype_of(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=L.F32, device=gen.device)
    return {"ln1": ones(), "attn": L.init_attention(gen, cfg, dt),
            "ln2": ones(), "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on the generator's device, with the reference's
    distributions (``lm.py:61``): embed N(0, 1) * 0.02, every matrix
    N(0, 1) / sqrt(d_in), norms 1."""
    require_dense(cfg)
    dt = L.dtype_of(cfg)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=L.F32,
                        device=gen.device)
    p = {"embed": embed.mul_(0.02).to(dt),
         "final_norm": torch.ones((cfg.d_model,), dtype=L.F32,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab, dt)
    p["layers"] = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return p


# --------------------------------------------------------------------------- #
# forward (prefill)
# --------------------------------------------------------------------------- #

def _dense_block(lp, x, cfg: ModelConfig, positions, *, cache=None,
                 causal=True, window=None):
    h, cache = L.apply_attention(
        lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps, cfg.norm_f32),
        cfg, positions=positions, cache=cache, causal=causal, window=window)
    x = x + h
    xn = L.rms_norm(x, lp["ln2"], cfg.norm_eps, cfg.norm_f32)
    return x + L.apply_mlp(lp["mlp"], xn, cfg), cache


def forward_hidden(params, embeds, positions, cfg: ModelConfig):
    """embeds: (B,T,d) -> (final hidden (B,T,d), aux loss).  A loop over
    the layers; the aux loss (MoE routing) is 0 for a dense model."""
    require_dense(cfg)
    x = embeds
    for lp in params["layers"]:
        x, _ = _dense_block(lp, x, cfg, positions, causal=True,
                            window=cfg.window)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    return x, torch.zeros((), dtype=L.F32, device=x.device)


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"].to(L.dtype_of(cfg))[tokens]


def lm_head_weight(params, cfg: ModelConfig):
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])


# --------------------------------------------------------------------------- #
# serving: caches + decode step
# --------------------------------------------------------------------------- #

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Per-layer KV cache for decode: ``{"layers": [{"k", "v", "pos"}]}``
    with k/v (batch, S, n_kv_heads, hd) zeros and ``pos`` 0.  bf16 whatever
    ``cfg.dtype`` is, as in the reference."""
    require_dense(cfg)
    dev = resolve_device(device)
    S_len = min(max_seq, cfg.window) if cfg.window else max_seq
    shape = (batch, S_len, cfg.n_kv_heads, cfg.hd)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}
        for _ in range(cfg.n_layers)]}


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B,1) int; pos: the position of this
    token, which every layer's cache ``pos`` must equal.  The cache is
    updated in place.  Returns (logits (B, vocab) f32, cache)."""
    require_dense(cfg)
    pos = int(pos)
    for lc in cache["layers"]:
        if lc["pos"] != pos:
            raise ValueError(f"decode_step at position {pos} with a cache at "
                             f"position {lc['pos']}")
    B = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, _ = _dense_block(lp, x, cfg, positions, cache=lc, causal=True,
                            window=cfg.window)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    logits = x[:, 0] @ lm_head_weight(params, cfg).to(x.dtype)
    return logits.to(L.F32), cache
