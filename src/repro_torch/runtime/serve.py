"""Serving steps: batched prefill and single-token decode with KV and SSM
caches (the reference's ``repro/runtime/serve.py``; every model kind).
As in the reference, prefill returns logits and no cache, and
``greedy_generate`` consumes the prompt one token a step through the
decode step from a fresh cache: a vlm's decode sees no image, and an
encdec's cross-attends the cache's ``enc_out``, zeros unless the caller
assigns :func:`repro_torch.models.lm.encode`'s output there (ROADMAP
C20).

Each entry point takes ``device`` and defaults to ``"cuda"``: without a
GPU it raises, and it runs on the CPU only when the caller passes
``device="cpu"``.  Parameters must already be on that device
(:func:`repro_torch.models.lm.init_params` with a generator there, or
:func:`repro_torch.convert.lm_params_from_jax`).
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..models import lm
from ..models.config import ModelConfig


def _device(device) -> torch.device:
    """``resolve_device``, with the current CUDA device's index filled in
    (tensors report ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(params, dev: torch.device) -> None:
    if params["embed"].device != dev:
        raise ValueError(f"params are on {params['embed'].device}, the step "
                         f"runs on {dev}")


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """prefill(params, batch) -> last-position logits (B, vocab) f32;
    ``batch["tokens"]`` is (B, T) int; a vlm's ``batch["vis_embed"]`` (B,
    n_vis, d) goes ahead of the token embeddings, an encdec's
    ``batch["frames"]`` (B, enc_seq, d) is encoded first."""
    lm.require_ported(cfg)
    dev = _device(device)

    def prefill(params, batch):
        _on(params, dev)
        tokens = batch["tokens"].to(dev)
        B, T = tokens.shape
        x = lm.embed_tokens(params, tokens, cfg)
        enc_out = None
        if cfg.kind == "vlm":
            x = torch.cat([batch["vis_embed"].to(dev, x.dtype), x], dim=1)
        if cfg.kind == "encdec":
            enc_out = lm.encode(params, batch["frames"].to(dev, x.dtype), cfg)
        Tt = x.shape[1]
        pos = torch.arange(Tt, dtype=torch.int32, device=dev)[None].expand(
            B, Tt)
        hidden, _ = lm.forward_hidden(params, x, pos, cfg, enc_out=enc_out)
        w = lm.lm_head_weight(params, cfg)
        logits = hidden[:, -1] @ w.to(hidden.dtype)
        return logits.to(torch.float32)

    return prefill


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """decode(params, cache, tokens (B,1), pos) -> (logits, cache); the
    cache (:func:`repro_torch.models.lm.init_cache`) is updated in place."""
    lm.require_ported(cfg)
    dev = _device(device)

    def decode(params, cache, tokens, pos):
        _on(params, dev)
        return lm.decode_step(params, cache, tokens.to(dev), pos, cfg)

    return decode


def greedy_generate(params, cfg: ModelConfig, prompt, max_new: int,
                    cache_len: int, device="cuda"):
    """Batched greedy generation: the prompt (B, T) is consumed one token
    at a time through the decode step (teacher-forced), then ``max_new``
    tokens are chosen by argmax.  Returns (B, max_new) int32."""
    dev = _device(device)
    prompt = prompt.to(dev)
    B, T = prompt.shape
    cache = lm.init_cache(cfg, B, cache_len, device=dev)
    step = make_decode_step(cfg, dev)
    tok = prompt[:, :1]
    out = []
    for t in range(T + max_new - 1):
        logits, cache = step(params, cache, tok, t)
        if t + 1 < T:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1) if out else prompt[:, :0]
