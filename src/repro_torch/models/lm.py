"""Language-model assembly (the reference's ``repro/models/lm.py``) for
the kinds the port serves:

  dense   pre-norm GQA transformer blocks with a SwiGLU MLP (llama3,
          qwen3 with qk_norm and tied embeddings, deepseek, command-r);
  moe     the same blocks with a top-k mixture of SwiGLU experts in place
          of the MLP (mixtral with its sliding window, grok-1): routed
          with a per-group capacity in a prefill, every expert computed
          and weighted by the top-k gates in decode, as in the reference;
  ssm     a stack of Mamba2 SSD blocks (mamba2);
  hybrid  a Mamba2 backbone with one *shared* attention+MLP block applied
          after every ``hybrid_attn_every`` SSM layers (zamba2: its
          parameters are held once; each application has its own KV
          cache);
  vlm     the dense blocks over stub patch embeddings placed ahead of the
          token embeddings, causal over the whole row (internvl2);
  encdec  a non-causal encoder of dense blocks over stub frame embeddings
          (:func:`encode`) and a causal decoder whose blocks cross-attend
          the encoder output between self-attention and the MLP (whisper);
          the decode cache carries the encoder output as ``enc_out``.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless tied, ``layers``, a list with one dict per layer
where the reference stacks the layers on a leading axis and scans (dense:
``ln1``, ``attn``, ``ln2``, ``mlp``; moe: ``moe`` in place of ``mlp``;
ssm: ``ln1``, ``ssm``; an encdec decoder layer adds ``ln_x`` and
``xattn``), for the hybrid ``shared_attn``, one dense block, and for
encdec ``enc_layers`` (a list of dense blocks) and ``enc_norm``.  Matrix
weights are in ``cfg.dtype`` except the Mamba2 projections (bf16, see
``models/ssm.py``); norm weights and the Mamba2 block's other leaves are
f32.  A kind the reference does not know raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import layers as L
from . import ssm as S
from .config import ModelConfig

PORTED_KINDS = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"repro_torch: model kind {cfg.kind!r} ({cfg.name}) is not a "
            f"kind of the reference's (unknown kind)")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    """One layer's params. kind: dense | moe | ssm | dec (an encdec
    decoder layer: dense, with cross-attention)."""
    dt = L.dtype_of(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=L.F32, device=gen.device)
    if kind == "ssm":
        return {"ln1": ones(), "ssm": S.init_mamba2(gen, cfg)}
    p = {"ln1": ones(), "attn": L.init_attention(gen, cfg, dt), "ln2": ones()}
    if kind == "moe":
        p["moe"] = L.init_moe(gen, cfg, dt)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    if kind == "dec" and cfg.n_enc_layers:
        p["ln_x"] = ones()
        p["xattn"] = L.init_attention(gen, cfg, dt)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on the generator's device, with the reference's
    distributions (``lm.py:61``, ``ssm.py:25``): embed N(0, 1) * 0.02,
    every matrix N(0, 1) / sqrt(d_in), norms 1."""
    require_ported(cfg)
    dt = L.dtype_of(cfg)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=L.F32,
                        device=gen.device)
    p = {"embed": embed.mul_(0.02).to(dt),
         "final_norm": torch.ones((cfg.d_model,), dtype=L.F32,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab, dt)
    kind = {"hybrid": "ssm", "vlm": "dense", "encdec": "dec"}.get(cfg.kind,
                                                                  cfg.kind)
    if cfg.kind == "encdec":
        p["enc_layers"] = [_init_block(gen, cfg, "dense")
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = torch.ones((cfg.d_model,), dtype=L.F32,
                                   device=gen.device)
    p["layers"] = [_init_block(gen, cfg, kind) for _ in range(cfg.n_layers)]
    if cfg.kind == "hybrid":
        p["shared_attn"] = _init_block(gen, cfg, "dense")
    return p


# --------------------------------------------------------------------------- #
# forward (prefill)
# --------------------------------------------------------------------------- #

def _dense_block(lp, x, cfg: ModelConfig, positions, *, cache=None,
                 causal=True, window=None, cross_kv=None):
    """Attention, with ``cross_kv`` then cross-attention to an encoder's
    keys and values, then the MLP or, in a MoE block, the experts: routed
    with capacity in a prefill, all of them weighted by the gates in
    decode (with a cache).  Returns (x, cache, aux loss)."""
    h, cache = L.apply_attention(
        lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps, cfg.norm_f32),
        cfg, positions=positions, cache=cache, causal=causal, window=window)
    x = x + h
    if cross_kv is not None:
        h, _ = L.apply_attention(
            lp["xattn"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps,
                                    cfg.norm_f32),
            cfg, positions=positions, causal=False, cross_kv=cross_kv)
        x = x + h
    xn = L.rms_norm(x, lp["ln2"], cfg.norm_eps, cfg.norm_f32)
    if "moe" not in lp:
        return x + L.apply_mlp(lp["mlp"], xn, cfg), cache, None
    h, aux = (L.apply_moe if cache is None else L.apply_moe_dense)(
        lp["moe"], xn, cfg)
    return x + h, cache, aux


def _ssm_block(lp, x, cfg: ModelConfig, cache=None):
    h, cache = S.apply_mamba2(lp["ssm"], L.rms_norm(x, lp["ln1"],
                                                    cfg.norm_eps,
                                                    cfg.norm_f32),
                              cfg, cache=cache)
    return x + h, cache


def _groups(cfg: ModelConfig):
    """The hybrid's groups of SSM layer indices, each followed by one
    application of the shared block; as in the reference, layers past the
    last whole group are not run (zamba2: 54 = 9 x 6)."""
    every = cfg.hybrid_attn_every
    return [range(g * every, (g + 1) * every)
            for g in range(cfg.n_layers // every)]


def forward_hidden(params, embeds, positions, cfg: ModelConfig,
                   enc_out=None):
    """embeds: (B,T,d) -> (final hidden (B,T,d), aux loss).  A loop over
    the layers; the aux loss is the MoE blocks' routing losses summed (0
    for the other kinds).  encdec: ``enc_out`` (B, S, d) is the encoder's
    output (:func:`encode`) that every decoder layer cross-attends."""
    require_ported(cfg)
    x = embeds
    aux = torch.zeros((), dtype=L.F32, device=x.device)
    layers = params["layers"]
    if cfg.kind == "encdec":
        for lp in layers:
            x, _, _ = _dense_block(lp, x, cfg, positions, causal=True,
                                   cross_kv=_cross_kv(lp, enc_out, cfg))
    elif cfg.kind in ("dense", "vlm", "moe"):
        for lp in layers:
            x, _, a = _dense_block(lp, x, cfg, positions, causal=True,
                                   window=cfg.window)
            if a is not None:
                aux = aux + a
    elif cfg.kind == "ssm":
        for lp in layers:
            x, _ = _ssm_block(lp, x, cfg)
    else:
        for grp in _groups(cfg):
            for i in grp:
                x, _ = _ssm_block(layers[i], x, cfg)
            x, _, _ = _dense_block(params["shared_attn"], x, cfg, positions,
                                   causal=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    return x, aux


def _cross_kv(lp, enc_out, cfg: ModelConfig):
    """A decoder layer's cross-attention keys and values from the encoder
    output: (k, v), each (B, S, K, hd) in ``cfg.dtype``."""
    dt = L.dtype_of(cfg)
    B, S, _ = enc_out.shape
    e = enc_out.to(dt)
    return tuple(L._mm(e, lp["xattn"][w]).reshape(B, S, cfg.n_kv_heads,
                                                  cfg.hd)
                 for w in ("wk", "wv"))


def encode(params, frame_embeds, cfg: ModelConfig):
    """The encoder over stub frame embeddings (B, enc_seq, d): non-causal
    dense blocks at positions ``arange(enc_seq)``, then ``enc_norm``."""
    require_ported(cfg)
    B, T, _ = frame_embeds.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=frame_embeds.device)[None].expand(B, T)
    x = frame_embeds
    for lp in params["enc_layers"]:
        x, _, _ = _dense_block(lp, x, cfg, positions, causal=False)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps, cfg.norm_f32)


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
    """Decode cache.  dense, vlm and moe: ``{"layers": [{"k", "v",
    "pos"}]}`` with k/v (batch, S, n_kv_heads, hd) zeros in ``dtype`` (bf16
    whatever ``cfg.dtype`` is, as in the reference) and ``pos`` 0; with a
    window S is ``min(max_seq, window)``, a ring (position p in slot p %
    S).  encdec: those, and ``"enc_out"``, zeros (batch, enc_seq, d) in
    ``dtype``; nothing writes it but the caller (as in the reference,
    ROADMAP C20), who may assign :func:`encode`'s output there.  ssm:
    ``{"layers": [Mamba2 cache]}`` (f32 state and conv windows,
    :func:`repro_torch.models.ssm.init_ssm_cache`).  hybrid: those, and
    ``"shared"``, one KV cache per application of the shared block."""
    require_ported(cfg)
    dev = resolve_device(device)
    S_len = min(max_seq, cfg.window) if cfg.window else max_seq
    shape = (batch, S_len, cfg.n_kv_heads, cfg.hd)

    def kv():
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}

    if cfg.kind in ("dense", "vlm", "moe", "encdec"):
        cache = {"layers": [kv() for _ in range(cfg.n_layers)]}
        if cfg.kind == "encdec":
            cache["enc_out"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                           dtype=dtype, device=dev)
        return cache
    cache = {"layers": [S.init_ssm_cache(cfg, batch, device=dev)
                        for _ in range(cfg.n_layers)]}
    if cfg.kind == "hybrid":
        cache["shared"] = [kv() for _ in _groups(cfg)]
    return cache


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B,1) int; pos: the position of this
    token, which every cache's ``pos`` must equal.  The cache is updated
    in place.  encdec: every layer's cross-attention keys and values are
    computed anew from ``cache["enc_out"]`` at every step, as in the
    reference.  Returns (logits (B, vocab) f32, cache)."""
    require_ported(cfg)
    pos = int(pos)
    for lc in cache["layers"] + cache.get("shared", []):
        if lc["pos"] != pos:
            raise ValueError(f"decode_step at position {pos} with a cache at "
                             f"position {lc['pos']}")
    B = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    layers, caches = params["layers"], cache["layers"]
    if cfg.kind in ("dense", "vlm", "moe", "encdec"):
        enc_out = cache["enc_out"] if cfg.kind == "encdec" else None
        for lp, lc in zip(layers, caches):
            kv = None if enc_out is None else _cross_kv(lp, enc_out, cfg)
            x, _, _ = _dense_block(lp, x, cfg, positions, cache=lc,
                                   causal=True, window=cfg.window,
                                   cross_kv=kv)
    elif cfg.kind == "ssm":
        for lp, lc in zip(layers, caches):
            x, _ = _ssm_block(lp, x, cfg, cache=lc)
    else:
        for grp, sc in zip(_groups(cfg), cache["shared"]):
            for i in grp:
                x, _ = _ssm_block(layers[i], x, cfg, cache=caches[i])
            x, _, _ = _dense_block(params["shared_attn"], x, cfg, positions,
                                   cache=sc, causal=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    logits = x[:, 0] @ lm_head_weight(params, cfg).to(x.dtype)
    return logits.to(L.F32), cache
