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

Training (the reference's loss half): :func:`lm_loss` takes f32 masters
(``init_params(..., masters=True)``) and casts them at use with
:func:`cast_params`, so gradients land on the masters; the loss is the
chunked cross-entropy :func:`chunked_ce` plus the MoE routing loss, and
every layer's body runs under ``cfg.remat`` (:func:`_remat`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..runtime.tree import tree_leaves
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

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                masters: bool = False) -> dict:
    """One layer's params. kind: dense | moe | ssm | dec (an encdec
    decoder layer: dense, with cross-attention)."""
    dt = L.F32 if masters else L.dtype_of(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=L.F32, device=gen.device)
    if kind == "ssm":
        return {"ln1": ones(), "ssm": S.init_mamba2(
            gen, cfg, proj_dtype=L.F32 if masters else S.BF16)}
    p = {"ln1": ones(), "attn": L.init_attention(gen, cfg, dt), "ln2": ones()}
    if kind == "moe":
        p["moe"] = L.init_moe(gen, cfg, dt)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    if kind == "dec" and cfg.n_enc_layers:
        p["ln_x"] = ones()
        p["xattn"] = L.init_attention(gen, cfg, dt)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                masters: bool = False) -> dict:
    """Random weights on the generator's device, with the reference's
    distributions (``lm.py:61``, ``ssm.py:25``): embed N(0, 1) * 0.02,
    every matrix N(0, 1) / sqrt(d_in), norms 1.  Stored as the serve path
    uses them (see the module docstring), or with ``masters`` every leaf
    in f32, the reference's masters for training: the same draws, so
    ``cast_params(init_params(g, cfg, masters=True), cfg)`` equals
    ``init_params(g', cfg)`` for a generator in the same state."""
    require_ported(cfg)
    dt = L.F32 if masters else L.dtype_of(cfg)
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
        p["enc_layers"] = [_init_block(gen, cfg, "dense", masters)
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = torch.ones((cfg.d_model,), dtype=L.F32,
                                   device=gen.device)
    p["layers"] = [_init_block(gen, cfg, kind, masters)
                   for _ in range(cfg.n_layers)]
    if cfg.kind == "hybrid":
        p["shared_attn"] = _init_block(gen, cfg, "dense", masters)
    return p


#: Norm weights (kept in f32); every other dense-block leaf is a matrix.
NORMS = ("final_norm", "enc_norm", "ln1", "ln2", "ln_x", "q_norm", "k_norm")


def cast_leaf(t: torch.Tensor, name: str, cfg: ModelConfig,
              in_ssm: bool = False) -> torch.Tensor:
    """The type a leaf named ``name`` is used in: a Mamba2 projection
    bf16, any other leaf of a Mamba2 block f32; a norm weight f32; any
    other matrix ``cfg.dtype``.  ``Tensor.to``: differentiable, and the
    leaf itself where it has the type already."""
    if in_ssm:
        return t.to(S.BF16) if name in S.PROJECTIONS else t.to(L.F32)
    return t.to(L.F32) if name in NORMS else t.to(L.dtype_of(cfg))


def cast_params(params, cfg: ModelConfig) -> dict:
    """The casts the reference makes at every use of its f32 masters,
    made once for the whole tree (differentiably, so gradients land on
    the masters): the serve path's types, :func:`cast_leaf`.  On params
    already in those types it returns the same tensors."""
    def walk(tree, in_ssm=False):
        if isinstance(tree, list):
            return [walk(v, in_ssm) for v in tree]
        return {name: (walk(v, in_ssm or name == "ssm")
                       if isinstance(v, (dict, list))
                       else cast_leaf(v, name, cfg, in_ssm))
                for name, v in tree.items()}
    return walk(params)


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


def _remat(cfg: ModelConfig, fn):
    """``fn(lp, x, ...)``, a layer's body, under ``cfg.remat`` while
    autograd records it (a layer whose params or input need a gradient):
    ``"full"`` checkpoints the body (its backward recomputes the layer),
    ``"dots"`` checkpoints it saving only the outputs of the plain matrix
    products (``aten.mm``/``addmm``; the reference's
    ``dots_with_no_batch_dims_saveable``: batched products are
    recomputed), ``"none"`` saves everything.  Serving runs ``fn``
    itself."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat {cfg.remat!r}: none, dots or full")
    if cfg.remat == "none":
        return fn

    def run(lp, x, *args, **kw):
        if not torch.is_grad_enabled() or not (
                x.requires_grad or any(t.requires_grad
                                       for t in tree_leaves(lp))):
            return fn(lp, x, *args, **kw)
        extra = {} if cfg.remat == "full" else {"context_fn": _dots_saved}
        return checkpoint(fn, lp, x, *args, use_reentrant=False, **extra,
                          **kw)
    return run


def _dots_saved():
    """Selective checkpointing that saves the plain matrix products."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def forward_hidden(params, embeds, positions, cfg: ModelConfig,
                   enc_out=None):
    """embeds: (B,T,d) -> (final hidden (B,T,d), aux loss).  A loop over
    the layers, each body under ``cfg.remat`` (:func:`_remat`; the
    hybrid's shared block is not, as in the reference); the aux loss is
    the MoE blocks' routing losses summed (0 for the other kinds).
    encdec: ``enc_out`` (B, S, d) is the encoder's output (:func:`encode`)
    that every decoder layer cross-attends."""
    require_ported(cfg)
    x = embeds
    aux = torch.zeros((), dtype=L.F32, device=x.device)
    layers = params["layers"]
    if cfg.kind == "encdec":
        def dec(lp, x):
            return _dense_block(lp, x, cfg, positions, causal=True,
                                cross_kv=_cross_kv(lp, enc_out, cfg))[0]
        dec = _remat(cfg, dec)
        for lp in layers:
            x = dec(lp, x)
    elif cfg.kind in ("dense", "vlm", "moe"):
        def body(lp, x):
            x, _, a = _dense_block(lp, x, cfg, positions, causal=True,
                                   window=cfg.window)
            return x, a
        body = _remat(cfg, body)
        for lp in layers:
            x, a = body(lp, x)
            if a is not None:
                aux = aux + a
    else:
        ssm = _remat(cfg, lambda lp, x: _ssm_block(lp, x, cfg)[0])
        if cfg.kind == "ssm":
            for lp in layers:
                x = ssm(lp, x)
        else:
            for grp in _groups(cfg):
                for i in grp:
                    x = ssm(layers[i], x)
                x, _, _ = _dense_block(params["shared_attn"], x, cfg,
                                       positions, causal=True)
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
    body = _remat(cfg, lambda lp, x: _dense_block(lp, x, cfg, positions,
                                                  causal=False)[0])
    x = frame_embeds
    for lp in params["enc_layers"]:
        x = body(lp, x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps, cfg.norm_f32)


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"].to(L.dtype_of(cfg))[tokens]


def lm_head_weight(params, cfg: ModelConfig):
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])


# --------------------------------------------------------------------------- #
# loss (chunked cross-entropy)
# --------------------------------------------------------------------------- #

def chunked_ce(hidden, w, labels, chunk=128):
    """Mean cross-entropy of ``hidden @ w`` against ``labels``: hidden
    (B,T,d), w (d,V), labels int (B,T) with -1 = ignore.  The logits go in
    f32 one chunk of ``min(chunk, T)`` positions at a time (T must be a
    multiple), each chunk's sum added in order, as the reference's
    ``lax.scan`` does; the mean is over the labels not ignored (at least
    one)."""
    B, T, d = hidden.shape
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"chunked_ce: T = {T} is not a multiple of the "
                         f"chunk {c}")
    w = w.to(hidden.dtype)
    tot = torch.zeros((), dtype=L.F32, device=hidden.device)
    cnt = torch.zeros((), dtype=L.F32, device=hidden.device)
    for i in range(T // c):
        hc, yc = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = (hc @ w).to(L.F32)
        lse = torch.logsumexp(logits, dim=-1)
        yl = logits.gather(-1, yc.clamp_min(0).long()[..., None])[..., 0]
        mask = (yc >= 0).to(L.F32)
        tot = tot + torch.sum((lse - yl) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params, batch, cfg: ModelConfig, aux_weight=0.01):
    """The training loss: chunked cross-entropy of the next tokens plus
    ``aux_weight`` times the MoE routing loss.  batch: ``tokens`` and
    ``labels`` (B, T) int, a vlm's ``vis_embed`` (B, n_vis, d) ahead of the
    tokens (labels -1 over it), an encdec's ``frames`` (B, enc_seq, d)
    through :func:`encode`.  ``params`` may be f32 masters: the loss casts
    them (:func:`cast_params`) as the reference does at every use."""
    require_ported(cfg)
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    labels = batch["labels"]
    B, T = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    dev = x.device
    enc_out = None
    if cfg.kind == "vlm":
        vis = batch["vis_embed"].to(dev, x.dtype)
        x = torch.cat([vis, x], dim=1)
        labels = torch.cat([torch.full((B, vis.shape[1]), -1,
                                       dtype=labels.dtype, device=dev),
                            labels.to(dev)], dim=1)
    if cfg.kind == "encdec":
        enc_out = encode(params, batch["frames"].to(dev, x.dtype), cfg)
    Tt = x.shape[1]
    positions = torch.arange(Tt, dtype=torch.int32, device=dev)[None].expand(
        B, Tt)
    hidden, aux = forward_hidden(params, x, positions, cfg, enc_out=enc_out)
    loss = chunked_ce(hidden, lm_head_weight(params, cfg), labels.to(dev))
    return loss + aux_weight * aux


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
