"""Transformer building blocks on a params dict (the reference's
``repro/models/layers.py``).

Weights keep the reference's layout, ``(d_in, d_out)`` with ``x @ w``, so
carrying weights across is a copy
(:func:`repro_torch.convert.lm_params_from_jax`).
The reference keeps f32 masters and casts them to ``cfg.dtype`` at every
use; the port's serve path stores matrix weights in ``cfg.dtype`` once
(the same numbers) and norm weights in f32, and its training path keeps
f32 masters and casts them once a step
(:func:`repro_torch.models.lm.cast_params`).

Attention implementations, as in the reference:
  * ``naive``   — materialise the (T, S) scores;
  * ``chunked`` — online softmax over KV chunks in plain PyTorch;
  * ``pallas``  — the hand-written flash-attention kernel
    (:func:`repro_torch.kernels.ops.flash_attention`).

Four faults of the reference are not carried over (ROADMAP C6, C7,
C18, C19): its ``pallas`` branch passes no ``q_offset`` in decode, so the
query sits at position 0 and reads cache slot 0 only; its chunked path
pads a ragged last chunk with keys at position ``-10**9``, which a causal
mask lets through (C7) and a non-causal call, an encoder's or a
cross-attention's, does not mask at all (C19); and its sliding-window
decode ring gives the slots not yet written negative positions, which the
causal and window masks let through.

The MoE layers (``init_moe``, ``apply_moe``, ``apply_moe_dense``) are the
reference's: top-k routing with a per-group capacity, the dispatch and
combine as one-hot einsums, and in decode every expert computed and
weighted by the renormalised top-k gates.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from .config import ModelConfig

F32 = torch.float32


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion (bf16 @ f32 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, scale=None) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(d_in)), drawn in f32 on the
    generator's device, stored in ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=F32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)


def _silu(x):
    return x * torch.sigmoid(x)


def rms_norm(x, w, eps, f32=True):
    dt = x.dtype
    if f32:
        x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(x.dtype)).to(dt)


def rope_angles(positions, hd, theta):
    """positions: int[...]. Returns (cos, sin) of shape (..., hd//2), f32."""
    freqs = torch.exp(-torch.arange(0, hd, 2, dtype=F32,
                                    device=positions.device) / hd
                      * math.log(theta))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., T, n, hd); cos/sin: (..., T, hd//2) broadcast over heads.
    Computed in f32 (bf16 x promotes), returned in ``x.dtype``."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": init_linear(gen, d, cfg.n_heads * hd, dtype),
        "wk": init_linear(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": init_linear(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": init_linear(gen, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=F32, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=F32, device=gen.device)
    return p


def _live(q_pos, k_pos, causal, window):
    """bool (B, T, S) from query/key positions, or None (all live)."""
    m = (k_pos[:, None, :] <= q_pos[:, :, None]) if causal else None
    if window is not None:
        w = k_pos[:, None, :] > (q_pos[:, :, None] - window)
        m = w if m is None else (m & w)
    return m


def _sdpa_naive(q, k, v, q_pos, k_pos, causal, window):
    """q: (B,T,H,hd)  k,v: (B,S,K,hd)  GQA via head grouping.  Scores in
    f32; the probabilities are cast to ``v.dtype`` before ``p @ v``, as in
    the reference."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.to(F32), k.to(F32))
    scores = scores / math.sqrt(hd)
    live = _live(q_pos, k_pos, causal, window)
    if live is not None:
        scores = scores.masked_fill(~live[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, H, hd)


def _chunk_step(qg, kb, vb, live, m, l, acc, scale, acc_dt):
    """One key chunk of the online softmax: the running max ``m``, sum
    ``l`` and accumulator ``acc`` after the keys ``kb`` / values ``vb``
    (``live``: bool (B, T, S) or None)."""
    s = torch.einsum("btkgh,bskh->bkgts", qg, kb.to(F32)) * scale
    if live is not None:
        s = s.masked_fill(~live[:, None, None], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows
    m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isinf(s), 0.0, p)
    corr = torch.exp(torch.where(torch.isinf(m), float("-inf"), m) - m_safe)
    corr = torch.where(torch.isnan(corr), 0.0, corr).to(acc_dt)
    l = l * corr + p.sum(dim=-1).to(acc_dt)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgts,bskh->bkgth", p.to(vb.dtype), vb).to(acc_dt)
    return m_new, l, acc


def _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window, chunk, f32=True,
                  remat_chunk=False):
    """Online softmax over KV chunks (flash algorithm, plain PyTorch).  The
    keys padded onto a ragged last chunk are masked (ROADMAP C7).  With
    ``remat_chunk`` (and autograd recording) each chunk's step is
    checkpointed: its backward recomputes the chunk's probabilities
    instead of keeping them, as the reference's ``remat_chunk`` does."""
    acc_dt = F32 if f32 else torch.bfloat16
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    nc = max(1, math.ceil(S / chunk))
    qg = q.reshape(B, T, K, G, hd).to(F32)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, K, G, T), float("-inf"), dtype=F32, device=q.device)
    l = torch.zeros((B, K, G, T), dtype=acc_dt, device=q.device)
    acc = torch.zeros((B, K, G, T, hd), dtype=acc_dt, device=q.device)
    recompute = remat_chunk and torch.is_grad_enabled()
    for c in range(nc):
        cs = slice(c * chunk, (c + 1) * chunk)
        live = _live(q_pos, k_pos[:, cs], causal, window)
        args = (qg, k[:, cs], v[:, cs], live, m, l, acc, scale, acc_dt)
        if recompute:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)
    return out.to(q.dtype)


def apply_attention(p, x, cfg: ModelConfig, *, positions, cache=None,
                    causal=True, window=None, cross_kv=None):
    """Self-attention, or cross-attention with ``cross_kv``.

    x: (B, T, d).  positions: (B, T) int absolute positions; without a
    cache they are ``arange(T)`` in every row (the ``pallas`` kernel puts
    query ``t`` at ``t`` and key ``s`` at ``s``).  cache: optional dict
    ``k``, ``v`` (B, S, K, hd) and ``pos`` (int) for decode, updated in
    place (the reference returns a new one) and returned.  cross_kv: an
    encoder's (k, v), each (B, S, K, hd), taken as given: no RoPE on q or
    k, no ``k_norm``, key s at position s; the call is then non-causal in
    the reference's callers, a prefill or a decode step alike (no cache).
    Returns (out, cache).
    """
    dt = dtype_of(cfg)
    B, T, _ = x.shape
    hd = cfg.hd
    xq = x.to(dt)
    q = _mm(xq, p["wq"]).reshape(B, T, cfg.n_heads, hd)
    if cross_kv is None:
        k = _mm(xq, p["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
        v = _mm(xq, p["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cross_kv is None:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    q_offset = 0
    if cache is not None:
        # decode: write this step's k/v at the cache position (ring for SWA)
        S = cache["k"].shape[1]
        pos = int(cache["pos"])
        slot = pos % S if window is not None else pos
        if slot + T > S:
            raise ValueError(f"decode: positions {pos}..{pos + T - 1} do not "
                             f"fit a cache of {S} slots")
        cache["k"][:, slot:slot + T] = k.to(cache["k"].dtype)
        cache["v"][:, slot:slot + T] = v.to(cache["v"].dtype)
        idx = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if window is not None:
            base = pos - (pos % S)
            k_pos = idx + base
            k_pos = torch.where(k_pos > pos, k_pos - S, k_pos)
            # a slot not yet written has a negative position (C18)
            k_pos = torch.where(k_pos < 0, 10 ** 9, k_pos)
        else:
            k_pos = torch.where(idx <= pos, idx, 10 ** 9)  # mask unwritten
        k_pos = k_pos.expand(B, S)
        cache["pos"] = pos + T
        k, v = cache["k"], cache["v"]
        q_offset = pos
    elif cross_kv is None:
        k_pos = positions
    else:
        S = k.shape[1]
        k_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    q_pos = positions

    impl = cfg.attn_impl
    if impl == "pallas":
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset,
                                   ring=cache is not None
                                   and window is not None)
    elif impl == "chunked" and k.shape[1] > cfg.attn_chunk and T > 1:
        out = _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window,
                            cfg.attn_chunk, f32=cfg.attn_f32,
                            remat_chunk=cfg.attn_remat_chunk)
    else:
        out = _sdpa_naive(q, k, v, q_pos, k_pos, causal, window)
    out = out.reshape(B, T, cfg.n_heads * hd)
    return _mm(out, p["wo"]), cache


# --------------------------------------------------------------------------- #
# MLP (SwiGLU)
# --------------------------------------------------------------------------- #

def init_mlp(gen: torch.Generator, d: int, ff: int,
             dtype: torch.dtype) -> dict:
    return {"wg": init_linear(gen, d, ff, dtype),
            "wu": init_linear(gen, d, ff, dtype),
            "wd": init_linear(gen, ff, d, dtype)}


def apply_mlp(p, x, cfg: ModelConfig):
    dt = dtype_of(cfg)
    x = x.to(dt)
    g = _silu(_mm(x, p["wg"]))  # x * sigmoid(x), as the reference's silu
    u = _mm(x, p["wu"])
    return _mm(g * u, p["wd"])


# --------------------------------------------------------------------------- #
# Mixture of Experts (top-k, group-wise capacity dispatch)
# --------------------------------------------------------------------------- #

def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """Router (d, E); experts ``wg``/``wu`` (E, d, ff) and ``wd`` (E, ff,
    d), each N(0, 1) / sqrt(d_in) as in the reference."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=F32,
                        device=gen.device)
        return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)

    return {"router": init_linear(gen, d, E, dtype), "wg": experts(d, ff),
            "wu": experts(d, ff), "wd": experts(ff, d)}


def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index as ``lax.top_k`` breaks them (a stable sort;
    ``torch.topk`` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n), -1 included, gives a
    row of zeros."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def moe_gates(p, x, cfg: ModelConfig) -> tuple:
    """Router softmax (f32, over the last axis) and the renormalised top-k
    gates and their experts, for x (..., d)."""
    logits = _mm(x, p["router"]).to(F32)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = top_k(gates, cfg.experts_per_tok)
    return gates, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


def moe_routing(p, x, cfg: ModelConfig, group: int = None) -> dict:
    """The routing of :func:`apply_moe` on x (B, T, d): ``T`` in groups of
    ``g = min(group or cfg.moe_group, T)`` tokens (S = B T / g of them), each
    expert taking at most ``C = max(1, int(capacity_factor * g * k / E))``
    of a group's (token, slot) pairs in token-major, slot-minor order, the
    rest dropped.
    Returns ``xg`` (S, g, d) in ``cfg.dtype``, ``gates`` (S, g, E) f32,
    ``topw`` and ``topi`` (S, g, k), ``onehot`` (S, g, k, E) f32, ``pos``
    (S, g, k, E) f32 (the queue position, -1 off the chosen expert) and
    ``keep`` (S, g, k, E) bool."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    g = min(group or cfg.moe_group, T)
    xg = x.reshape(B * (T // g), g, d).to(dtype_of(cfg))
    S = xg.shape[0]
    gates, topw, topi = moe_gates(p, xg, cfg)
    C = max(1, int(cfg.capacity_factor * g * k / E))
    onehot = _one_hot(topi, E, F32)
    # position of each (token, slot) within its expert queue, in f32
    pos = torch.cumsum(onehot.reshape(S, g * k, E), dim=1).reshape(
        S, g, k, E) * onehot - 1.0
    keep = (pos < C) & (onehot > 0)
    return dict(xg=xg, gates=gates, topw=topw, topi=topi, onehot=onehot,
                pos=pos, keep=keep, C=C)


def moe_dropped(p, x, cfg: ModelConfig, group: int = None) -> torch.Tensor:
    """(token, slot) pairs :func:`apply_moe` drops on x for want of
    capacity: an int64 scalar tensor."""
    r = moe_routing(p, x, cfg, group)
    return (r["onehot"] > 0).sum() - r["keep"].sum()


def apply_moe(p, x, cfg: ModelConfig, group: int = None) -> tuple:
    """Top-k routing with per-group expert capacity, overflow dropped
    (:func:`moe_routing`); the dense one-hot dispatch and combine einsums
    of the reference (``torch.einsum``, as the reference leaves them to
    XLA).  Returns (y (B, T, d) in ``cfg.dtype``, aux loss f32 scalar, the
    Switch-style load-balancing loss)."""
    dt = dtype_of(cfg)
    B, T, d = x.shape
    E = cfg.n_experts
    r = moe_routing(p, x, cfg, group)
    xg, onehot, keep = r["xg"], r["onehot"], r["keep"]
    cap_oh = _one_hot(r["pos"].to(torch.int64), r["C"], dt) \
        * keep[..., None].to(dt)                               # (S,g,k,E,C)
    disp = cap_oh.sum(2)                                       # (S,g,E,C)
    xe = torch.einsum("sgec,sgd->secd", disp, xg)              # (S,E,C,d)
    h = _silu(torch.einsum("secd,edf->secf", xe, p["wg"].to(dt))) \
        * torch.einsum("secd,edf->secf", xe, p["wu"].to(dt))
    ye = torch.einsum("secf,efd->secd", h, p["wd"].to(dt))     # (S,E,C,d)
    comb = torch.einsum("sgkec,sgk->sgec", cap_oh, r["topw"].to(dt))
    y = torch.einsum("sgec,secd->sgd", comb, ye)
    me = r["gates"].mean(dim=(0, 1))
    ce = onehot.sum(2).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return y.reshape(B, T, d), aux


def apply_moe_dense(p, x, cfg: ModelConfig) -> tuple:
    """Every expert computed (decode, small T) and weighted by the
    renormalised top-k gates, as the reference does: no capacity, nothing
    dropped.  The expert products are batched over the experts with the
    tokens broadcast (``torch.einsum`` of "btd,edf->btef" would first copy
    the (E, d, ff) weights into a (d, E, ff) layout).  Returns (y (B, T,
    d), 0)."""
    dt = dtype_of(cfg)
    B, T, d = x.shape
    xg = x.to(dt)
    gates, topw, topi = moe_gates(p, xg, cfg)
    w = torch.zeros_like(gates).scatter(-1, topi, topw)        # (B,T,E)
    xe = xg.reshape(1, B * T, d)
    h = _silu(torch.matmul(xe, p["wg"].to(dt))) \
        * torch.matmul(xe, p["wu"].to(dt))                    # (E,BT,ff)
    ye = torch.matmul(h, p["wd"].to(dt)).reshape(-1, B, T, d)  # (E,B,T,d)
    y = torch.einsum("bte,ebtd->btd", w.to(dt), ye)
    return y, torch.zeros((), dtype=F32, device=x.device)
