"""Mamba2 (SSD, state-space duality) block (the reference's
``repro/models/ssm.py``).

Prefill runs the chunked SSD scan (:func:`ssd_chunked`): the plain
chunked version for CPU tensors, the hand-written kernel
(``kernels/csrc/ssd_scan.cu``, through :func:`repro_torch.kernels.ops.ssd_scan`)
for CUDA tensors, with its hand-written backward
(:class:`repro_torch.kernels.ssd_scan.SsdScanFn`) where a gradient is
taken.  Decode is the O(1) recurrent step in plain PyTorch, as in the
reference, which has no kernel for it.

Shapes: x (B,T,H,P) heads x head_dim; B, C (B,T,N), one group shared
across heads; A (H,) negative reals; dt (B,T,H) positive.

Types, as in the reference whatever ``cfg.dtype`` is: the block input and
the five in-projections are bf16 and so is the out-projection (the port
stores those six matrices in bf16, the numbers the reference casts its f32
masters to at every use); the convolutions, softplus, the scan, the D
skip, the gate and the norm are f32, and so are their parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import F32, init_linear, rms_norm

BF16 = torch.bfloat16

#: The in- and out-projections (bf16); every other leaf of a block is f32.
PROJECTIONS = ("w_z", "w_x", "w_B", "w_C", "w_dt", "w_out")


def _silu(x):
    return x * torch.sigmoid(x)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, d_model=None,
                proj_dtype=BF16) -> dict:
    """Random weights with the reference's distributions (``ssm.py:25``):
    projections N(0, 1) / sqrt(d_in) (stored in ``proj_dtype``: bf16 for
    serving, f32 masters for training), conv kernels N(0, 1) * 0.2 (drawn
    independently; the reference draws conv_B and conv_C from one key),
    conv biases 0, A_log = log(linspace(1, 16, H)), D 1, dt_bias
    log(e - 1), norm 1."""
    d = d_model or cfg.d_model
    d_in = cfg.ssm_expand * d
    H, N, P, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
    if H * P != d_in:
        raise ValueError(f"{cfg.name}: ssm_heads * ssm_head_dim = {H * P} "
                         f"!= ssm_expand * d_model = {d_in}")
    dev = gen.device
    full = lambda shape, v: torch.full(shape, v, dtype=F32, device=dev)

    def conv(c):
        return torch.randn((K, c), generator=gen, dtype=F32,
                           device=dev).mul_(0.2)

    p = {name: init_linear(gen, a, b, proj_dtype) for name, a, b in (
        ("w_z", d, d_in), ("w_x", d, d_in), ("w_B", d, N), ("w_C", d, N),
        ("w_dt", d, H), ("w_out", d_in, d))}
    p.update(conv_x=conv(d_in), conv_B=conv(N), conv_C=conv(N),
             conv_bx=full((d_in,), 0.0), conv_bB=full((N,), 0.0),
             conv_bC=full((N,), 0.0),
             A_log=torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                            device=dev)),
             D=full((H,), 1.0), dt_bias=full((H,), math.log(math.e - 1)),
             norm_w=full((d_in,), 1.0))
    return p


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x: (B,T,C), w: (K,C), b: (C,)."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def _split_in(p, u):
    """The five in-projections of ``u`` (bf16): z, x, B, C, dt, in bf16."""
    return tuple(u @ p[name] for name in ("w_z", "w_x", "w_B", "w_C",
                                          "w_dt"))


def ssd_chunked(x, dt, A, B_, C_, chunk):
    """Chunked SSD scan.  Returns (y f32, final state (B,H,N,P) f32).

    x (B,T,H,P), dt (B,T,H), A (H,), B_/C_ (B,T,N).  CPU tensors run the
    plain chunked version (autograd differentiates it), CUDA tensors the
    kernel and, where a gradient is taken, its backward kernel."""
    return kops.ssd_scan(x.to(F32), dt, A, B_, C_, chunk, final_state=True)


def apply_mamba2(p, u, cfg: ModelConfig, cache=None):
    """Full Mamba2 block. u: (B,T,d).  cache: dict(state, conv_x, conv_B,
    conv_C, pos) for decode (T = 1), updated in place, or None (prefill).
    Returns (out (B,T,d) in ``u.dtype``, cache)."""
    dt_c = u.dtype
    B, T, d = u.shape
    d_in = cfg.ssm_expand * d
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, B_, C_, dt = _split_in(p, u.to(BF16))

    if cache is None:
        x = _silu(_causal_conv(x.to(F32), p["conv_x"], p["conv_bx"]))
        B_ = _silu(_causal_conv(B_.to(F32), p["conv_B"], p["conv_bB"]))
        C_ = _silu(_causal_conv(C_.to(F32), p["conv_C"], p["conv_bC"]))
    else:
        # decode: roll the per-stream conv windows
        def roll(val, key, w, b):
            win = torch.cat([cache[key], val.to(F32)], dim=1)
            out = (win * w).sum(dim=1) + b
            cache[key] = win[:, 1:]
            return _silu(out)[:, None, :]
        x = roll(x, "conv_x", p["conv_x"], p["conv_bx"])
        B_ = roll(B_, "conv_B", p["conv_B"], p["conv_bB"])
        C_ = roll(C_, "conv_C", p["conv_C"], p["conv_bC"])

    x = x.reshape(B, T, H, P)
    dt = _softplus(dt.to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None:
        y, _ = ssd_chunked(x, dt, A, B_, C_, cfg.ssm_chunk)
    else:
        # recurrent step: S = exp(dt*A) S + dt * B (x) x ; y = C . S
        dt1 = dt[:, 0]                                       # (B,H)
        a = torch.exp(dt1 * A)                               # (B,H)
        dtx = dt1[..., None] * x[:, 0]                       # (B,H,P)
        state = a[:, :, None, None] * cache["state"] + torch.einsum(
            "bn,bhp->bhnp", B_[:, 0], dtx)
        y = torch.einsum("bn,bhnp->bhp", C_[:, 0], state)[:, None]
        cache["state"] = state
        cache["pos"] += T

    y = y + p["D"][None, None, :, None] * x
    y = y.reshape(B, T, d_in)
    y = y * _silu(z.to(F32))
    y = rms_norm(y, p["norm_w"], cfg.norm_eps)
    out = y.to(BF16) @ p["w_out"]
    return out.to(dt_c), cache


def init_ssm_cache(cfg: ModelConfig, batch: int, d_model=None,
                   device="cuda") -> dict:
    """One layer's decode cache: the (B,H,N,P) state and the last K - 1
    inputs of each conv, f32 zeros, and ``pos`` 0."""
    dev = resolve_device(device)
    d_in = cfg.ssm_expand * (d_model or cfg.d_model)
    H, N, P, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
    zeros = lambda *shape: torch.zeros(shape, dtype=F32, device=dev)
    return {"state": zeros(batch, H, N, P),
            "conv_x": zeros(batch, K - 1, d_in),
            "conv_B": zeros(batch, K - 1, N),
            "conv_C": zeros(batch, K - 1, N), "pos": 0}
