"""AdamW with global-norm clipping, a cosine schedule and optional int8
gradient compression with error feedback (the reference's
``repro/runtime/optimizer.py``).

Functional, as in the reference: :func:`apply_updates` returns new
parameter and state trees and leaves its inputs alone.  The moments and
the error-feedback residual are float32 trees shaped like the params;
with compression off the residual is one float32 zero a leaf, as in the
reference.

Numbers.  The reference runs this inside its jitted train step, where XLA
rewrites a division by a constant as a multiply by the float32 reciprocal
(ROADMAP C4: ``amax / 127.0``, the schedule's ``step / warmup``), contracts
the schedule's ``0.1 + 0.45 * (1 + cos)`` and the residual ``g - q *
scale`` into FMAs and calls glibc's ``cosf``.  The step's scalars (the
learning rate and the bias corrections ``1 - b ** count``, which come out
correctly rounded) are computed on the host in float32 the same way, so
``lr`` equals the reference's bit for bit; the per-element update runs in
float32 tensor ops.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..numerics import f32, fma32, recip32
from .tree import tree_leaves, tree_map

F32 = torch.float32
_f = np.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_compress: bool = False    # int8 + error feedback


class OptState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor   # int32 scalar: steps taken
    err: object           # error-feedback residual (zeros when off)


def init_opt(params, cfg: OptConfig) -> OptState:
    """Zero moments (float32, shaped like the params), count 0, and the
    residual: float32 zeros like the params with compression, else one
    float32 zero a leaf."""
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                 params)
    nu = tree_map(torch.clone, z)
    if cfg.grad_compress:
        err = tree_map(torch.clone, z)
    else:
        err = tree_map(lambda p: torch.zeros((), dtype=F32, device=p.device),
                       params)
    dev = tree_leaves(params)[0].device
    return OptState(mu=z, nu=nu,
                    count=torch.zeros((), dtype=torch.int32, device=dev),
                    err=err)


@functools.cache
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    return lib


def _cosf(x: float) -> float:
    """glibc's ``cosf``, which the reference's XLA CPU code calls."""
    return float(_libm().cosf(float(x)))


def schedule(cfg: OptConfig, step: int) -> float:
    """Linear warmup then cosine decay to ``min_lr_frac``: the learning
    rate at ``step`` as the reference's jitted float32 code computes it,
    returned as a Python float holding a float32."""
    s = _f(int(step))
    warm = min(s * _f(recip32(max(cfg.warmup_steps, 1))), _f(1))
    prog = (s - _f(cfg.warmup_steps)) \
        * _f(recip32(max(cfg.total_steps - cfg.warmup_steps, 1)))
    prog = min(max(prog, _f(0)), _f(1))
    c = _f(_cosf(_f(math.pi) * prog))
    # (1 + cos) * 0.45 + 0.1 as one FMA: the float32 product is exact in
    # float64, and one float64 rounding of the sum before the float32 one
    # gives the fused result here (the sum is far from a tie)
    a = _f(1) + c
    frac = _f(float(a) * float(_f((1 - cfg.min_lr_frac) * 0.5))
              + float(_f(cfg.min_lr_frac)))
    return float((warm * _f(cfg.lr)) * frac)


def _bias_correction(b: float, n: int) -> float:
    """``1 - b ** n`` in float32 with ``b ** n`` correctly rounded, as
    glibc's ``powf`` gives it."""
    return float(_f(1) - _f(float(_f(b)) ** float(_f(n))))


def quantize_int8(g: torch.Tensor) -> tuple:
    """Symmetric per-tensor int8 quantisation.  Returns (q int8, scale
    float32 scalar); ``scale = amax * float32(1 / 127)``, as XLA rewrites
    the reference's ``amax / 127.0``."""
    amax = torch.clamp_min(g.abs().max(), f32(1e-12))
    scale = amax * recip32(127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads, err) -> tuple:
    """int8 error-feedback compression: per leaf ``g + e`` quantised; the
    dequantised gradients ``q * scale`` and the new residuals ``(g + e) -
    q * scale``, one FMA as XLA contracts it in the reference."""
    def one(g, e):
        g = g.to(F32) + e
        q, scale = quantize_int8(g)
        q = q.to(F32)
        return q * scale, fma32(-q, scale, g)
    pairs = tree_map(one, grads, err)
    first = lambda t: tree_map(lambda _, p: p[0], grads, t)
    second = lambda t: tree_map(lambda _, p: p[1], grads, t)
    return first(pairs), second(pairs)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares, in float32."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params, grads, state: OptState, cfg: OptConfig) -> tuple:
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    ``metrics = {"grad_norm", "lr"}`` (float32 scalars on the params'
    device)."""
    if cfg.grad_compress:
        grads, new_err = compress_grads(grads, state.err)
    else:
        new_err = state.err
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, f32(1e-12)),
                            1.0)
    n = int(state.count) + 1
    lr = schedule(cfg, n)
    b1c, b2c = _bias_correction(cfg.b1, n), _bias_correction(cfg.b2, n)
    b1, b2 = f32(cfg.b1), f32(cfg.b2)
    c1, c2 = f32(1 - cfg.b1), f32(1 - cfg.b2)
    eps, wd = f32(cfg.eps), f32(cfg.weight_decay)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m = b1 * m + c1 * g
        v = b2 * v + c2 * g * g
        step = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.to(F32)
        return (p - lr * step).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda _, t: t[i], params, out)
    count = state.count + 1
    metrics = {"grad_norm": gn,
               "lr": torch.tensor(lr, dtype=F32, device=gn.device)}
    return pick(0), OptState(pick(1), pick(2), count, new_err), metrics
