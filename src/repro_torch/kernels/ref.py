"""Plain PyTorch versions of the port's attention kernel.

:func:`flash_attention_ref` computes what the reference's Pallas kernel
(``repro/kernels/flash_attention.py::_fa_kernel``) computes, materialised:
scores, softmax and ``p @ v`` in float32 whatever the input types (q may
be float32 against bfloat16 k/v), a row with no live key gives 0, and
the output is in ``q.dtype``.  It is what the CPU runs and what the CUDA
kernel is held against on the card; the serve path never hands it a CUDA
tensor.
"""
from __future__ import annotations

import math
import torch


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,H,Tq,hd); k, v: (B,K,Tk,hd), H % K == 0 (q head h reads kv
    head h // (H // K)).  Returns (B,H,Tq,hd) in ``q.dtype``."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    f32 = torch.float32
    qg = q.to(f32).reshape(B, K, G, Tq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(f32)) \
        * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    live = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        live = live & (k_pos <= q_pos)
    if window is not None:
        live = live & (k_pos > q_pos - window)
    s = s.masked_fill(~live, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)   # no live key -> 0
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(f32))
    return out.reshape(B, H, Tq, hd).to(q.dtype)
