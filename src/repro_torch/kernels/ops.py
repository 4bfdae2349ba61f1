"""Model-layout wrappers of the port's kernels.

Models call these.  Attention's layouts are converted from the model's
(B, T, H, hd) convention to the kernel's (B, H, T, hd) as views (the
kernel reads through strides, so nothing is copied, and writes its output
in the model layout, so the caller's reshape to (B, T, H * hd) is a view
too); the SSD scan takes the model's layout as it is.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    ring=False):
    """q: (B,T,H,hd), k/v: (B,S,K,hd) — model layout.  Returns the same
    layout.  Query ``t`` sits at absolute position ``q_offset + t`` and key
    ``s`` at position ``s``: decode against a cache passes the position of
    its first query.  ``ring``: the keys are a sliding-window cache of S
    slots, position p in slot p % S."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              q_offset=q_offset, ring=ring)
    return out.transpose(1, 2)


def ssd_scan(x, dt, A, B_, C_, chunk=128, *, final_state=False):
    """Mamba2 SSD: x (B,T,H,P), dt (B,T,H), A (H,), B_/C_ (B,T,N) — model
    layout, which is the kernel's.  Returns y (B,T,H,P) in ``x.dtype``;
    with ``final_state`` also the state after the last step, (B,H,N,P)
    float32.  dt and A are taken in float32 (the kernel widens them), and
    every input is made contiguous."""
    y, state = _ssd.ssd_scan(
        x.contiguous(), dt.to(torch.float32).contiguous(),
        A.to(torch.float32).contiguous(), B_.contiguous(), C_.contiguous(),
        chunk=chunk)
    return (y, state) if final_state else y
