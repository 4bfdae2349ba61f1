"""Model-layout wrappers of the port's kernels.

Models call these; layouts are converted from the model's (B, T, H, hd)
convention to the kernels' (B, H, T, hd) as views (the kernel reads
through strides, so nothing is copied).
"""
from __future__ import annotations

from . import flash_attention as _fa


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,T,H,hd), k/v: (B,S,K,hd) — model layout.  Returns the same
    layout.  Query ``t`` sits at absolute position ``q_offset + t`` and key
    ``s`` at position ``s``: decode against a cache passes the position of
    its first query."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              q_offset=q_offset)
    return out.transpose(1, 2)


def ssd_scan(x, dt, A, B_, C_, chunk=128):
    """Mamba2 SSD scan: not ported yet."""
    raise NotImplementedError(
        "repro_torch: ssd_scan (the Mamba2 SSD kernel) is not ported yet "
        "(ROADMAP B6)")
