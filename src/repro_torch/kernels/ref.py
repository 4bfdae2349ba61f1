"""Plain PyTorch versions of the port's model kernels.

:func:`flash_attention_ref` computes what the reference's Pallas kernel
(``repro/kernels/flash_attention.py::_fa_kernel``) computes, materialised:
scores, softmax and ``p @ v`` in float32 whatever the input types (q may
be float32 against bfloat16 k/v), a row with no live key gives 0, and
the output is in ``q.dtype``.  With ``ring`` the keys are a sliding-window
decode cache of ``Tk`` slots written at ``position % Tk`` (see
:func:`ring_positions`).

:func:`ssd_chunked_ref` is the Mamba2 SSD chunked scan of the reference
model (``repro/models/ssm.py::ssd_chunked``), which is what the Pallas
kernel ``repro/kernels/ssd_scan.py::_ssd_kernel`` computes chunk by chunk;
:func:`ssd_ref` is the reference's sequential token-by-token oracle
(``repro/kernels/ref.py::ssd_ref``).

Each is what the CPU runs and what the CUDA kernel is held against on the
card; the serve path never hands them a CUDA tensor.
"""
from __future__ import annotations

import math
import torch


def ring_positions(Tk: int, last: int, device=None) -> torch.Tensor:
    """int64 (Tk,): the position each slot of a ring of ``Tk`` slots holds
    once position ``last`` is written (position p in slot p % Tk): slot
    ``j`` holds ``base + j`` with ``base = last - last % Tk``, less ``Tk``
    where that passes ``last``.  A negative position is a slot never
    written."""
    base = last - last % Tk
    pos = torch.arange(Tk, device=device) + base
    return torch.where(pos > last, pos - Tk, pos)


def live_mask(Tq: int, Tk: int, *, causal=True, window=None, q_offset=0,
              ring=False, device=None) -> torch.Tensor:
    """bool (Tq, Tk): query row i (at position ``q_offset + i``) attends key
    j (at position j, or with ``ring`` at ``ring_positions(Tk, q_offset +
    Tq - 1)[j]``, a negative one never)."""
    q_pos = torch.arange(Tq, device=device)[:, None] + q_offset
    if ring:
        k_pos = ring_positions(Tk, q_offset + Tq - 1, device)[None, :]
    else:
        k_pos = torch.arange(Tk, device=device)[None, :]
    live = (k_pos >= 0).expand(Tq, Tk)
    if causal:
        live = live & (k_pos <= q_pos)
    if window is not None:
        live = live & (k_pos > q_pos - window)
    return live


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        ring=False):
    """q: (B,H,Tq,hd); k, v: (B,K,Tk,hd), H % K == 0 (q head h reads kv
    head h // (H // K)).  Returns (B,H,Tq,hd) in ``q.dtype``.  The keys
    each query row attends: :func:`live_mask`."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    f32 = torch.float32
    qg = q.to(f32).reshape(B, K, G, Tq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(f32)) \
        * (1.0 / math.sqrt(hd))
    live = live_mask(Tq, Tk, causal=causal, window=window, q_offset=q_offset,
                     ring=ring, device=q.device)
    s = s.masked_fill(~live, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)   # no live key -> 0
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(f32))
    return out.reshape(B, H, Tq, hd).to(q.dtype)


def ssd_chunk_len(T: int, chunk: int) -> int:
    """The chunk length L = min(chunk, T); raises unless it divides T (the
    reference asserts the same, ``ssd_scan.py:68``, ``ssm.py:80``)."""
    L = min(int(chunk), int(T))
    if L < 1 or T % L:
        raise ValueError(f"ssd_scan: T = {T} is not a multiple of the chunk "
                         f"length L = min(chunk = {chunk}, T) = {L}")
    return L


def ssd_chunked_ref(x, dt, A, B_, C_, chunk):
    """Chunked SSD scan.  x (B,T,H,P), dt (B,T,H), A (H,), B_/C_ (B,T,N)
    (B and C shared across heads).  Returns (y (B,T,H,P) f32, final state
    (B,H,N,P) f32).

    Per chunk of L = min(chunk, T) steps, all in f32: ``lam = dt*A``,
    ``cs = cumsum(lam)``; ``y = (C B^T * decay) @ (dt*x) + exp(cs) * (C @
    state)`` with ``decay[l, m] = exp(cs_l - cs_m)`` for m <= l and 0
    above the diagonal (masked inside the exp, where the difference is
    positive and could overflow); ``state = exp(cs_L) * state + (B *
    exp(cs_L - cs))^T @ (dt*x)``."""
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    L = ssd_chunk_len(T, chunk)
    nc = T // L
    f32 = torch.float32
    xc = x.to(f32).reshape(Bb, nc, L, H, P)
    dtc = dt.to(f32).reshape(Bb, nc, L, H)
    Bc = B_.to(f32).reshape(Bb, nc, L, N)
    Cc = C_.to(f32).reshape(Bb, nc, L, N)
    A = A.to(f32)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    state = torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        lam = dtk * A                                    # (B,L,H)
        cs = torch.cumsum(lam, dim=1)                    # (B,L,H)
        dtx = dtk[..., None] * xk                        # (B,L,H,P)
        CB = torch.einsum("bln,bmn->blm", Ck, Bk)        # (B,L,L)
        diff = cs[:, :, None, :] - cs[:, None, :, :]     # (B,L,L,H)
        decay = torch.exp(diff.masked_fill(~tri[None, :, :, None],
                                           float("-inf")))
        y_intra = torch.einsum("blmh,bmhp->blhp", CB[..., None] * decay, dtx)
        y_inter = torch.einsum("bln,bhnp->blhp", Ck, state) \
            * torch.exp(cs)[..., None]
        cs_last = cs[:, -1, :]                           # (B,H)
        w = torch.exp(cs_last[:, None, :] - cs)          # (B,L,H)
        state = torch.exp(cs_last)[:, :, None, None] * state \
            + torch.einsum("blnh,blhp->bhnp", Bk[..., None] * w[:, :, None],
                           dtx)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bb, T, H, P)
    return y, state


def ssd_ref(x, dt, A, B_, C_):
    """Sequential (token-by-token) SSD recurrence, the exact oracle:
    ``S = exp(dt*A) S + dt * B (x) x``, ``y = C . S``.  Returns (y f32,
    final state (B,H,N,P) f32)."""
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    f32 = torch.float32
    x, dt, B_, C_, A = (t.to(f32) for t in (x, dt, B_, C_, A))
    state = torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(T):
        a = torch.exp(dt[:, t] * A)                      # (B,H)
        dtx = dt[:, t, :, None] * x[:, t]                # (B,H,P)
        state = a[:, :, None, None] * state + torch.einsum(
            "bn,bhp->bhnp", B_[:, t], dtx)
        ys.append(torch.einsum("bn,bhnp->bhp", C_[:, t], state))
    return torch.stack(ys, dim=1), state
