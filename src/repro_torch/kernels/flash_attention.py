"""Flash attention: CUDA on the card, plain PyTorch on the CPU.

The port of the reference's Pallas kernel
(``repro/kernels/flash_attention.py``: ``flash_attention``, body
``_fa_kernel``): GQA attention with a causal and/or sliding-window mask and
an absolute query offset, online softmax in float32, wholly masked kv
blocks skipped, output in ``q.dtype``.  :func:`flash_attention` runs
:func:`.ref.flash_attention_ref` for CPU tensors and launches
``csrc/flash_attention.cu`` for CUDA tensors, or raises; there is no
fallback and no switch.  Every launch adds one to
``launches["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
import math
from ctypes import POINTER, Structure, c_float, c_int, c_longlong, c_void_p

import torch

from ._build import launch, load, route, stream
from .ref import flash_attention_ref

#: Launches of the kernel since the last :func:`reset_launches`.
launches = {"flash_attention": 0}

#: Largest head dimension the kernel takes (its accumulator lives in
#: registers: 4 rows x MAX_HD / 16 columns a thread).
MAX_HD = 128

_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    launches["flash_attention"] = 0


class FaArgs(Structure):
    """Mirrors ``struct FaArgs`` in ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, c_void_p) for n in ("q", "k", "v", "o")]
                + [(n, c_longlong * 3) for n in ("sq", "sk", "sv")]
                + [(n, c_int) for n in ("B", "H", "K", "Tq", "Tk", "hd",
                                        "causal", "window", "q_offset")]
                + [("scale", c_float)])


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = [POINTER(FaArgs), c_int, c_int, c_void_p]
    lib.flash_attention.restype = c_int


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Tq, hd); k, v: (B, K, Tk, hd) with H % K == 0.  Returns
    (B, H, Tq, hd) in ``q.dtype``.

    Query row ``i`` sits at absolute position ``q_offset + i`` (decode and
    chunked prefill); key ``j`` at position ``j``.  GQA: q head ``h``
    reads kv head ``h // (H // K)``.  q and k/v are float32 or bfloat16
    and may differ (an f32 model against a bf16 KV cache)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K < 1 or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v on different devices")
    if window is not None and int(window) <= 0:
        raise ValueError(f"flash_attention: window must be positive, "
                         f"got {window}")
    if route(q) == "plain":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if not 1 <= hd <= MAX_HD or Tq < 1 or Tk < 1:
        raise ValueError(f"flash_attention kernel: hd {hd} (at most "
                         f"{MAX_HD}), Tq {Tq}, Tk {Tk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s last "
                             f"dimension must be contiguous")
    out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    args = FaArgs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (c_longlong * 3)(*q.stride()[:3]), (c_longlong * 3)(*k.stride()[:3]),
        (c_longlong * 3)(*v.stride()[:3]), B, H, K, Tq, Tk, hd,
        int(bool(causal)), 0 if window is None else int(window),
        int(q_offset), 1.0 / math.sqrt(hd))
    lib = load("flash_attention", _declare)
    launch(lib.flash_attention, ctypes.byref(args),
           int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
           stream(q))
    launches["flash_attention"] += 1
    return out
