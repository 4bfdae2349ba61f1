"""Flash attention: CUDA on the card, plain PyTorch on the CPU.

The port of the reference's Pallas kernel
(``repro/kernels/flash_attention.py``: ``flash_attention``, body
``_fa_kernel``): GQA attention with a causal and/or sliding-window mask and
an absolute query offset, online softmax in float32, wholly masked kv
blocks skipped, output in ``q.dtype``.  :func:`flash_attention` runs
:func:`.ref.flash_attention_ref` for CPU tensors and launches
``csrc/flash_attention.cu`` for CUDA tensors, or raises; there is no
fallback and no switch.  On the card :func:`_route` picks one of three
kernels from the shapes and types alone:

- ``tc``: bfloat16 q and k/v with more than :data:`DECODE_MAX_TQ` query
  rows (every bf16 prefill): wgmma products on the tensor cores fed by TMA;
  p is rounded to bf16 before ``p @ v``;
- ``decode``: at most :data:`DECODE_MAX_TQ` query rows, any types: one pass
  over the cache per (batch, kv head) for all the query heads of its group,
  the keys split over blocks when there are fewer groups than SMs; the only
  route that takes a ``ring`` (a sliding-window decode cache, whose slots
  are not positions: it walks the live positions and maps each to its
  slot);
- ``fma``: more rows with float32 or mixed types: float32 FMAs on the CUDA
  cores.

Every launch adds one to ``launches["flash_attention"]`` and one to its
route's entry of :data:`route_launches`.
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
#: The same launches by route.
route_launches = {"tc": 0, "decode": 0, "fma": 0}

#: Largest head dimension the kernels take (the accumulators live in
#: registers).
MAX_HD = 128
#: Calls with at most this many query rows take the decode route (decode's
#: one row, and a few rows of chunked decode); the tensor-core route's
#: 128-row q tile would be mostly padding below it.
DECODE_MAX_TQ = 4
#: Route codes of the C entry point, in order.
ROUTES = ("fma", "tc", "decode")
#: The decode kernel's warps per block and keys per warp's chunk.
DECODE_WARPS, DECODE_CHUNK = 8, 32
#: Most blocks a decode group's keys split over: one thread-block cluster.
DECODE_MAX_SPLITS = 8

_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    launches["flash_attention"] = 0
    for name in route_launches:
        route_launches[name] = 0


class FaArgs(Structure):
    """Mirrors ``struct FaArgs`` in ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, c_void_p) for n in ("q", "k", "v", "o")]
                + [(n, c_longlong * 3) for n in ("sq", "sk", "sv", "so")]
                + [(n, c_int) for n in ("B", "H", "K", "Tq", "Tk", "hd",
                                        "causal", "window", "q_offset")]
                + [("scale", c_float), ("splits", c_int), ("ring", c_int)])


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = [POINTER(FaArgs), c_int, c_int, c_int,
                                    c_void_p]
    lib.flash_attention.restype = c_int


def _route(Tq: int, hd: int, q_dtype, kv_dtype, H: int, K: int,
           strides=None, addrs=None, ring: bool = False) -> str:
    """The kernel a CUDA call goes to: ``"tc"``, ``"decode"`` or ``"fma"``.
    A ``ring`` cache goes to ``decode`` or raises: a prefill has no cache.

    ``strides`` (element strides of q, k and v, four each) and ``addrs``
    (their data pointers), where given, are held to what the route reads
    them with: TMA boxes of q, k and v (``tc``) and 16-byte loads of k and
    v (``decode``) need every stride but the last, which must be 1, and
    every address a multiple of 16 bytes.  Raises ``ValueError`` on what no
    route takes."""
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_attention kernel: hd {hd} (1 to {MAX_HD})")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention kernel: {H} q heads over {K} kv "
                         f"heads")
    bf16 = torch.bfloat16
    if Tq <= DECODE_MAX_TQ:
        name, held = "decode", (1, 2)
    elif ring:
        raise ValueError(f"flash_attention: a ring cache reaches only the "
                         f"decode route (at most {DECODE_MAX_TQ} query rows),"
                         f" not {Tq}")
    elif q_dtype == bf16 and kv_dtype == bf16:
        name, held = "tc", (0, 1, 2)
    else:
        return "fma"
    if hd % 8:
        raise ValueError(f"flash_attention {name} route: hd {hd} is not a "
                         f"multiple of 8")
    for i in held:
        size = 2 if (q_dtype if i == 0 else kv_dtype) == bf16 else 4
        what = "qkv"[i]
        if strides is not None:
            st = tuple(strides[i])
            if st[3] != 1 or any(s * size % 16 for s in st[:3]):
                raise ValueError(f"flash_attention {name} route: {what}'s "
                                 f"strides {st} are not 16-byte multiples "
                                 f"with the last dimension contiguous")
        if addrs is not None and addrs[i] % 16:
            raise ValueError(f"flash_attention {name} route: {what} is not "
                             f"16-byte aligned")
    return name


def _decode_grid(B: int, H: int, K: int, Tq: int, Tk: int,
                 n_sm: int) -> tuple:
    """The decode kernel's blocks: ``(rows, groups, splits)``.  A block
    holds ``rows`` of the G x Tq query rows of one (batch, kv head) (1, 4
    or 8, as ``dec::launch`` in the source picks); ``groups`` such blocks
    cover the call, and each group's keys are split over ``splits`` blocks
    (one cluster, at most :data:`DECODE_MAX_SPLITS`) so that the card's
    ``n_sm`` SMs have work: no more splits than SMs per group, nor than
    leave a block's warps about one chunk each."""
    R = H // K * Tq
    rows = 1 if R <= 1 else 4 if R <= 4 else 8
    groups = B * K * -(-R // rows)
    chunks = -(-Tk // DECODE_CHUNK)
    splits = max(1, min(n_sm // groups, -(-chunks // DECODE_WARPS),
                        DECODE_MAX_SPLITS))
    return rows, groups, splits


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    q_offset: int = 0, ring: bool = False) -> torch.Tensor:
    """q: (B, H, Tq, hd); k, v: (B, K, Tk, hd) with H % K == 0.  Returns
    (B, H, Tq, hd) in ``q.dtype``, laid out in memory as q is (a model-layout
    q, (B, Tq, H, hd) transposed, gives a model-layout output).

    Query row ``i`` sits at absolute position ``q_offset + i`` (decode and
    chunked prefill); key ``j`` at position ``j``, or with ``ring`` (a
    sliding-window cache of Tk slots, position p in slot p % Tk) at the
    position :func:`.ref.ring_positions` gives it once the last query's
    position is written, a negative one (never written) masked.  GQA: q
    head ``h``
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
                                   q_offset=q_offset, ring=ring)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention kernel: no backward (the reference's Pallas "
            "kernel has none either); train with attn_impl='chunked'")
    if Tq < 1 or Tk < 1:
        raise ValueError(f"flash_attention kernel: Tq {Tq}, Tk {Tk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s last "
                             f"dimension must be contiguous")
    kind = _route(Tq, hd, q.dtype, k.dtype, H, K,
                  strides=(q.stride(), k.stride(), v.stride()),
                  addrs=(q.data_ptr(), k.data_ptr(), v.data_ptr()),
                  ring=ring)
    if q.stride(2) > q.stride(1):  # model layout: write the output so
        out = torch.empty((B, Tq, H, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    else:
        out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    splits = 1
    if kind == "decode":
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = _decode_grid(B, H, K, Tq, Tk, n_sm)[2]
    args = FaArgs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (c_longlong * 3)(*q.stride()[:3]), (c_longlong * 3)(*k.stride()[:3]),
        (c_longlong * 3)(*v.stride()[:3]),
        (c_longlong * 3)(*out.stride()[:3]), B, H, K, Tq, Tk, hd,
        int(bool(causal)), 0 if window is None else int(window),
        int(q_offset), 1.0 / math.sqrt(hd), splits, int(bool(ring)))
    lib = load("flash_attention", _declare)
    launch(lib.flash_attention, ctypes.byref(args), ROUTES.index(kind),
           int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
           stream(q))
    launches["flash_attention"] += 1
    route_launches[kind] += 1
    return out
