"""Mamba2 SSD chunked scan: CUDA on the card, plain PyTorch on the CPU.

The port of the reference's Pallas kernel (``repro/kernels/ssd_scan.py``:
``ssd_scan``, body ``_ssd_kernel``): per (batch, head), chunk after chunk
of L = min(chunk, T) steps, the intra-chunk product, the carried state's
contribution and the state update, all in float32.  :func:`ssd_scan` runs
:func:`.ref.ssd_chunked_ref` for CPU tensors and launches
``csrc/ssd_scan.cu`` for CUDA tensors, or raises; there is no fallback and
no switch.  The CUDA route is chunk-parallel: four launches (C B^T per
chunk, each chunk's own state, the state passing, the outputs) through
scratch that :func:`_plan` sizes and the wrapper allocates, with every
sum in the plain version's order (float32 FMAs), so that it gives the
plain version's y and state bit for bit.  Every wrapper call adds one to
``launches["ssd_scan"]``, whatever number of CUDA launches it makes.
"""
from __future__ import annotations

import ctypes
from ctypes import POINTER, Structure, c_int, c_void_p

import torch

from ._build import check, launch, load, route, stream
from .ref import ssd_chunk_len, ssd_chunked_ref

#: Launches of the kernel since the last :func:`reset_launches`.
launches = {"ssd_scan": 0}

#: Largest chunk length and state size the kernel takes (C^T and B^T of a
#: chunk, B and (C B^T)^T sit in a block's shared memory: 128 x 132 floats
#: each).
MAX_CHUNK = 128
MAX_STATE = 128

_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    launches["ssd_scan"] = 0


class SsdArgs(Structure):
    """Mirrors ``struct SsdArgs`` in ``csrc/ssd_scan.cu``."""

    _fields_ = ([(n, c_void_p) for n in ("x", "dt", "A", "Bm", "Cm", "y",
                                         "state", "cbt", "ct", "cs", "st")]
                + [(n, c_int) for n in ("Bb", "T", "H", "P", "N", "L")])


def _plan(Bb: int, T: int, H: int, P: int, N: int, L: int) -> dict:
    """The CUDA route's float32 scratch, ``{name: shape}`` in the order of
    ``SsdArgs``: (C B^T)^T and C^T of each (b, chunk), cs of each (b, h,
    chunk) and each chunk's (N, P) state.  Raises on L or N above what the
    kernels take."""
    if L > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan kernel: chunk length {L} (at most "
                         f"{MAX_CHUNK}), state size {N} (at most "
                         f"{MAX_STATE})")
    nc = T // L
    return {"cbt": (Bb, nc, L * L), "ct": (Bb, nc, N * L),
            "cs": (Bb, H, nc, L), "st": (Bb, H, nc, N, P)}


def _declare(lib: ctypes.CDLL) -> None:
    lib.ssd_scan.argtypes = [POINTER(SsdArgs), c_int, c_int, c_void_p]
    lib.ssd_scan.restype = c_int


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 128):
    """x (B,T,H,P), dt (B,T,H), A (H,), B_/C_ (B,T,N), shared across heads.
    Returns (y (B,T,H,P) in ``x.dtype``, final state (B,H,N,P) float32).

    T must be a multiple of L = min(chunk, T).  x and B_/C_ are float32 or
    bfloat16; dt and A float32.  The kernel takes contiguous tensors, L
    and N up to 128.  One call adds one to ``launches["ssd_scan"]``."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 3 \
            or C_.shape != B_.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)}")
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    if tuple(dt.shape) != (Bb, T, H) or tuple(A.shape) != (H,) \
            or tuple(B_.shape[:2]) != (Bb, T):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(B_.shape)}")
    if x.dtype not in _TYPES or B_.dtype not in _TYPES \
            or C_.dtype != B_.dtype:
        raise TypeError(f"ssd_scan: x {x.dtype}, B {B_.dtype}, C {C_.dtype}")
    if any(t.device != x.device for t in (dt, A, B_, C_)):
        raise ValueError("ssd_scan: inputs on different devices")
    L = ssd_chunk_len(T, chunk)
    if route(x) == "plain":
        y, state = ssd_chunked_ref(x, dt, A, B_, C_, chunk)
        return y.to(x.dtype), state
    plan = _plan(Bb, T, H, P, N, L)
    check("ssd_scan x", x, x.dtype)
    check("ssd_scan dt", dt, torch.float32)
    check("ssd_scan A", A, torch.float32)
    check("ssd_scan B", B_, B_.dtype)
    check("ssd_scan C", C_, B_.dtype)
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in plan.values()]
    args = SsdArgs(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                   C_.data_ptr(), y.data_ptr(), state.data_ptr(),
                   *(t.data_ptr() for t in scratch), Bb, T, H, P, N, L)
    lib = load("ssd_scan", _declare)
    launch(lib.ssd_scan, ctypes.byref(args), int(x.dtype == torch.bfloat16),
           int(B_.dtype == torch.bfloat16), stream(x))
    launches["ssd_scan"] += 1
    return y, state
