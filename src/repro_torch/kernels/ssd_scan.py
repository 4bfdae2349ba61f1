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

The gradient.  :class:`SsdScanFn` is the scan as a
``torch.autograd.Function``: its forward is the kernel above, keeping the
scratch the backward reads (C B^T, cs and each chunk's incoming state),
and its backward is :func:`ssd_scan_bwd`, the hand-written backward
kernel (``ssd_scan_bwd`` in ``csrc/ssd_scan.cu``, five launches, float32,
P up to 64, every sum in a fixed order so that two calls give the same
bits; W summed over groups of heads, and dB and dC written once from
products over the heads, with no per-head partials), one
``launches["ssd_scan_bwd"]`` a call.  Its plain twin,
:func:`ssd_scan_bwd_plain`, is autograd through the plain chunked scan;
CPU tensors take it.  The TPU kernel has no backward: the reference
trains through XLA's gradient of the jnp ``ssd_chunked``.  The forward
wrapper :func:`ssd_scan` runs :class:`SsdScanFn` for CUDA tensors, so
serving and training take one kernel route.
"""
from __future__ import annotations

import ctypes
from ctypes import POINTER, Structure, c_int, c_void_p

import torch

from ._build import check, launch, load, route, stream
from .ref import ssd_chunk_len, ssd_chunked_ref

#: Launches of the kernel since the last :func:`reset_launches`.
launches = {"ssd_scan": 0, "ssd_scan_bwd": 0}

#: Largest chunk length and state size the kernel takes (C^T and B^T of a
#: chunk, B and (C B^T)^T sit in a block's shared memory: 128 x 132 floats
#: each).
MAX_CHUNK = 128
MAX_STATE = 128
#: Largest head dimension the backward takes.
MAX_HEAD_DIM_BWD = 64
#: Heads whose W one block of the backward sums (``HEAD_GROUP`` in
#: ``csrc/ssd_scan.cu``).
HEAD_GROUP = 10

_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    launches["ssd_scan"] = 0
    launches["ssd_scan_bwd"] = 0


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


class SsdBwdArgs(Structure):
    """Mirrors ``struct SsdBwdArgs`` in ``csrc/ssd_scan.cu``."""

    _fields_ = ([(n, c_void_p) for n in (
        "x", "dt", "A", "Bm", "Cm", "dy", "dfinal", "cbt", "cs", "st", "dx",
        "ddt", "dA", "dB", "dC", "gs", "dcs", "wg", "dAp")]
        + [(n, c_int) for n in ("Bb", "T", "H", "P", "N", "L")])


def _bwd_plan(Bb: int, T: int, H: int, P: int, N: int, L: int) -> dict:
    """The backward's float32 scratch, ``{name: shape}`` in the order of
    ``SsdBwdArgs``: each chunk's Q_c, then G_c; the intra part of dcs;
    W^T summed over each group of ``HEAD_GROUP`` heads, per (b, chunk);
    dA of each (b, h, chunk).  dB and dC have no per-head scratch."""
    if L > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM_BWD:
        raise ValueError(f"ssd_scan backward kernel: chunk length {L} (at "
                         f"most {MAX_CHUNK}), state size {N} (at most "
                         f"{MAX_STATE}), head dim {P} (at most "
                         f"{MAX_HEAD_DIM_BWD})")
    nc = T // L
    ng = -(-H // HEAD_GROUP)
    return {"gs": (Bb, H, nc, N, P), "dcs": (Bb, H, nc, L),
            "wg": (Bb, nc, ng, L, L), "dAp": (Bb, H, nc)}


def _declare(lib: ctypes.CDLL) -> None:
    lib.ssd_scan.argtypes = [POINTER(SsdArgs), c_int, c_int, c_void_p]
    lib.ssd_scan.restype = c_int
    lib.ssd_scan_bwd.argtypes = [POINTER(SsdBwdArgs), c_void_p]
    lib.ssd_scan_bwd.restype = c_int


def _check_shapes(x, dt, A, B_, C_) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 3 \
            or C_.shape != B_.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)}")
    Bb, T, H, P = x.shape
    if tuple(dt.shape) != (Bb, T, H) or tuple(A.shape) != (H,) \
            or tuple(B_.shape[:2]) != (Bb, T):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(B_.shape)}")
    if any(t.device != x.device for t in (dt, A, B_, C_)):
        raise ValueError("ssd_scan: inputs on different devices")


def _forward(x, dt, A, B_, C_, chunk: int) -> tuple:
    """(y, final state, the kernel's scratch ``{name: tensor}``); no
    scratch on the plain route."""
    _check_shapes(x, dt, A, B_, C_)
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    if x.dtype not in _TYPES or B_.dtype not in _TYPES \
            or C_.dtype != B_.dtype:
        raise TypeError(f"ssd_scan: x {x.dtype}, B {B_.dtype}, C {C_.dtype}")
    L = ssd_chunk_len(T, chunk)
    if route(x) == "plain":
        y, state = ssd_chunked_ref(x, dt, A, B_, C_, chunk)
        return y.to(x.dtype), state, {}
    plan = _plan(Bb, T, H, P, N, L)
    check("ssd_scan x", x, x.dtype)
    check("ssd_scan dt", dt, torch.float32)
    check("ssd_scan A", A, torch.float32)
    check("ssd_scan B", B_, B_.dtype)
    check("ssd_scan C", C_, B_.dtype)
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
               for name, shape in plan.items()}
    args = SsdArgs(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                   C_.data_ptr(), y.data_ptr(), state.data_ptr(),
                   *(t.data_ptr() for t in scratch.values()),
                   Bb, T, H, P, N, L)
    lib = load("ssd_scan", _declare)
    launch(lib.ssd_scan, ctypes.byref(args), int(x.dtype == torch.bfloat16),
           int(B_.dtype == torch.bfloat16), stream(x))
    launches["ssd_scan"] += 1
    return y, state, scratch


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 128):
    """x (B,T,H,P), dt (B,T,H), A (H,), B_/C_ (B,T,N), shared across heads.
    Returns (y (B,T,H,P) in ``x.dtype``, final state (B,H,N,P) float32).

    T must be a multiple of L = min(chunk, T).  x and B_/C_ are float32 or
    bfloat16; dt and A float32.  The kernel takes contiguous tensors, L
    and N up to 128.  CPU tensors run the plain scan, which autograd
    differentiates; CUDA tensors run :class:`SsdScanFn`, the kernel and
    its backward (float32 inputs where a gradient is taken).  One CUDA
    call adds one to ``launches["ssd_scan"]``."""
    _check_shapes(x, dt, A, B_, C_)
    if route(x) == "plain":
        y, state, _ = _forward(x, dt, A, B_, C_, chunk)
        return y, state
    return SsdScanFn.apply(x, dt, A, B_, C_, chunk)


def ssd_scan_bwd_plain(dy, x, dt, A, B_, C_, chunk: int, dfinal=None):
    """The backward's plain twin: autograd through
    :func:`.ref.ssd_chunked_ref`.  Returns (dx, ddt, dA, dB, dC), float32,
    shaped like the inputs; ``dfinal`` is the final state's gradient (or
    None)."""
    with torch.enable_grad():
        ins = [t.detach().to(torch.float32).requires_grad_(True)
               for t in (x, dt, A, B_, C_)]
        y, state = ssd_chunked_ref(*ins, chunk)
        outs, grads = [y], [dy]
        if dfinal is not None:
            outs.append(state)
            grads.append(dfinal)
        return torch.autograd.grad(outs, ins, grads)


def ssd_scan_bwd(dy, x, dt, A, B_, C_, chunk: int, *, scratch=None,
                 dfinal=None) -> tuple:
    """Gradients (dx, ddt, dA, dB, dC) of the scan's y (and, with
    ``dfinal``, its final state), float32, for the cotangent ``dy``
    (B,T,H,P) at float32 inputs.  CPU tensors run the plain twin
    (:func:`ssd_scan_bwd_plain`); CUDA tensors the kernel, which reads the
    forward's ``scratch`` (``_forward``'s third value) and raises without
    it.  One CUDA call adds one to ``launches["ssd_scan_bwd"]``."""
    _check_shapes(x, dt, A, B_, C_)
    if route(x) == "plain":
        return ssd_scan_bwd_plain(dy, x, dt, A, B_, C_, chunk, dfinal)
    if not scratch:
        raise ValueError("ssd_scan_bwd: the forward's scratch is needed")
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    L = ssd_chunk_len(T, chunk)
    plan = _bwd_plan(Bb, T, H, P, N, L)
    f32 = torch.float32
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B_), ("C", C_)):
        check(f"ssd_scan_bwd {name}", t, f32)
    check("ssd_scan_bwd dy", dy, f32, shape=x.shape, device=x.device)
    if dfinal is not None:
        check("ssd_scan_bwd dfinal", dfinal, f32, shape=(Bb, H, N, P),
              device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dB, dC = (torch.empty_like(A), torch.empty_like(B_),
                  torch.empty_like(C_))
    work = {name: torch.empty(shape, dtype=f32, device=x.device)
            for name, shape in plan.items()}
    ptr = lambda t: None if t is None else t.data_ptr()
    args = SsdBwdArgs(*(ptr(t) for t in (
        x, dt, A, B_, C_, dy, dfinal, scratch["cbt"], scratch["cs"],
        scratch["st"], dx, ddt, dA, dB, dC)),
        *(t.data_ptr() for t in work.values()), Bb, T, H, P, N, L)
    lib = load("ssd_scan", _declare)
    launch(lib.ssd_scan_bwd, ctypes.byref(args), stream(x))
    launches["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with a gradient: ``SsdScanFn.apply(x, dt, A, B_, C_,
    chunk) -> (y, final state)`` (B_/C_ shared across heads).  Forward:
    the kernel (the plain scan for CPU tensors), its scratch kept for the
    backward; backward: :func:`ssd_scan_bwd`, which takes float32 inputs
    and raises on others.  The final state's gradient is used when the
    caller gave one."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk):
        ins = [t.contiguous() for t in (x, dt, A, B_, C_)]
        y, state, scratch = _forward(*ins, chunk)
        ctx.chunk = chunk
        ctx.names = tuple(scratch)
        ctx.save_for_backward(*ins, *scratch.values())
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_, C_, *kept = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(dy.contiguous(), x, dt, A, B_, C_, ctx.chunk,
                             scratch=dict(zip(ctx.names, kept)),
                             dfinal=None if dstate is None
                             else dstate.contiguous())
        return (*grads, None)
