"""ctypes bindings of the CUDA kernels' C entry points.

The structs below mirror, field for field, the ones declared in
``csrc/transition.cu`` and ``csrc/serve_enqueue.cu``; the kernels take
pointers from ``Tensor.data_ptr()`` and PyTorch's current stream.  Every
output and scratch buffer is allocated here with ``torch.empty``, after
the inputs' device, dtype, shape and contiguity are checked.
"""
from __future__ import annotations

import ctypes
from ctypes import POINTER, Structure, c_float, c_int, c_void_p

import torch

from ..core.cc import CCState
from ..core.lb import SprayState
from ..core.reliability import REORDER_WINDOW, RelState, SackMsg
from ..core.transport import FlowState, TxPacket
from ..numerics import Now, f32, now_plus, recip32
from .fabric_kernels import PktQ, _check, _launch, _stream, rank_in_queue


def _ptrs(name, fields):
    return type(name, (Structure,), {"_fields_": [(f, c_void_p)
                                                  for f in fields]})


class TransParams(Structure):
    _fields_ = ([(n, c_int) for n in ("t", "timer_tick", "N", "NH", "NR",
                                      "P", "B")]
                + [(n, c_float) for n in (
                    "now", "probe_at", "rto_at", "mtu", "tq", "th",
                    "ewma_keep", "ewma", "beta", "alpha", "gamma", "eta",
                    "max_cwnd", "min_cwnd", "max_cwnd_div8", "mtu_recip",
                    "two_base_rtt", "reset_after", "min_ooo", "eps")])


_FLOW_FIELDS = (CCState._fields + SprayState._fields + RelState._fields)
FlowPtrs = _ptrs("FlowPtrs", _FLOW_FIELDS)
SackPtrs = _ptrs("SackPtrs", SackMsg._fields)
TxPtrs = _ptrs("TxPtrs", TxPacket._fields)


class TransOut(Structure):
    _fields_ = [("tx", TxPtrs), ("probe", TxPtrs), ("probe_valid", c_void_p),
                ("sel", c_void_p), ("can_tx", c_void_p)]


TransScratch = _ptrs("TransScratch", (
    "best", "score", "np_psn_next", "np_bytes_sent", "np_clear",
    "np_bitmap", "np_rr", "np_last_reset"))


class ServeParams(Structure):
    _fields_ = ([(n, c_int) for n in ("t", "Q", "TS", "T", "S", "N", "M",
                                      "cap", "K", "data_drop", "hard")]
                + [(n, c_float) for n in ("now", "kmin", "krecip",
                                          "t_dither", "mtu", "ack_bytes")])


_RING_FIELDS = ("flow", "psn", "ts", "probe", "ecn", "ent", "ready", "spine")
Ring = _ptrs("Ring", _RING_FIELDS)
Cands = _ptrs("Cands", ("qid", "valid", "flow", "psn", "ts", "probe", "ecn",
                        "ent", "spine"))
ServeIn = _ptrs("ServeIn", (
    "qhead", "qsize", "dst", "dst_tor", "total_pkts", "tail_b", "tx_psn",
    "probe_psn", "ent_d", "ent_p", "spine_d", "spine_p", "sel",
    "probe_valid", "inj_q", "inj_qp"))


class ServeOut(Structure):
    _fields_ = [("pop", Ring), ("has", c_void_p), ("ecn_out", c_void_p),
                ("pop_bytes", c_void_p), ("qhead", c_void_p),
                ("qsize", c_void_p), ("qsize1", c_void_p)]


def declare(name: str, lib: ctypes.CDLL) -> None:
    """Set argtypes/restype of one library's entry points."""
    P = POINTER
    if name == "rank":
        lib.rank_in_queue.argtypes = [c_void_p] * 4 + [c_int, c_int,
                                                       c_void_p]
        lib.rank_in_queue.restype = c_int
    elif name == "transition":
        lib.strack_transition.argtypes = [
            P(TransParams), P(FlowPtrs), P(SackPtrs), c_void_p, c_void_p,
            P(FlowPtrs), P(TransOut), P(TransScratch), c_void_p]
        lib.strack_transition.restype = c_int
    elif name == "serve_enqueue":
        lib.se_serve.argtypes = [P(ServeParams), P(Ring), P(ServeIn),
                                 P(ServeOut), P(Cands), c_void_p]
        lib.se_accept.argtypes = [P(ServeParams), P(Cands), c_void_p,
                                  c_void_p, c_void_p, c_void_p, c_void_p]
        lib.se_place.argtypes = [P(ServeParams), P(Cands), c_void_p,
                                 c_void_p, c_void_p, c_void_p, P(Ring),
                                 c_void_p, c_void_p]
        for fn in (lib.se_serve, lib.se_accept, lib.se_place):
            fn.restype = c_int
    else:
        raise ValueError(name)


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def _struct(cls, tensors):
    return cls(*[_p(t) for t in tensors])


def _flat(flows: FlowState):
    return list(flows.cc) + list(flows.spray) + list(flows.rel)


def transition(lib, flows: FlowState, due: SackMsg, sendable, src, t: int,
               d):
    """Launch ``strack_transition``; same contract as
    ``fabric_kernels.flow_transition_plain``."""
    p = d.p
    dev = sendable.device
    n, P, B, W = sendable.shape[0], p.max_paths, p.sack_bitmap_bits, \
        REORDER_WINDOW
    f32t, i32, bt, i8 = torch.float32, torch.int32, torch.bool, torch.int8
    want = dict(bitmap=(i8, (n, P)), rr=(i32, (n,)),
                next_path_id=(i32, (n,)), sacked=(bt, (n, W)),
                claimed=(bt, (n, W)), epsn=(i32, (n,)),
                psn_next=(i32, (n,)), total_pkts=(i32, (n,)),
                in_recovery=(bt, (n,)), recover_high=(i32, (n,)),
                rto_fires=(i32, (n,)), recoveries=(i32, (n,)))
    for name, t_ in zip(_FLOW_FIELDS, _flat(flows)):
        dt, shape = want.get(name, (f32t, (n,)))
        _check(f"flows.{name}", t_, dt, shape, dev)
    due_want = dict(valid=bt, epsn=i32, sack_base=i32, sack_bits=bt,
                    bytes_recvd=f32t, ooo_cnt=i32, ecn=bt, entropy=i32,
                    ts=f32t, probe_reply=bt)
    for name, t_ in zip(SackMsg._fields, due):
        shape = (n, B) if name == "sack_bits" else (n,)
        _check(f"due.{name}", t_, due_want[name], shape, dev)

    out_leaves = [torch.empty_like(x) for x in _flat(flows)]
    nc, ns = len(CCState._fields), len(SprayState._fields)
    out = FlowState(cc=CCState(*out_leaves[:nc]),
                    spray=SprayState(*out_leaves[nc:nc + ns]),
                    rel=RelState(*out_leaves[nc + ns:]))
    e = lambda dt: torch.empty((n,), dtype=dt, device=dev)
    tx = TxPacket(e(bt), e(i32), e(i32), e(bt), e(bt))
    ptx = TxPacket(e(bt), e(i32), e(i32), e(bt), e(bt))
    probe_valid, sel, can_tx = e(bt), e(bt), e(bt)
    scratch = [torch.empty((d.n_hosts,), dtype=i32, device=dev), e(i32),
               e(i32), e(f32t), e(i32),
               torch.empty((n, 8), dtype=i32, device=dev), e(i32), e(f32t)]

    now = Now(t, d.tick_us)
    prm = TransParams(
        t=t, timer_tick=int(t % d.timer_every == 0), N=n, NH=d.n_hosts,
        NR=d.n_real, P=P, B=B, now=float(now),
        probe_at=now_plus(now, p.probe_rtts * p.base_rtt_us),
        rto_at=now_plus(now, p.rto_us), mtu=f32(p.mtu_bytes),
        tq=f32(p.target_qdelay_us), th=f32(p.target_qhigh_us),
        ewma_keep=f32(1 - p.ewma), ewma=f32(p.ewma), beta=f32(p.beta_pkts),
        alpha=f32(p.alpha_pkts_per_us), gamma=f32(p.gamma),
        eta=f32(p.eta_pkts), max_cwnd=f32(p.max_cwnd_pkts),
        min_cwnd=f32(p.min_cwnd_pkts),
        max_cwnd_div8=f32(p.max_cwnd_pkts / 8),
        mtu_recip=recip32(p.mtu_bytes), two_base_rtt=f32(2 * p.base_rtt_us),
        reset_after=f32(p.bitmap_reset_rtts * p.base_rtt_us),
        min_ooo=float(p.min_ooo_threshold), eps=f32(1e-9))
    o = TransOut(tx=_struct(TxPtrs, tx), probe=_struct(TxPtrs, ptx),
                 probe_valid=_p(probe_valid), sel=_p(sel),
                 can_tx=_p(can_tx))
    _launch(lib.strack_transition, ctypes.byref(prm),
          ctypes.byref(_struct(FlowPtrs, _flat(flows))),
          ctypes.byref(_struct(SackPtrs, due)), _p(sendable), _p(src),
          ctypes.byref(_struct(FlowPtrs, out_leaves)), ctypes.byref(o),
          ctypes.byref(_struct(TransScratch, scratch)), _stream(sendable))
    return out, tx, ptx, probe_valid, sel, can_tx


def serve_enqueue(lib, q, qhead, qsize, dst, dst_tor, total_pkts, tail_b,
                  tx_psn, probe_psn, ent_d, ent_p, spine, spine_p, sel,
                  probe_valid, inj_q, inj_qp, t: int, d):
    """Launch the serve/enqueue chain; same contract as
    ``fabric_kernels.serve_enqueue_plain`` (ring updated in place)."""
    T, S, NH, N, cap = d.n_tor, d.n_spine, d.n_hosts, d.n_flows, d.cap
    TS = T * S
    Q = 2 * TS + NH
    M = 2 * TS + 2 * N
    dev = qhead.device
    i32, f32t, bt = torch.int32, torch.float32, torch.bool
    ring_dt = (i32, i32, f32t, bt, bt, i32, i32, i32)
    for name, f, dt in zip(_RING_FIELDS, q, ring_dt):
        _check(f"q.{name}", f, dt, (Q + 1, cap), dev)
    _check("qhead", qhead, i32, (Q + 1,), dev)
    _check("qsize", qsize, i32, (Q + 1,), dev)
    for name, t_, dt in (("dst", dst, i32), ("dst_tor", dst_tor, i32),
                         ("total_pkts", total_pkts, i32),
                         ("tail_b", tail_b, f32t), ("tx_psn", tx_psn, i32),
                         ("probe_psn", probe_psn, i32), ("ent_d", ent_d, i32),
                         ("ent_p", ent_p, i32), ("spine", spine, i32),
                         ("spine_p", spine_p, i32), ("sel", sel, bt),
                         ("probe_valid", probe_valid, bt),
                         ("inj_q", inj_q, i32), ("inj_qp", inj_qp, i32)):
        _check(name, t_, dt, (N,), dev)

    pop = PktQ(*[torch.empty((Q,), dtype=dt, device=dev) for dt in ring_dt])
    has = torch.empty((Q,), dtype=bt, device=dev)
    ecn_out = torch.empty((Q,), dtype=bt, device=dev)
    pop_bytes = torch.empty((Q,), dtype=f32t, device=dev)
    qhead_o, qsize_o, qsize1 = [torch.empty((Q + 1,), dtype=i32, device=dev)
                                for _ in range(3)]
    cdt = (i32, bt, i32, i32, f32t, bt, bt, i32, i32)
    cands = [torch.empty((M,), dtype=dt, device=dev) for dt in cdt]
    cand_qid, cand_valid = cands[0], cands[1]
    kmin, kmax = d.kmin_p, d.kmax_p
    prm = ServeParams(
        t=t, Q=Q, TS=TS, T=T, S=S, N=N, M=M, cap=cap, K=d.K,
        data_drop=d.data_drop_pkts, hard=d.hard_pkts,
        now=float(Now(t, d.tick_us)), kmin=f32(kmin),
        krecip=recip32(max(kmax - kmin, 1e-9)),
        t_dither=f32(f32(t) * f32(12.9898)), mtu=f32(d.mtu_bytes),
        ack_bytes=f32(64))
    ring = _struct(Ring, q)
    c = _struct(Cands, cands)
    stream = _stream(qhead)
    _launch(lib.se_serve, ctypes.byref(prm), ctypes.byref(ring),
          ctypes.byref(_struct(ServeIn, (
              qhead, qsize, dst, dst_tor, total_pkts, tail_b, tx_psn,
              probe_psn, ent_d, ent_p, spine, spine_p, sel, probe_valid,
              inj_q, inj_qp))),
          ctypes.byref(ServeOut(_struct(Ring, pop), _p(has), _p(ecn_out),
                                _p(pop_bytes), _p(qhead_o), _p(qsize_o),
                                _p(qsize1))),
          ctypes.byref(c), stream)

    rank_v = rank_in_queue(cand_qid, cand_valid, Q)
    accept = torch.empty((M,), dtype=bt, device=dev)
    drops = torch.empty((), dtype=i32, device=dev)
    _launch(lib.se_accept, ctypes.byref(prm), ctypes.byref(c), _p(rank_v),
          _p(qsize1), _p(accept), _p(drops), stream)
    rank_a = rank_in_queue(cand_qid, accept, Q)
    _launch(lib.se_place, ctypes.byref(prm), ctypes.byref(c), _p(accept),
          _p(rank_a), _p(qhead_o), _p(qsize1), ctypes.byref(ring),
          _p(qsize_o), stream)
    return (qhead_o, qsize_o, pop, has, ecn_out, pop_bytes, cand_qid, accept,
            drops)
