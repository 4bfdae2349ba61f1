"""ctypes bindings of the CUDA kernels' C entry points.

The structs below mirror, field for field, the ones declared in
``csrc/transition.cu``, ``csrc/transition_roce.cu`` and
``csrc/serve_enqueue.cu``; the kernels take
pointers from ``Tensor.data_ptr()`` and PyTorch's current stream.  Every
output and scratch buffer is allocated here, cut from one allocation per
dtype (``_carve``), after the inputs' device, dtype, shape and contiguity
are checked.
"""
from __future__ import annotations

import ctypes
import functools
import math
from ctypes import POINTER, Structure, c_float, c_int, c_void_p

import torch

from ..core.cc import CCState
from ..core.lb import SprayState
from ..core.reliability import REORDER_WINDOW, RelState, SackMsg
from ..core.transport import FlowState, TxPacket
from ..numerics import Now, f32, now_plus, recip32
from ..sim.dcqcn_fab import RoceFlow, RoceMsg
from .fabric_kernels import (PfcState, PktQ, _check, _launch, _stream,
                             row_chunk)

#: Fixed bucket slots of a queue in the serve kernel (``kBucket`` of
#: ``csrc/serve_enqueue.cu``).
BUCKET = 16
#: Counters a warp of the PFC kernel holds: HPT + S and T at most this
#: (``32 kRows``).
PFC_WARP_COUNTERS = 128
#: The most entries a batched serve/enqueue call takes (``kMaxBatch`` of
#: ``csrc/serve_enqueue.cu``: a block's counters of every entry).
MAX_BATCH = 1024


def _ptrs(name, fields):
    return type(name, (Structure,), {"_fields_": [(f, c_void_p)
                                                  for f in fields]})


class TransParams(Structure):
    _fields_ = ([(n, c_int) for n in ("t", "timer_tick", "N", "L", "NB",
                                      "NR", "P", "B", "FE")]
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
                ("sel", c_void_p), ("can_tx", c_void_p),
                ("done_lane", c_void_p)]


class RoceParams(Structure):
    _fields_ = ([(n, c_int) for n in ("t", "timer_tick", "N", "L", "NB",
                                      "NR", "F", "FE")]
                + [(n, c_float) for n in (
                    "now", "pace_at", "rto_at", "rto_rearm", "window", "mtu",
                    "byte_counter", "hai", "rai", "max_rate", "min_rate",
                    "keep", "g", "alpha_timer", "rate_timer", "eps")])


RoceFlowPtrs = _ptrs("RoceFlowPtrs", RoceFlow._fields)
RoceMsgPtrs = _ptrs("RoceMsgPtrs", RoceMsg._fields)


class ServeParams(Structure):
    _fields_ = ([(n, c_int) for n in ("t", "Q", "TS", "T", "S", "N", "L",
                                      "M", "cap", "K", "data_drop", "hard",
                                      "fseed", "B")]
                + [(n, c_float) for n in ("now", "kmin", "krecip",
                                          "t_dither", "mtu", "ack_bytes")])


_RING_FIELDS = ("flow", "psn", "ts", "probe", "ecn", "ent", "ready", "spine")
Ring = _ptrs("Ring", _RING_FIELDS)
ServeIn = _ptrs("ServeIn", (
    "qhead", "qsize", "dst", "dst_tor", "total_pkts", "tail_b", "tx_psn",
    "probe_psn", "ent_d", "ent_p", "spine_d", "spine_p", "sel",
    "probe_valid", "inj_q", "inj_qp", "paused_row", "row_down", "row_duty",
    "row_cor_p", "lane_flow", "live"))


class ServeOut(Structure):
    _fields_ = [("pop", Ring)] + [(n, c_void_p) for n in (
        "has", "ecn_out", "pop_bytes", "qhead", "qsize", "surv", "cand_qid",
        "accept", "cand_bytes", "counts")]


ServeScratch = _ptrs("ServeScratch", ("cnt", "fixed", "over", "stage"))


class PfcParams(Structure):
    _fields_ = ([(n, c_int) for n in ("Q", "TS", "T", "S", "NH", "HPT", "N",
                                      "L", "cap", "PD", "line_row", "cS",
                                      "cHPT", "cT", "B")]
                + [(n, c_float) for n in ("buf", "alpha", "inv", "xon", "mtu",
                                          "ack_bytes")])


PfcIn = _ptrs("PfcIn", (
    "has", "pop_flow", "pop_bytes", "pop_spine", "accept", "cand_bytes",
    "ring_flow", "ring_psn", "ring_probe", "qhead", "qsize0", "qsize", "src",
    "src_tor", "same_tor", "total_pkts", "tail_b", "by_src", "src_start",
    "lanes", "live"))
PfcPtrs = _ptrs("PfcPtrs", PfcState._fields)


def declare(name: str, lib: ctypes.CDLL) -> None:
    """Set argtypes/restype of one library's entry points."""
    P = POINTER
    if name == "rank":
        lib.rank_in_queue.argtypes = [c_void_p] * 4 + [c_int, c_int,
                                                       c_void_p]
        lib.rank_in_queue.restype = c_int
    elif name == "transition":
        lib.strack_transition.argtypes = [
            P(TransParams), P(FlowPtrs), P(SackPtrs)] + [c_void_p] * 7 + [
            P(FlowPtrs), P(TransOut), c_void_p]
        lib.strack_transition.restype = c_int
    elif name == "transition_roce":
        lib.roce_transition.argtypes = [
            P(RoceParams), P(RoceFlowPtrs), P(RoceMsgPtrs)] + [c_void_p] * 7 + [
            P(RoceFlowPtrs), P(TransOut), c_void_p]
        lib.roce_transition.restype = c_int
    elif name == "serve_enqueue":
        lib.se_serve_enqueue.argtypes = [P(ServeParams), P(Ring), P(ServeIn),
                                         P(ServeOut), P(ServeScratch),
                                         c_void_p]
        lib.se_pfc.argtypes = [P(PfcParams), P(PfcIn), P(PfcPtrs),
                               P(PfcPtrs), c_void_p]
        lib.se_draw.argtypes = [c_int, c_void_p, c_void_p, c_void_p,
                                c_void_p, c_int, c_void_p]
        lib.se_floor.argtypes = [c_int, c_int, c_void_p]
        for fn in (lib.se_serve_enqueue, lib.se_pfc, lib.se_draw,
                   lib.se_floor):
            fn.restype = c_int
    else:
        raise ValueError(name)


def _p(t) -> int:
    """A tensor's device pointer; ``None`` is the null pointer."""
    return 0 if t is None else t.data_ptr()


def _struct(cls, tensors):
    return cls(*[_p(t) for t in tensors])


def _flat(flows: FlowState):
    return list(flows.cc) + list(flows.spray) + list(flows.rel)


def _lane_args(sendable, src, act_idx):
    """Check the lane inputs of a transition launch: ``sendable`` (bool[N])
    on the dense program, ``act_idx`` (i32[A]) under the active set."""
    n, dev = src.shape[0], src.device
    if (act_idx is None) == (sendable is None):
        raise ValueError("transition: pass sendable (dense) or act_idx "
                         "(active set), not both")
    if act_idx is None:
        _check("sendable", sendable, torch.bool, (n,), dev)
    else:
        _check("act_idx", act_idx, torch.int32, (act_idx.shape[0],), dev)
    _check("src", src, torch.int32, (n,), dev)
    return n, dev


def _outputs(record, dev, lanes: int, active: bool):
    """A transition launch's outputs, cut from one allocation per dtype:
    a fresh flow record shaped as ``record`` (a flat list of its leaves;
    ``None`` under the active set, which updates the record in place), and
    the per-lane ``tx, probe_tx, probe_valid, sel, can_tx, done_lane``
    (``done_lane`` None on the dense program)."""
    bt, i32 = torch.bool, torch.int32
    spec = [(x.dtype, tuple(x.shape)) for x in record or ()]
    lane_dt = [bt, i32, i32, bt, bt] * 2 + [bt] * (4 if active else 3)
    parts = _carve(dev, spec + [(dt, (lanes,)) for dt in lane_dt])
    fresh, lane = parts[:len(spec)], parts[len(spec):]
    return (fresh, TxPacket(*lane[:5]), TxPacket(*lane[5:10]), lane[10],
            lane[11], lane[12], lane[13] if active else None)


def _launch_transition(fn, prm, flows_in, due, sendable, src, eff_nic,
                       live, act_idx, index, flows_out, outs, ptrs_cls,
                       msg_cls):
    """One launch of a transition entry point (``fn``) on PyTorch's current
    stream."""
    tx, ptx, probe_valid, sel, can_tx, done = outs
    o = TransOut(tx=_struct(TxPtrs, tx), probe=_struct(TxPtrs, ptx),
                 probe_valid=_p(probe_valid), sel=_p(sel),
                 can_tx=_p(can_tx), done_lane=_p(done))
    _launch(fn, ctypes.byref(prm), ctypes.byref(_struct(ptrs_cls, flows_in)),
            ctypes.byref(_struct(msg_cls, due)), _p(sendable), _p(eff_nic),
            _p(live), _p(act_idx), _p(index.by_src), _p(index.src_sorted),
            _p(index.blocks), ctypes.byref(_struct(ptrs_cls, flows_out)),
            ctypes.byref(o), _stream(src))


def _entry_args(n: int, entry, dev) -> tuple:
    """``(FE, live)`` of a transition launch: one program's (``entry``
    None: FE = N, no mask), or a batch's ``(flows an entry, live bool[B]
    or None)`` over its flattened record of N = B FE flows."""
    if entry is None:
        return n, None
    fe, live = entry
    if fe <= 0 or n % fe:
        raise ValueError(f"transition: {n} flows are not whole entries of "
                         f"{fe}")
    if live is not None:
        _check("live", live, torch.bool, (n // fe,), dev)
    return fe, live


def transition(lib, flows: FlowState, due: SackMsg, sendable, src, t: int,
               d, eff_nic=None, index=None, act_idx=None, entry=None):
    """Launch ``strack_transition`` (one launch); same contract as
    ``fabric_kernels.flow_transition_plain``, or under the active set
    (``act_idx``, ``sendable`` None) as
    ``fabric_kernels.flow_transition_active_plain``: the flow record is
    then updated in place and ``done_lane`` returned last.  ``index`` is
    the program's ``SrcIndex``; ``entry`` a batch's ``(flows an entry,
    live)`` (``fabric_kernels.flow_transition_batch``)."""
    p = d.p
    n, dev = _lane_args(sendable, src, act_idx)
    fe, live = _entry_args(n, entry, dev)
    P, B, W = p.max_paths, p.sack_bitmap_bits, REORDER_WINDOW
    f32t, i32, bt, i8 = torch.float32, torch.int32, torch.bool, torch.int8
    want = dict(bitmap=(i8, (n, P)), rr=(i32, (n,)),
                next_path_id=(i32, (n,)), sacked=(bt, (n, W)),
                claimed=(bt, (n, W)), epsn=(i32, (n,)),
                psn_next=(i32, (n,)), total_pkts=(i32, (n,)),
                in_recovery=(bt, (n,)), recover_high=(i32, (n,)),
                rto_fires=(i32, (n,)), recoveries=(i32, (n,)))
    flat = _flat(flows)
    for name, t_ in zip(_FLOW_FIELDS, flat):
        dt, shape = want.get(name, (f32t, (n,)))
        _check(f"flows.{name}", t_, dt, shape, dev)
        if name in ("sacked", "claimed") and t_.data_ptr() % 16:
            raise ValueError(f"flows.{name}: the kernel moves a ledger row "
                             f"16 bytes a lane; its storage must be 16-byte "
                             f"aligned")
    due_want = dict(valid=bt, epsn=i32, sack_base=i32, sack_bits=bt,
                    bytes_recvd=f32t, ooo_cnt=i32, ecn=bt, entropy=i32,
                    ts=f32t, probe_reply=bt)
    for name, t_ in zip(SackMsg._fields, due):
        shape = (n, B) if name == "sack_bits" else (n,)
        _check(f"due.{name}", t_, due_want[name], shape, dev)

    active = act_idx is not None
    lanes = act_idx.shape[0] if active else n
    fresh, *outs = _outputs(None if active else flat, dev, lanes, active)
    if active:
        out_leaves, out = flat, flows   # in place
    else:
        nc, ns = len(CCState._fields), len(SprayState._fields)
        out_leaves = fresh
        out = FlowState(cc=CCState(*fresh[:nc]),
                        spray=SprayState(*fresh[nc:nc + ns]),
                        rel=RelState(*fresh[nc + ns:]))
    now = Now(t, d.tick_us)
    prm = TransParams(
        t=t, timer_tick=int(t % d.timer_every == 0), N=n, L=lanes,
        NB=index.blocks.shape[0] - 1,
        NR=d.n_real, P=P, B=B, FE=fe, now=float(now),
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
    _launch_transition(lib.strack_transition, prm, flat, due, sendable, src,
                       eff_nic, live, act_idx, index, out_leaves, outs,
                       FlowPtrs, SackPtrs)
    res = (out, *outs[:5])
    return res + (outs[5],) if active else res


_ROCE_INT = ("snd_una", "psn_next", "total_pkts", "t_stage", "b_stage",
             "entropy", "retransmits", "max_psn", "rto_fires", "gbn_rewinds")


def transition_roce(lib, flows: RoceFlow, due: RoceMsg, sendable, src,
                    t: int, d, eff_nic=None, index=None, act_idx=None,
                    entry=None):
    """Launch ``roce_transition`` (one launch); same contract as
    ``fabric_kernels.flow_transition_plain`` under the RoCEv2 record, or,
    with ``act_idx``, as ``flow_transition_active_plain`` (in place);
    ``entry`` as :func:`transition`'s."""
    p = d.p
    dc = p.dcqcn
    n, dev = _lane_args(sendable, src, act_idx)
    fe, live = _entry_args(n, entry, dev)
    f32t, i32, bt = torch.float32, torch.int32, torch.bool
    for name, t_ in zip(RoceFlow._fields, flows):
        _check(f"flows.{name}", t_, i32 if name in _ROCE_INT else f32t,
               (n,), dev)
    for name, t_, dt in zip(RoceMsg._fields, due,
                            (bt, bt, bt, bt, i32, f32t)):
        _check(f"due.{name}", t_, dt, (n,), dev)
    active = act_idx is not None
    lanes = act_idx.shape[0] if active else n
    fresh, *outs = _outputs(None if active else list(flows), dev, lanes,
                            active)
    out = flows if active else RoceFlow(*fresh)  # in place under the cap
    now = Now(t, d.tick_us)
    prm = RoceParams(
        t=t, timer_tick=int(t % d.timer_every == 0), N=n, L=lanes,
        NB=index.blocks.shape[0] - 1,
        NR=d.n_real, F=dc.f_fast_recovery, FE=fe, now=float(now),
        pace_at=now_plus(now, 0.5 * p.tick_us), rto_at=now_plus(now, p.rto_us),
        rto_rearm=f32(float(now) + f32(p.rto_us)), window=f32(p.window_pkts), mtu=f32(p.mtu_bytes),
        byte_counter=f32(dc.byte_counter), hai=f32(dc.hai_mbps),
        rai=f32(dc.rai_mbps), max_rate=f32(p.line_rate_Bpus),
        min_rate=f32(dc.min_rate_Bpus), keep=f32(1 - dc.g), g=f32(dc.g),
        alpha_timer=f32(dc.alpha_timer_us), rate_timer=f32(dc.rate_timer_us),
        eps=f32(1e-9))
    _launch_transition(lib.roce_transition, prm, flows, due, sendable, src,
                       eff_nic, live, act_idx, index, out, outs, RoceFlowPtrs,
                       RoceMsgPtrs)
    res = (out, *outs[:5])
    return res + (outs[5],) if active else res


@functools.lru_cache(maxsize=64)
def _layout(spec: tuple) -> tuple:
    """``spec``'s pieces grouped by dtype: ``((dtype, total, indices,
    sizes, shapes), ...)``."""
    groups = {}
    for i, (dt, shape) in enumerate(spec):
        groups.setdefault(dt, []).append((i, math.prod(shape), shape))
    return tuple((dt, sum(n for _, n, _ in g), tuple(i for i, _, _ in g),
                  [n for _, n, _ in g], tuple(sh for _, _, sh in g))
                 for dt, g in groups.items())


def _carve(dev, spec):
    """Tensors of ``spec``'s ``(dtype, shape)`` pairs, cut from one
    allocation per dtype (``split``: one call for all the views)."""
    out = [None] * len(spec)
    for dt, total, idx, sizes, shapes in _layout(tuple(spec)):
        pieces = torch.empty((total,), dtype=dt, device=dev).split(sizes)
        for i, piece, shape in zip(idx, pieces, shapes):
            out[i] = piece if len(shape) == 1 else piece.view(shape)
    return out


def serve_enqueue(lib, q, qhead, qsize, dst, dst_tor, total_pkts, tail_b,
                  tx_psn, probe_psn, ent_d, ent_p, spine, spine_p, sel,
                  probe_valid, inj_q, inj_qp, t: int, d, paused_row=None,
                  row_down=None, row_duty=None, row_cor_p=None, fseed=None,
                  lane_flow=None, live=None, batch=None):
    """Launch ``se_serve_enqueue`` (one launch); same contract as
    ``fabric_kernels.serve_enqueue_plain`` (ring updated in place), or,
    with ``batch`` = B, as ``serve_enqueue_batch_plain``: every input but
    the fault rows with a leading axis B, ``live`` (bool[B] or None) the
    entries that step."""
    T, S, NH, N, cap = d.n_tor, d.n_spine, d.n_hosts, d.n_flows, d.cap
    TS = T * S
    Q = 2 * TS + NH
    lead = () if batch is None else (batch,)
    nb = 1 if batch is None else batch
    if not 1 <= nb <= MAX_BATCH:
        raise ValueError(f"serve_enqueue: a batch of 1 to {MAX_BATCH} "
                         f"entries, got {nb}")
    L = N if lane_flow is None else lane_flow.shape[-1]
    M = 2 * TS + 2 * L
    dev = qhead.device
    i32, f32t, bt = torch.int32, torch.float32, torch.bool
    ring_dt = (i32, i32, f32t, bt, bt, i32, i32, i32)
    for name, f, dt in zip(_RING_FIELDS, q, ring_dt):
        _check(f"q.{name}", f, dt, lead + (Q + 1, cap), dev)
    _check("qhead", qhead, i32, lead + (Q + 1,), dev)
    _check("qsize", qsize, i32, lead + (Q + 1,), dev)
    for name, t_, dt in (("dst", dst, i32), ("dst_tor", dst_tor, i32),
                         ("total_pkts", total_pkts, i32),
                         ("tail_b", tail_b, f32t)):
        _check(name, t_, dt, lead + (N,), dev)
    for name, t_, dt in (("tx_psn", tx_psn, i32),
                         ("probe_psn", probe_psn, i32), ("ent_d", ent_d, i32),
                         ("ent_p", ent_p, i32), ("spine", spine, i32),
                         ("spine_p", spine_p, i32), ("sel", sel, bt),
                         ("probe_valid", probe_valid, bt),
                         ("inj_q", inj_q, i32), ("inj_qp", inj_qp, i32)):
        _check(name, t_, dt, lead + (L,), dev)
    if lane_flow is not None:
        _check("lane_flow", lane_flow, i32, lead + (L,), dev)
    if paused_row is not None:
        _check("paused_row", paused_row, bt, lead + (Q,), dev)
    for name, t_, dt in (("row_down", row_down, bt),
                         ("row_duty", row_duty, bt),
                         ("row_cor_p", row_cor_p, f32t)):
        if t_ is not None:   # one schedule for a batch
            _check(name, t_, dt, (Q,), dev)
    if live is not None:
        _check("live", live, bt, (nb,), dev)
    if row_cor_p is not None and not (
            isinstance(fseed, int) and 0 <= fseed < 2 ** 31):
        raise ValueError(f"fseed: expected the draw's 31-bit seed with "
                         f"row_cor_p, got {fseed!r}")
    faulted = any(x is not None for x in (row_down, row_duty, row_cor_p))

    (pflow, ppsn, pent, pready, pspine, qhead_o, qsize_o, cand_qid, counts,
     pts, pop_bytes, cand_bytes, cnt, fixed, over, stage, pprobe, pecn, has,
     ecn_out, accept, surv) = _carve(
        dev, [(i32, lead + (Q,))] * 5 + [(i32, lead + (Q + 1,))] * 2
        + [(i32, lead + (M,)), (i32, lead + (3,)), (f32t, lead + (Q,)),
           (f32t, lead + (Q,)), (f32t, lead + (M,)), (i32, (nb * (Q + 3),)),
           (i32, (nb * (Q + 1) * BUCKET,)), (i32, (nb * M,)),
           (i32, (nb * 2 * M,))]
        + [(bt, lead + (Q,))] * 4
        + [(bt, lead + (M,)), (bt, lead + (Q if faulted else 0,))])
    pop = PktQ(pflow, ppsn, pts, pprobe, pecn, pent, pready, pspine)
    kmin, kmax = d.kmin_p, d.kmax_p
    prm = ServeParams(
        t=t, Q=Q, TS=TS, T=T, S=S, N=N, L=L, M=M, cap=cap, K=d.K,
        data_drop=d.data_drop_pkts, hard=d.hard_pkts,
        fseed=fseed if row_cor_p is not None else 0, B=nb,
        now=float(Now(t, d.tick_us)), kmin=f32(kmin),
        krecip=recip32(max(kmax - kmin, 1e-9)),
        t_dither=f32(f32(t) * f32(12.9898)), mtu=f32(d.mtu_bytes),
        ack_bytes=f32(64))
    _launch(lib.se_serve_enqueue, ctypes.byref(prm),
            ctypes.byref(_struct(Ring, q)),
            ctypes.byref(_struct(ServeIn, (
                qhead, qsize, dst, dst_tor, total_pkts, tail_b, tx_psn,
                probe_psn, ent_d, ent_p, spine, spine_p, sel, probe_valid,
                inj_q, inj_qp, paused_row, row_down, row_duty, row_cor_p,
                lane_flow, live))),
            ctypes.byref(ServeOut(
                _struct(Ring, pop), *[_p(x) for x in (
                    has, ecn_out, pop_bytes, qhead_o, qsize_o,
                    surv if faulted else None, cand_qid, accept, cand_bytes,
                    counts)])),
            ctypes.byref(_struct(ServeScratch, (cnt, fixed, over, stage))),
            _stream(qhead))
    bh_add, cor_add = ((counts[..., 1], counts[..., 2]) if faulted
                       else (None, None))
    return (qhead_o, qsize_o, pop, has, ecn_out, pop_bytes, cand_qid, accept,
            counts[..., 0], cand_bytes, surv if faulted else has, bh_add,
            cor_add)


def fault_draw(lib, seed: int, row, t, psn):
    """The serve kernel's corruption draw (``fault_u01`` of
    ``csrc/serve_enqueue.cu``) at each key ``(seed, row[i], t[i],
    psn[i])``: one launch of a kernel that evaluates only the draw, for
    holding it against ``sim.faults.fault_u01``."""
    n = row.shape[0]
    dev = row.device
    for name, t_ in (("row", row), ("t", t), ("psn", psn)):
        _check(name, t_, torch.int32, (n,), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch(lib.se_draw, int(seed), _p(row), _p(t), _p(psn), _p(out), n,
            _stream(row))
    return out


def launch_floor(lib, device, blocks: int = 0, n_sync: int = 0) -> None:
    """One launch of nothing, for the card's launch floor: an empty kernel
    of one warp (``blocks`` 0), or the one-launch kernels' persistent
    launch of ``blocks`` blocks that does ``n_sync`` grid-wide barriers and
    nothing else.  Not a wrapper: it counts no launch."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    _launch(lib.se_floor, blocks, n_sync, stream)


def pfc_account(lib, st: PfcState, has, pop, pop_bytes, cand_qid,
                cand_bytes, accept, q, qhead, qsize0, qsize, t: int, fl, d,
                lanes=None, live=None, batch=None):
    """Launch ``se_pfc`` (one launch); same contract as
    ``fabric_kernels.pfc_account_plain``, or, with ``batch`` = B, as
    ``pfc_account_batch_plain`` (every input with a leading axis B, ``fl``
    from ``pfc_flows_batch``, ``live`` the entries that step)."""
    T, S, NH, HPT = d.n_tor, d.n_spine, d.n_hosts, d.hosts_per_tor
    TS = T * S
    Q = 2 * TS + NH
    lead = () if batch is None else (batch,)
    nb = 1 if batch is None else batch
    N = fl.src.shape[-1]
    L = N if lanes is None else lanes.shape[0]
    M = cand_qid.shape[-1]
    cap = q.flow.shape[-1]
    dev = has.device
    i32, f32t, bt = torch.int32, torch.float32, torch.bool
    shapes = dict(qbytes=(f32t, (Q + 1,)), ing_host=(f32t, (NH,)),
                  ing_sd=(f32t, (S, T)), ing_up=(f32t, (T, S)),
                  paused_nic=(bt, (NH,)), paused_sd=(bt, (S, T)),
                  paused_up=(bt, (T, S)),
                  pfc_line=(bt, (max(d.PD, 1), NH + 2 * TS)),
                  pauses=(i32, ()))
    for name, t_ in zip(PfcState._fields, st):
        dt, shape = shapes[name]
        _check(f"pfc.{name}", t_, dt, lead + shape, dev)
    for name, t_, dt, shape in (
            ("has", has, bt, (Q,)), ("pop.flow", pop.flow, i32, (Q,)),
            ("pop_bytes", pop_bytes, f32t, (Q,)),
            ("pop.spine", pop.spine, i32, (Q,)),
            ("accept", accept, bt, (M,)), ("cand_bytes", cand_bytes, f32t,
                                           (M,)),
            ("q.flow", q.flow, i32, (Q + 1, cap)),
            ("q.psn", q.psn, i32, (Q + 1, cap)),
            ("q.probe", q.probe, bt, (Q + 1, cap)),
            ("qhead", qhead, i32, (Q + 1,)), ("qsize0", qsize0, i32, (Q + 1,)),
            ("qsize", qsize, i32, (Q + 1,)), ("src", fl.src, i32, (N,)),
            ("src_tor", fl.src_tor, i32, (N,)),
            ("same_tor", fl.same_tor, bt, (N,)),
            ("total_pkts", fl.total_pkts, i32, (N,)),
            ("tail_b", fl.tail_b, f32t, (N,)), ("by_src", fl.by_src, i32, (N,)),
            ("src_start", fl.src_start, i32, (NH + 1,))):
        _check(name, t_, dt, lead + shape, dev)
    if lanes is not None:
        if batch is not None:
            raise ValueError("pfc_account: a batch has no active-set lanes")
        _check("lanes", lanes, i32, (L,), dev)
    if live is not None:
        _check("live", live, bt, (nb,), dev)
    if M != 2 * TS + 2 * L:
        raise ValueError(f"cand_qid: expected {2 * TS + 2 * L} candidates, "
                         f"got {M}")
    if HPT + S > PFC_WARP_COUNTERS or T > PFC_WARP_COUNTERS:
        raise ValueError(f"pfc_account: a ToR's hosts and spines ({HPT} + "
                         f"{S}) and the ToRs ({T}) must each be at most "
                         f"{PFC_WARP_COUNTERS}, the counters one warp holds")
    out = PfcState(*_carve(dev, [(x.dtype, tuple(x.shape)) for x in st]))
    prm = PfcParams(Q=Q, TS=TS, T=T, S=S, NH=NH, HPT=HPT, N=N, L=L, cap=cap,
                    PD=d.PD, line_row=t % d.PD if d.PD > 0 else 0,
                    cS=row_chunk(S), cHPT=row_chunk(HPT), cT=row_chunk(T),
                    B=nb, buf=f32(d.buffer_bytes), alpha=f32(d.alpha),
                    inv=recip32(1 + d.alpha), xon=f32(d.xon_frac),
                    mtu=f32(d.mtu_bytes), ack_bytes=f32(64))
    pin = PfcIn(*[_p(x) for x in (
        has, pop.flow, pop_bytes, pop.spine, accept, cand_bytes, q.flow,
        q.psn, q.probe, qhead, qsize0, qsize, fl.src, fl.src_tor,
        fl.same_tor, fl.total_pkts, fl.tail_b, fl.by_src, fl.src_start,
        lanes, live)])
    _launch(lib.se_pfc, ctypes.byref(prm), ctypes.byref(pin),
            ctypes.byref(_struct(PfcPtrs, st)),
            ctypes.byref(_struct(PfcPtrs, out)), _stream(has))
    return out
