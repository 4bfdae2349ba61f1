"""RoCEv2 on the fabric: DCQCN rate control and go-back-N, batched over
flows.

The port of ``repro.sim.dcqcn_fab``.  The reference writes scalar
functions of one flow and ``vmap``s them; here every function takes
:class:`RoceFlow` / :class:`RoceRcv` / :class:`RoceMsg` tuples of ``[N]``
tensors and updates all flows at once:

  * **DCQCN** (Zhu et al., SIGCOMM'15): the receiver turns ECN marks into
    CNPs (at most one per ``cnp_interval_us`` per flow); the sender cuts
    ``rate *= 1 - alpha/2`` per CNP, ewma's alpha and recovers through
    fast recovery, additive and hyper increase, driven by the byte
    counter and the rate timer.
  * **Go-back-N**: the receiver accepts in-order PSNs only; a gap answers
    with a NACK carrying the expected PSN, and the sender rewinds
    ``psn_next`` to it.  An RTO rewinds to ``snd_una``.
  * One fixed path (entropy) per flow: one QP.

Float32 is held to the reference as XLA computes it on the CPU (see
:mod:`repro_torch.numerics`): the CNP's alpha update ``(1 - g) * alpha +
g`` is one fused multiply-add; the ACK/NACK deadline ``now + rto_us`` and
the pacing tolerance ``now + tick_us / 2`` are fused with the tick's
product (:func:`now_plus`), while the RTO's own re-arm ``now + rto_us``
in :func:`roce_on_timer` and ``now + size / rate`` are plain adds.  Times
in us, sizes in bytes, rates in bytes/us.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.params import DCQCNParams, NetworkSpec, RoCEParams
from ..numerics import f32, fma32, now_plus


@dataclasses.dataclass(frozen=True)
class RoceFabParams:
    """Scalars the RoCEv2 transitions close over."""

    dcqcn: DCQCNParams
    mtu_bytes: int
    line_rate_Bpus: float
    window_pkts: float         # static send window (lossless net): ~1 BDP
    rto_us: float
    ack_coalesce_pkts: int
    cnp_interval_us: float
    tick_us: float             # pacing comparisons tolerate half a tick


def make_roce_fab_params(net: NetworkSpec, rp: RoCEParams) -> RoceFabParams:
    return RoceFabParams(
        dcqcn=rp.dcqcn,
        mtu_bytes=net.mtu_bytes,
        line_rate_Bpus=net.rate_Bpus,
        window_pkts=net.bdp_pkts,
        rto_us=rp.rto_us,
        ack_coalesce_pkts=rp.ack_coalesce_pkts,
        cnp_interval_us=rp.dcqcn.cnp_interval_us,
        tick_us=net.mtu_serialize_us,
    )


class RoceFlow(NamedTuple):
    """Sender state: go-back-N window + DCQCN rate machine, [N] each."""

    snd_una: torch.Tensor        # i32: cumulative ack point
    psn_next: torch.Tensor       # i32
    total_pkts: torch.Tensor     # i32
    rate: torch.Tensor           # f32, bytes/us
    target: torch.Tensor         # f32, bytes/us (fast-recovery target)
    alpha: torch.Tensor          # f32: ECN ewma
    t_stage: torch.Tensor        # i32: rate-timer stages since last CNP
    b_stage: torch.Tensor        # i32: byte-counter stages since last CNP
    bytes_ctr: torch.Tensor      # f32
    last_rate_ts: torch.Tensor   # f32
    last_alpha_ts: torch.Tensor  # f32
    next_send_ts: torch.Tensor   # f32: pacing gate
    rto_deadline: torch.Tensor   # f32
    entropy: torch.Tensor        # i32: fixed path (one QP)
    retransmits: torch.Tensor    # i32
    tail_bytes: torch.Tensor     # f32: wire size of the final PSN
    max_psn: torch.Tensor        # i32: highest PSN ever sent + 1
    rto_fires: torch.Tensor      # i32
    gbn_rewinds: torch.Tensor    # i32: NACK-triggered rewinds


class RoceRcv(NamedTuple):
    """In-order-only receiver: cumulative ACKs, NACKs on gaps, CNPs."""

    epsn: torch.Tensor           # i32
    total_pkts: torch.Tensor     # i32
    since_ack: torch.Tensor      # i32: packets since the last ACK
    last_cnp_ts: torch.Tensor    # f32
    bytes_recvd: torch.Tensor    # f32


class RoceMsg(NamedTuple):
    """Return-pipe message: a CNP and an ACK/NACK may ride one slot."""

    valid: torch.Tensor          # bool: any of ack/nack/cnp present
    ack: torch.Tensor            # bool
    nack: torch.Tensor           # bool
    cnp: torch.Tensor            # bool
    epsn: torch.Tensor           # i32
    bytes_recvd: torch.Tensor    # f32


def init_roce_flow(p: RoceFabParams, total_pkts: torch.Tensor,
                   entropy: torch.Tensor, tail_bytes: torch.Tensor,
                   now: float = 0.0) -> RoceFlow:
    n, dev = total_pkts.shape[0], total_pkts.device
    f = lambda v: torch.full((n,), f32(v), dtype=torch.float32, device=dev)
    z = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)
    return RoceFlow(
        snd_una=z(), psn_next=z(), total_pkts=total_pkts.to(torch.int32),
        rate=f(p.line_rate_Bpus), target=f(p.line_rate_Bpus), alpha=f(1.0),
        t_stage=z(), b_stage=z(), bytes_ctr=f(0.0), last_rate_ts=f(now),
        last_alpha_ts=f(now), next_send_ts=f(now),
        rto_deadline=f(now + p.rto_us), entropy=entropy.to(torch.int32),
        retransmits=z(), tail_bytes=tail_bytes.to(torch.float32),
        max_psn=z(), rto_fires=z(), gbn_rewinds=z())


def init_roce_rcv(total_pkts: torch.Tensor) -> RoceRcv:
    n, dev = total_pkts.shape[0], total_pkts.device
    return RoceRcv(
        epsn=torch.zeros((n,), dtype=torch.int32, device=dev),
        total_pkts=total_pkts.to(torch.int32),
        since_ack=torch.zeros((n,), dtype=torch.int32, device=dev),
        last_cnp_ts=torch.full((n,), -1e18, dtype=torch.float32, device=dev),
        bytes_recvd=torch.zeros((n,), dtype=torch.float32, device=dev))


def empty_roce_msgs(h: int, n: int, device="cpu") -> RoceMsg:
    z = lambda dt: torch.zeros((h, n), dtype=dt, device=device)
    return RoceMsg(valid=z(torch.bool), ack=z(torch.bool),
                   nack=z(torch.bool), cnp=z(torch.bool),
                   epsn=z(torch.int32), bytes_recvd=z(torch.float32))


def roce_done(fs: RoceFlow) -> torch.Tensor:
    return fs.snd_una >= fs.total_pkts


def _window_open(fs: RoceFlow, p: RoceFabParams) -> torch.Tensor:
    """Unsent PSNs remain and the in-flight count is under the window
    (an int difference compared in f32 with the non-integral window)."""
    return (fs.psn_next < fs.total_pkts) & (
        (fs.psn_next - fs.snd_una).to(torch.float32) < f32(p.window_pkts))


def _increase(dc: DCQCNParams, rate, target, t_stage, b_stage, max_rate):
    """DCQCN phase step: hyper when BOTH counters passed F, additive when
    EITHER did, else fast recovery (rate -> (rate + target) / 2)."""
    hyper = torch.minimum(t_stage, b_stage) > dc.f_fast_recovery
    addi = torch.maximum(t_stage, b_stage) > dc.f_fast_recovery
    mx = f32(max_rate)
    target = torch.where(
        hyper, torch.clamp_max(target + f32(dc.hai_mbps), mx),
        torch.where(addi, torch.clamp_max(target + f32(dc.rai_mbps), mx),
                    target))
    rate = torch.clamp_max((rate + target) * 0.5, mx)
    return rate, target


def _select(mask: torch.Tensor, new: RoceFlow, old: RoceFlow) -> RoceFlow:
    return RoceFlow(*[torch.where(mask, n, o) for n, o in zip(new, old)])


def roce_next_packet(fs: RoceFlow, p: RoceFabParams, now: float):
    """on_sending_packet: window and pacing gate, byte-counter stage.

    Returns ``(new_state, (valid, psn, entropy, is_rtx))``; the caller
    commits ``new_state`` only for the flow its NIC selected."""
    dc = p.dcqcn
    can = (~roce_done(fs)) & _window_open(fs, p) & (
        now_plus(now, 0.5 * p.tick_us) >= fs.next_send_ts)
    psn = fs.psn_next
    # a PSN below the high-water mark is a go-back-N resend
    is_rtx = can & (psn < fs.max_psn)
    size = torch.where(psn >= fs.total_pkts - 1, fs.tail_bytes,
                       f32(p.mtu_bytes))
    bytes_ctr = fs.bytes_ctr + size
    b_hit = bytes_ctr >= f32(dc.byte_counter)
    b_stage = fs.b_stage + b_hit.to(torch.int32)
    inc_rate, inc_target = _increase(dc, fs.rate, fs.target, fs.t_stage,
                                     b_stage, p.line_rate_Bpus)
    rate = torch.where(b_hit, inc_rate, fs.rate)
    target = torch.where(b_hit, inc_target, fs.target)
    bytes_ctr = torch.where(b_hit, 0.0, bytes_ctr)
    next_send_ts = f32(now) + size / torch.clamp_min(rate, f32(1e-9))
    new = fs._replace(psn_next=psn + 1,
                      max_psn=torch.maximum(fs.max_psn, psn + 1),
                      rate=rate, target=target, b_stage=b_stage,
                      bytes_ctr=bytes_ctr, next_send_ts=next_send_ts)
    return _select(can, new, fs), (can, psn, fs.entropy, is_rtx)


def roce_on_ack(fs: RoceFlow, p: RoceFabParams, msg: RoceMsg,
                now: float) -> RoceFlow:
    """Apply one return-pipe message: the CNP's rate cut, then the
    ACK/NACK."""
    dc = p.dcqcn
    rto_at = now_plus(now, p.rto_us)
    now = f32(now)
    cnp = msg.valid & msg.cnp
    rate = torch.where(
        cnp, torch.clamp_min(fs.rate * (1 - fs.alpha * 0.5),
                             f32(dc.min_rate_Bpus)), fs.rate)
    target = torch.where(cnp, fs.rate, fs.target)
    alpha = torch.where(cnp, fma32(fs.alpha, f32(1 - dc.g),
                                   torch.full_like(fs.alpha, f32(dc.g))),
                        fs.alpha)
    t_stage = torch.where(cnp, 0, fs.t_stage)
    b_stage = torch.where(cnp, 0, fs.b_stage)
    bytes_ctr = torch.where(cnp, 0.0, fs.bytes_ctr)
    last_rate_ts = torch.where(cnp, now, fs.last_rate_ts)
    last_alpha_ts = torch.where(cnp, now, fs.last_alpha_ts)

    acked = msg.valid & (msg.ack | msg.nack)
    adv = acked & (msg.epsn > fs.snd_una)
    snd_una = torch.where(adv, msg.epsn, fs.snd_una)
    nack = msg.valid & msg.nack
    rewind_to = torch.maximum(snd_una, msg.epsn)
    retransmits = fs.retransmits + torch.where(
        nack, torch.clamp_min(fs.psn_next - msg.epsn, 0), 0)
    gbn_rewinds = fs.gbn_rewinds + (nack & (fs.psn_next > rewind_to)
                                    ).to(torch.int32)
    psn_next = torch.where(nack, rewind_to, fs.psn_next)
    rto_deadline = torch.where(adv | nack, rto_at, fs.rto_deadline)
    return fs._replace(
        snd_una=snd_una.to(torch.int32), psn_next=psn_next.to(torch.int32),
        rate=rate, target=target, alpha=alpha,
        t_stage=t_stage.to(torch.int32), b_stage=b_stage.to(torch.int32),
        bytes_ctr=bytes_ctr, last_rate_ts=last_rate_ts,
        last_alpha_ts=last_alpha_ts, rto_deadline=rto_deadline,
        retransmits=retransmits.to(torch.int32),
        gbn_rewinds=gbn_rewinds.to(torch.int32))


def roce_on_timer(fs: RoceFlow, p: RoceFabParams, now: float):
    """Alpha-decay and rate-increase timers, the RTO go-back-N rewind.

    Returns ``(new_state, emit_probe)``: RoCEv2 sends no probes, so the
    flag is all False."""
    dc = p.dcqcn
    now = f32(now)
    rto_at = f32(now + f32(p.rto_us))   # not fused (unlike roce_on_ack)
    active = ~roce_done(fs)
    alpha_due = active & (now - fs.last_alpha_ts >= f32(dc.alpha_timer_us))
    alpha = torch.where(alpha_due, f32(1 - dc.g) * fs.alpha, fs.alpha)
    last_alpha_ts = torch.where(alpha_due, now, fs.last_alpha_ts)

    rate_due = active & (now - fs.last_rate_ts >= f32(dc.rate_timer_us))
    t_stage = fs.t_stage + rate_due.to(torch.int32)
    inc_rate, inc_target = _increase(dc, fs.rate, fs.target, t_stage,
                                     fs.b_stage, p.line_rate_Bpus)
    rate = torch.where(rate_due, inc_rate, fs.rate)
    target = torch.where(rate_due, inc_target, fs.target)
    last_rate_ts = torch.where(rate_due, now, fs.last_rate_ts)

    rto = active & (now >= fs.rto_deadline)
    psn_next = torch.where(rto, fs.snd_una, fs.psn_next)
    rto_deadline = torch.where(rto, rto_at, fs.rto_deadline)
    # a rewind re-sends [snd_una, psn_next), counted as the NACK path does
    retransmits = fs.retransmits + torch.where(
        rto, torch.clamp_min(fs.psn_next - fs.snd_una, 0), 0)
    return fs._replace(
        alpha=alpha, last_alpha_ts=last_alpha_ts, rate=rate, target=target,
        t_stage=t_stage, last_rate_ts=last_rate_ts, psn_next=psn_next,
        rto_deadline=rto_deadline, retransmits=retransmits.to(torch.int32),
        rto_fires=fs.rto_fires + rto.to(torch.int32)), torch.zeros_like(rto)


def roce_next_event(fs: RoceFlow, p: RoceFabParams):
    """(next timer event time, next pacing release time) per flow for the
    event-horizon loop: the earliest of the RTO deadline and the
    alpha/rate timers, and the pacing gate while the window is open."""
    dc = p.dcqcn
    inf = float("inf")
    active = ~roce_done(fs)
    timer_ev = torch.minimum(
        fs.rto_deadline,
        torch.minimum(fs.last_alpha_ts + f32(dc.alpha_timer_us),
                      fs.last_rate_ts + f32(dc.rate_timer_us)))
    return (torch.where(active, timer_ev, inf),
            torch.where(active & _window_open(fs, p), fs.next_send_ts, inf))


def roce_on_data(rs: RoceRcv, p: RoceFabParams, psn: torch.Tensor,
                 size: torch.Tensor, ecn: torch.Tensor, now: float):
    """Receiver: cumulative ACK (coalesced), NACK on a gap, paced CNP on
    an ECN mark.  Returns ``(new_receiver, msg)``."""
    now = f32(now)
    cnp = ecn & (now - rs.last_cnp_ts >= f32(p.cnp_interval_us))
    last_cnp_ts = torch.where(cnp, now, rs.last_cnp_ts)
    inorder = psn == rs.epsn
    dup = psn < rs.epsn
    ooo = psn > rs.epsn
    epsn = torch.where(inorder, rs.epsn + 1, rs.epsn).to(torch.int32)
    bytes_recvd = rs.bytes_recvd + torch.where(
        inorder, size.to(torch.float32), 0.0)
    since_ack = rs.since_ack + inorder.to(torch.int32)
    ack = (inorder & ((since_ack >= p.ack_coalesce_pkts)
                      | (epsn >= rs.total_pkts))) | dup
    since_ack = torch.where(inorder & ack, 0, since_ack).to(torch.int32)
    msg = RoceMsg(valid=ack | ooo | cnp, ack=ack, nack=ooo, cnp=cnp,
                  epsn=epsn, bytes_recvd=bytes_recvd)
    return RoceRcv(epsn=epsn, total_pkts=rs.total_pkts, since_ack=since_ack,
                   last_cnp_ts=last_cnp_ts, bytes_recvd=bytes_recvd), msg
