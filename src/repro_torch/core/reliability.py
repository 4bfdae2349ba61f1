"""Section 3.3 — STrack reliability, batched over flows.

The port of ``repro.core.reliability``: the receiver keeps a ``W``-bit
arrival bitmap anchored at EPSN, the sender keeps ``W``-bit sacked/claimed
bitmaps, each a ``bool[N, W]`` tensor.  Every PSN is a full MTU except the
message's final PSN, whose wire size is the message's odd tail
(``RelState.tail_bytes``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics import f32, now_plus
from .params import STrackParams

REORDER_WINDOW = 512  # W: receiver/sender reorder window, packets


class SackMsg(NamedTuple):
    """The SACK wire format of Fig. 7 (plus echoed path/ts/ecn)."""

    valid: torch.Tensor        # bool: was a SACK emitted
    epsn: torch.Tensor         # i32
    sack_base: torch.Tensor    # i32
    sack_bits: torch.Tensor    # bool[..., sack_bitmap_bits]
    bytes_recvd: torch.Tensor  # f32
    ooo_cnt: torch.Tensor      # i32
    ecn: torch.Tensor          # bool (echoed)
    entropy: torch.Tensor      # i32 (echoed)
    ts: torch.Tensor           # f32 (echoed send timestamp)
    probe_reply: torch.Tensor  # bool


class ReceiverState(NamedTuple):
    epsn: torch.Tensor              # i32
    bitmap: torch.Tensor            # bool[N, W] relative to epsn
    bytes_recvd: torch.Tensor       # f32, deduplicated
    bytes_since_sack: torch.Tensor  # f32
    lpsn: torch.Tensor              # i32, -1 = invalid
    total_pkts: torch.Tensor        # i32


def init_receiver(total_pkts: torch.Tensor) -> ReceiverState:
    n, dev = total_pkts.shape[0], total_pkts.device
    z = lambda dt: torch.zeros((n,), dtype=dt, device=dev)
    return ReceiverState(
        epsn=z(torch.int32),
        bitmap=torch.zeros((n, REORDER_WINDOW), dtype=torch.bool, device=dev),
        bytes_recvd=z(torch.float32),
        bytes_since_sack=z(torch.float32),
        lpsn=torch.full((n,), -1, dtype=torch.int32, device=dev),
        total_pkts=total_pkts.to(torch.int32),
    )


def _cols(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _shift_left(bitmap: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """bitmap[f] <<= shift[f] (toward index 0), zero-filled."""
    w = bitmap.shape[1]
    src = _cols(w, bitmap.device)[None, :] + shift[:, None]
    return bitmap.gather(1, src.clamp(max=w - 1).long()) & (src < w)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first set entry per row (0 when none), like argmax."""
    return mask.to(torch.uint8).argmax(1).to(torch.int32)


def receiver_on_data(rs: ReceiverState, p: STrackParams, psn, size, ecn,
                     entropy, ts, is_probe) -> tuple[ReceiverState, SackMsg]:
    """Process one data/probe packet per row; maybe emit a SACK."""
    W, B = REORDER_WINDOW, p.sack_bitmap_bits
    dev = psn.device
    rel = psn - rs.epsn
    relc = rel.clamp(0, W - 1)
    inwin = (rel >= 0) & (rel < W)
    cols = _cols(W, dev)[None, :]
    at_rel = cols == relc[:, None]
    bit_rel = (rs.bitmap & at_rel).any(1)
    already = torch.where(rel < 0, True, bit_rel & inwin)
    new = (~already) & inwin & (~is_probe)

    bitmap = rs.bitmap | (at_rel & new[:, None])
    got = torch.where(new, size, 0.0)
    bytes_recvd = rs.bytes_recvd + got
    bytes_since_sack = rs.bytes_since_sack + got

    # advance EPSN past the contiguous prefix of arrivals
    all_set = bitmap.all(1)
    shift = torch.where(bitmap[:, 0],
                        torch.where(all_set, W, _first_true(~bitmap)),
                        0).to(torch.int32)
    epsn = rs.epsn + shift
    bitmap = _shift_left(bitmap, shift)

    lpsn = torch.where(new & ((rs.lpsn < 0) | (psn < rs.lpsn)), psn, rs.lpsn)
    trigger = ((bytes_since_sack >= f32(p.ack_coalesce_bytes))
               | (new & (rel == 0)) | is_probe | (epsn >= rs.total_pkts))

    # SACK segment containing the lowest PSN since the last SACK
    lpsn_eff = torch.maximum(torch.where(lpsn < 0, epsn, lpsn), epsn)
    seg = torch.div(lpsn_eff - epsn, B, rounding_mode="floor")
    base = epsn + seg * B
    off = (base - epsn).clamp(0, W)
    src = off[:, None] + _cols(B, dev)[None, :]
    sack_bits = bitmap.gather(1, src.clamp(max=W - 1).long()) & (src < W)

    sack = SackMsg(
        valid=trigger,
        epsn=epsn,
        sack_base=base.to(torch.int32),
        sack_bits=sack_bits,
        bytes_recvd=bytes_recvd,
        ooo_cnt=bitmap.sum(1, dtype=torch.int32),
        ecn=ecn,
        entropy=entropy.to(torch.int32),
        ts=ts,
        probe_reply=is_probe,
    )
    new_rs = ReceiverState(
        epsn=epsn,
        bitmap=bitmap,
        bytes_recvd=bytes_recvd,
        bytes_since_sack=torch.where(trigger, 0.0, bytes_since_sack),
        lpsn=torch.where(trigger, -1, lpsn).to(torch.int32),
        total_pkts=rs.total_pkts,
    )
    return new_rs, sack


class RelState(NamedTuple):
    """Sender-side reliability ledger (Section 3.3.2)."""

    epsn: torch.Tensor              # i32: receiver's cumulative ack point
    sacked: torch.Tensor            # bool[N, W] rel. to epsn
    claimed: torch.Tensor           # bool[N, W]: declared lost, not re-sent
    psn_next: torch.Tensor          # i32
    total_pkts: torch.Tensor        # i32
    tail_bytes: torch.Tensor        # f32: wire size of the final PSN
    bytes_sent: torch.Tensor        # f32
    bytes_recvd_seen: torch.Tensor  # f32
    bytes_claimed: torch.Tensor     # f32
    in_recovery: torch.Tensor       # bool
    recover_high: torch.Tensor      # i32
    probe_deadline: torch.Tensor    # f32
    rto_deadline: torch.Tensor      # f32
    done_ts: torch.Tensor           # f32, -1 until done
    rto_fires: torch.Tensor         # i32
    recoveries: torch.Tensor        # i32


def init_rel(p: STrackParams, total_pkts: torch.Tensor,
             tail_bytes: torch.Tensor, now: float = 0.0) -> RelState:
    n, dev = total_pkts.shape[0], total_pkts.device
    W = REORDER_WINDOW
    z = lambda dt: torch.zeros((n,), dtype=dt, device=dev)
    full = lambda v, dt: torch.full((n,), v, dtype=dt, device=dev)
    return RelState(
        epsn=z(torch.int32),
        sacked=torch.zeros((n, W), dtype=torch.bool, device=dev),
        claimed=torch.zeros((n, W), dtype=torch.bool, device=dev),
        psn_next=z(torch.int32),
        total_pkts=total_pkts.to(torch.int32),
        tail_bytes=tail_bytes.to(torch.float32),
        bytes_sent=z(torch.float32),
        bytes_recvd_seen=z(torch.float32),
        bytes_claimed=z(torch.float32),
        in_recovery=z(torch.bool),
        recover_high=full(-1, torch.int32),
        probe_deadline=full(f32(now + p.probe_rtts * p.base_rtt_us),
                            torch.float32),
        rto_deadline=full(f32(now + p.rto_us), torch.float32),
        done_ts=full(-1.0, torch.float32),
        rto_fires=z(torch.int32),
        recoveries=z(torch.int32),
    )


def inflight_bytes(rel: RelState) -> torch.Tensor:
    return rel.bytes_sent - rel.bytes_recvd_seen - rel.bytes_claimed


def rel_done(rel: RelState) -> torch.Tensor:
    return rel.epsn >= rel.total_pkts


def pkt_wire_bytes(rel: RelState, p: STrackParams,
                   psn: torch.Tensor) -> torch.Tensor:
    """Wire size of one data PSN: full MTU, except the odd tail packet."""
    return torch.where(psn >= rel.total_pkts - 1, rel.tail_bytes,
                       f32(p.mtu_bytes))


def _mask_wire_bytes(mask: torch.Tensor, epsn: torch.Tensor, rel: RelState,
                     p: STrackParams) -> torch.Tensor:
    """Total wire bytes of the PSNs flagged in ``mask`` (a W-bitmap
    anchored at ``epsn``): full MTUs except the message's final PSN."""
    W = mask.shape[1]
    n = mask.sum(1, dtype=torch.int32).to(torch.float32)
    tail_rel = rel.total_pkts - 1 - epsn
    tail_in = (tail_rel >= 0) & (tail_rel < W)
    tail_flag = mask.gather(1, tail_rel.clamp(0, W - 1)[:, None].long()
                            )[:, 0] & tail_in
    mtu = f32(p.mtu_bytes)
    return n * mtu - torch.where(tail_flag, mtu - rel.tail_bytes, 0.0)


def _enter_recovery(rel: RelState, p: STrackParams, high: torch.Tensor,
                    enter: torch.Tensor) -> RelState:
    """Declare unsacked/unclaimed packets in [epsn, high) lost."""
    W = REORDER_WINDOW
    cols = _cols(W, rel.epsn.device)[None, :]
    high = torch.maximum(rel.recover_high, high)
    span = cols < (high - rel.epsn).clamp(0, W)[:, None]
    lost = (span & (~rel.sacked) & (~rel.claimed)
            & ((cols + rel.epsn[:, None]) < rel.psn_next[:, None]))
    lost = lost & enter[:, None]
    return rel._replace(
        claimed=rel.claimed | lost,
        bytes_claimed=rel.bytes_claimed + _mask_wire_bytes(lost, rel.epsn,
                                                           rel, p),
        in_recovery=rel.in_recovery | enter,
        recover_high=torch.where(enter, high, rel.recover_high),
    )


def rel_on_sack(rel: RelState, p: STrackParams, sack: SackMsg,
                cwnd_pkts: torch.Tensor, achieved_bdp_pkts: torch.Tensor,
                qdelay: torch.Tensor, now: float
                ) -> tuple[RelState, torch.Tensor]:
    """Apply one SACK per flow. Returns (new_state, newly_acked_bytes)."""
    W = REORDER_WINDOW
    probe_at = now_plus(now, p.probe_rtts * p.base_rtt_us)
    rto_at = now_plus(now, p.rto_us)
    now = f32(now)
    dev = rel.epsn.device
    cols = _cols(W, dev)[None, :]

    # probe-based loss detection (Algo 1 line 13)
    probe_loss = (sack.probe_reply & (qdelay < f32(2 * p.base_rtt_us))
                  & (achieved_bdp_pkts == 0.0) & (~rel_done(rel)))

    # cumulative advance
    shift = (sack.epsn - rel.epsn).clamp(0, W).to(torch.int32)
    advanced = shift > 0
    unclaim_out = rel.claimed & (cols < shift[:, None])
    sacked = _shift_left(rel.sacked, shift)
    claimed = _shift_left(rel.claimed, shift)
    epsn = rel.epsn + shift
    bytes_claimed = rel.bytes_claimed - _mask_wire_bytes(unclaim_out,
                                                         rel.epsn, rel, p)

    # selective bits, placed at offset sack_base - epsn (stale: dropped)
    off = sack.sack_base - epsn
    nbits = sack.sack_bits.shape[1]
    k = cols - off.clamp(0, W)[:, None]
    placed = (sack.sack_bits.gather(1, k.clamp(0, nbits - 1).long())
              & (k >= 0) & (k < nbits) & (off >= 0)[:, None])
    newly = placed & (~sacked)
    unclaim_sel = newly & claimed
    bytes_claimed = bytes_claimed - _mask_wire_bytes(unclaim_sel, epsn,
                                                     rel, p)
    sacked = sacked | placed
    claimed = claimed & (~unclaim_sel)

    acked_bytes = torch.clamp_min(sack.bytes_recvd - rel.bytes_recvd_seen,
                                  0.0)
    bytes_recvd_seen = torch.maximum(rel.bytes_recvd_seen, sack.bytes_recvd)

    in_recovery0 = rel.in_recovery
    rel = rel._replace(
        epsn=epsn, sacked=sacked, claimed=claimed,
        bytes_claimed=bytes_claimed, bytes_recvd_seen=bytes_recvd_seen,
        probe_deadline=torch.full_like(rel.probe_deadline, probe_at),
        rto_deadline=torch.where(advanced, rto_at, rel.rto_deadline),
    )

    # OOO-based loss detection
    thresh = torch.clamp_min(cwnd_pkts, float(p.min_ooo_threshold))
    any_sacked = sacked.any(1)
    last1 = (sacked.to(torch.int32) * (cols + 1)).amax(1)
    high_sacked = epsn + last1
    ooo_loss = (sack.ooo_cnt.to(torch.float32) > thresh) & sack.valid
    enter = ooo_loss | probe_loss
    high = torch.where(probe_loss, rel.psn_next,
                       torch.where(any_sacked, high_sacked, epsn))
    fresh_entry = enter & (~in_recovery0)
    rel = _enter_recovery(rel, p, high, enter)
    rel = rel._replace(recoveries=rel.recoveries + fresh_entry.to(torch.int32))

    # recovery exit
    exit_rec = rel.in_recovery & (rel.epsn >= rel.recover_high)
    rel = rel._replace(
        in_recovery=rel.in_recovery & (~exit_rec),
        recover_high=torch.where(exit_rec, -1, rel.recover_high
                                 ).to(torch.int32),
        done_ts=torch.where(rel_done(rel) & (rel.done_ts < 0), now,
                            rel.done_ts),
    )
    return rel, acked_bytes


def rel_next_psn(rel: RelState, p: STrackParams, cwnd_pkts: torch.Tensor):
    """Pick the next PSN per flow. Returns (state, psn, is_rtx, valid)."""
    W = REORDER_WINDOW
    has_rtx = rel.claimed.any(1)
    window_ok = inflight_bytes(rel) < cwnd_pkts * f32(p.mtu_bytes)
    seq_ok = rel.psn_next - rel.epsn < W
    has_new = (rel.psn_next < rel.total_pkts) & seq_ok
    valid = (~rel_done(rel)) & window_ok & (has_rtx | has_new)

    rtx_rel = _first_true(rel.claimed)
    use_rtx = valid & has_rtx
    psn = torch.where(use_rtx, rel.epsn + rtx_rel, rel.psn_next)
    cols = _cols(W, rel.epsn.device)[None, :]
    claimed = rel.claimed & ~((cols == rtx_rel[:, None]) & use_rtx[:, None])
    psn_next = torch.where(valid & (~has_rtx), rel.psn_next + 1, rel.psn_next)
    bytes_sent = rel.bytes_sent + torch.where(
        valid, pkt_wire_bytes(rel, p, psn), 0.0)
    return (rel._replace(claimed=claimed, psn_next=psn_next,
                         bytes_sent=bytes_sent),
            psn, use_rtx, valid)


def rel_on_timer(rel: RelState, p: STrackParams, now: float
                 ) -> tuple[RelState, torch.Tensor]:
    """RTO + probe timers. Returns (state, send_probe)."""
    probe_at = now_plus(now, p.probe_rtts * p.base_rtt_us)
    rto_at = now_plus(now, p.rto_us)
    now = f32(now)
    active = ~rel_done(rel)
    rto = active & (now >= rel.rto_deadline)
    rel = _enter_recovery(rel, p, rel.psn_next, rto)
    rel = rel._replace(
        rto_deadline=torch.where(rto, rto_at, rel.rto_deadline),
        rto_fires=rel.rto_fires + rto.to(torch.int32))
    probe = active & (~rto) & (now >= rel.probe_deadline)
    rel = rel._replace(
        probe_deadline=torch.where(probe, probe_at, rel.probe_deadline))
    return rel, probe
