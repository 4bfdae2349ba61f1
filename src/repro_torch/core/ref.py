"""Pure-Python reference implementation of the STrack transport (the oracle).

The port's copy of ``repro.core.ref`` (same code, same f64 arithmetic):
the per-host engines of the event-driven network simulator
(``repro_torch.sim.events``), so that the port's event oracle equals the
reference's bit for bit.  It imports only the port's ``core.params``; it
uses no torch.

This mirrors Algorithms 1-4 and Section 3.3 of the paper exactly, in plain
Python with unbounded containers.

Pseudocode reconciliation (documented deviation): the OCR'd Algorithm 2
listing flips the bitmap polarity relative to the prose ("STrack keeps a
simple bitmap for the entropies that have experienced ECN marks ... Next
non-marked entropy in a round robin manner is used").  We follow the prose:
``bitmap[p] == 1`` means path ``p`` saw an ECN mark (bad); CHOOSE_PATH
round-robins over unmarked entries, clearing the first skipped mark per
packet ("one packet only clears one bit").  ``next_path_id`` uses -1 as the
invalid sentinel so entropy 0 is usable.

Units: time in microseconds, sizes in bytes, cwnd in packets (float).
"""
from __future__ import annotations

import math
from typing import Optional

from .params import ACK_WIRE_BYTES, DCQCNParams, STrackParams

# ---------------------------------------------------------------------------
# Packets
# ---------------------------------------------------------------------------

DATA, SACK, PROBE, NACK, CNP = "data", "sack", "probe", "nack", "cnp"
ACK_SIZE = ACK_WIRE_BYTES  # bytes on the wire for SACK/NACK/CNP/probe


class Packet:
    """Wire packet. One object per packet in flight (event sim reuses it)."""

    __slots__ = (
        "kind", "flow", "psn", "size", "entropy", "ecn", "ts",
        "is_probe_reply", "epsn", "sack_base", "sack_bitmap", "bytes_recvd",
        "ooo_cnt", "src", "dst", "rtx",
        "_route", "_hop", "_ingress",  # used by sim/events.py routing
    )

    def __init__(self, kind, flow, psn, size, entropy, ts, src=-1, dst=-1):
        self.kind = kind
        self.flow = flow
        self.psn = psn
        self.size = size
        self.entropy = entropy
        self.ecn = False
        self.ts = ts
        self.is_probe_reply = False
        self.epsn = 0
        self.sack_base = 0
        self.sack_bitmap = 0
        self.bytes_recvd = 0
        self.ooo_cnt = 0
        self.src = src
        self.dst = dst
        self.rtx = False

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Packet({self.kind} f={self.flow} psn={self.psn} "
                f"e={self.entropy} ecn={self.ecn})")


# ---------------------------------------------------------------------------
# Adaptive load balancing (Algorithm 2)
# ---------------------------------------------------------------------------

class SprayState:
    """STrack adaptive packet spray state: one bitmap + rr pointer + hint."""

    __slots__ = ("bitmap", "rr", "next_path_id", "last_reset_ts", "p")

    def __init__(self, p: STrackParams, now: float = 0.0):
        self.p = p
        self.bitmap = [0] * p.max_paths  # 1 = ECN-marked (bad) path
        self.rr = 0
        self.next_path_id = -1           # -1 = invalid
        self.last_reset_ts = now

    def update_ecn_bitmap(self, ecn: bool, path_id: int) -> None:
        if ecn:
            self.next_path_id = -1
            self.bitmap[path_id] = 1
        else:
            self.next_path_id = path_id
            self.bitmap[path_id] = 0

    def choose_path(self, cwnd_pkts: float, now: float) -> int:
        # Periodic staleness reset ("bitmap is reset after 1-2 RTTs").
        if now - self.last_reset_ts > self.p.bitmap_reset_rtts * self.p.base_rtt_us:
            self.bitmap = [0] * self.p.max_paths
            self.last_reset_ts = now
        if self.next_path_id >= 0:
            self.rr = self.next_path_id
            self.next_path_id = -1
            return self.rr
        paths = min(self.p.max_paths, int(2 * cwnd_pkts))
        paths = max(8, paths)
        self.rr = (self.rr + 1) % paths
        cleared = False
        scanned = 0
        while self.bitmap[self.rr] != 0:
            # one packet only clears one bit
            if not cleared:
                self.bitmap[self.rr] = 0
                cleared = True
            self.rr = (self.rr + 1) % paths
            scanned += 1
            if scanned > paths:  # all marked: bitmap now has one cleared bit
                break
        return self.rr


# ---------------------------------------------------------------------------
# Congestion control (Algorithms 3 & 4)
# ---------------------------------------------------------------------------

class CCState:
    """Sender congestion-control state: one window across all paths."""

    __slots__ = (
        "p", "cwnd", "base_rtt", "avg_delay", "last_decrease_ts",
        "last_selfai_ts", "achieved_bdp_pkts", "rx_count_bytes",
        "rxcount_clear_ts",
    )

    def __init__(self, p: STrackParams, now: float = 0.0):
        self.p = p
        self.cwnd = p.max_cwnd_pkts      # start at max (~BDP)
        self.base_rtt = p.base_rtt_us    # min observed RTT
        self.avg_delay = 0.0
        self.last_decrease_ts = now
        self.last_selfai_ts = now
        self.achieved_bdp_pkts = 0.0
        self.rx_count_bytes = 0.0
        self.rxcount_clear_ts = now

    # -- Algorithm 4 -------------------------------------------------------
    def update_achieved_bdp(self, acked_bytes: float, ack_for_probe: bool,
                            now: float) -> float:
        can_clear = (now - self.rxcount_clear_ts) > (
            self.base_rtt + self.p.target_qdelay_us)
        self.rx_count_bytes += 0.0 if ack_for_probe else acked_bytes
        if can_clear:
            self.achieved_bdp_pkts = self.rx_count_bytes / self.p.mtu_bytes
            self.rxcount_clear_ts = now
            self.rx_count_bytes = 0.0
        return self.achieved_bdp_pkts

    # -- Algorithm 3 -------------------------------------------------------
    def adjust_cwnd(self, ecn: bool, delay: float, achieved_bdp_pkts: float,
                    now: float) -> float:
        p = self.p
        can_decrease = now - self.last_decrease_ts > self.base_rtt
        can_fairness = now - self.last_selfai_ts > self.base_rtt
        self.avg_delay = self.avg_delay * (1 - p.ewma) + p.ewma * delay
        if not ecn and delay > p.target_qhigh_us:
            # queue drained behind a late packet: avoid starvation
            self.cwnd = self.cwnd + p.beta_pkts / self.cwnd
        elif not ecn and delay < p.target_qdelay_us:
            self.cwnd = self.cwnd + p.alpha_pkts_per_us * (
                p.target_qdelay_us - delay) / self.cwnd
        elif can_decrease and self.avg_delay > p.target_qdelay_us:
            if (delay > p.target_qhigh_us
                    and achieved_bdp_pkts < p.max_cwnd_pkts / 8):
                self.cwnd = achieved_bdp_pkts
                self.last_decrease_ts = now
            elif delay > p.target_qdelay_us:
                self.cwnd = self.cwnd * max(
                    1 - p.gamma * (self.avg_delay - p.target_qdelay_us)
                    / self.avg_delay, 0.5)
                self.last_decrease_ts = now
        if can_fairness:
            self.cwnd = self.cwnd + p.eta_pkts
            self.last_selfai_ts = now
        self.cwnd = min(max(self.cwnd, p.min_cwnd_pkts), p.max_cwnd_pkts)
        return self.cwnd


# ---------------------------------------------------------------------------
# STrack receiver (Section 3.3.1)
# ---------------------------------------------------------------------------

class STrackReceiver:
    """Tracks arrivals past EPSN; coalesces SACKs; answers probes."""

    __slots__ = ("p", "epsn", "pending", "bytes_recvd", "bytes_since_sack",
                 "lpsn_since_sack", "total_pkts")

    def __init__(self, p: STrackParams, total_pkts: int):
        self.p = p
        self.epsn = 0
        self.pending: set[int] = set()   # received psns > epsn
        self.bytes_recvd = 0.0           # deduplicated
        self.bytes_since_sack = 0.0
        self.lpsn_since_sack: Optional[int] = None
        self.total_pkts = total_pkts

    def _mk_sack(self, pkt: Packet, now: float, probe_reply: bool) -> Packet:
        bits = self.p.sack_bitmap_bits
        # Segment (relative to EPSN) containing the lowest PSN since last SACK.
        lpsn = self.lpsn_since_sack if self.lpsn_since_sack is not None else self.epsn
        lpsn = max(lpsn, self.epsn)
        seg = (lpsn - self.epsn) // bits
        base = self.epsn + seg * bits
        bitmap = 0
        for i in range(bits):
            if (base + i) < self.epsn or (base + i) in self.pending:
                bitmap |= (1 << i)
        s = Packet(SACK, pkt.flow, pkt.psn, ACK_SIZE, pkt.entropy, pkt.ts,
                   src=pkt.dst, dst=pkt.src)
        s.ecn = pkt.ecn
        s.is_probe_reply = probe_reply
        s.epsn = self.epsn
        s.sack_base = base
        s.sack_bitmap = bitmap
        s.bytes_recvd = self.bytes_recvd
        s.ooo_cnt = len(self.pending)
        self.bytes_since_sack = 0.0
        self.lpsn_since_sack = None
        return s

    def on_data(self, pkt: Packet, now: float) -> Optional[Packet]:
        if pkt.kind == PROBE:
            return self._mk_sack(pkt, now, probe_reply=True)
        old_epsn = self.epsn
        dup = pkt.psn < self.epsn or pkt.psn in self.pending
        if not dup:
            self.bytes_recvd += pkt.size
            self.bytes_since_sack += pkt.size
            self.pending.add(pkt.psn)
            while self.epsn in self.pending:
                self.pending.remove(self.epsn)
                self.epsn += 1
            if self.lpsn_since_sack is None or pkt.psn < self.lpsn_since_sack:
                self.lpsn_since_sack = pkt.psn
        if (self.bytes_since_sack >= self.p.ack_coalesce_bytes
                or (not dup and pkt.psn == old_epsn)
                or self.epsn >= self.total_pkts):
            return self._mk_sack(pkt, now, probe_reply=False)
        return None


# ---------------------------------------------------------------------------
# STrack sender (Algorithm 1 + Section 3.3.2)
# ---------------------------------------------------------------------------

class STrackSender:
    """Window-clocked multipath sender with selective retransmission."""

    __slots__ = (
        "p", "flow", "total_pkts", "msg_bytes", "cc", "spray",
        "psn_next", "bytes_sent", "bytes_recvd_seen", "bytes_claimed_rtx",
        "epsn", "sacked", "claimed", "rtx_queue",
        "in_recovery", "recover_high", "probe_deadline", "rto_deadline",
        "probes_sent", "done_ts", "start_ts", "rtt_samples", "retransmits",
        "spurious_rtx",
    )

    def __init__(self, p: STrackParams, flow: int, msg_bytes: float,
                 now: float = 0.0):
        self.p = p
        self.flow = flow
        self.msg_bytes = msg_bytes
        self.total_pkts = max(1, math.ceil(msg_bytes / p.mtu_bytes))
        self.cc = CCState(p, now)
        self.spray = SprayState(p, now)
        self.psn_next = 0
        self.bytes_sent = 0.0
        self.bytes_recvd_seen = 0.0     # latest bytes_recvd echoed by receiver
        self.bytes_claimed_rtx = 0.0
        self.epsn = 0                   # receiver's cumulative ack point
        self.sacked: set[int] = set()   # selectively acked psns >= epsn
        self.claimed: set[int] = set()  # psns declared lost, not yet re-sent
        self.rtx_queue: list[int] = []
        self.in_recovery = False
        self.recover_high = -1
        self.probe_deadline = now + p.probe_rtts * p.base_rtt_us
        self.rto_deadline = now + p.rto_us
        self.probes_sent = 0
        self.done_ts: Optional[float] = None
        self.start_ts = now
        self.rtt_samples: list[float] = []
        self.retransmits = 0
        self.spurious_rtx = 0

    # -- helpers ------------------------------------------------------------
    def pkt_size(self, psn: int) -> int:
        if psn == self.total_pkts - 1:
            rem = int(self.msg_bytes - (self.total_pkts - 1) * self.p.mtu_bytes)
            return max(1, rem)
        return self.p.mtu_bytes

    @property
    def inflight_bytes(self) -> float:
        return self.bytes_sent - self.bytes_recvd_seen - self.bytes_claimed_rtx

    def done(self) -> bool:
        return self.epsn >= self.total_pkts

    def can_send(self) -> bool:
        if self.done():
            return False
        has_data = bool(self.rtx_queue) or self.psn_next < self.total_pkts
        return has_data and (
            self.inflight_bytes < self.cc.cwnd * self.p.mtu_bytes)

    # -- transmission -------------------------------------------------------
    def next_packet(self, now: float) -> Optional[Packet]:
        if not self.can_send():
            return None
        rtx = False
        if self.rtx_queue:
            psn = self.rtx_queue.pop(0)
            if psn < self.epsn or psn in self.sacked:
                return self.next_packet(now)   # became acked meanwhile
            self.claimed.discard(psn)
            rtx = True
            self.retransmits += 1
        else:
            psn = self.psn_next
            self.psn_next += 1
        size = self.pkt_size(psn)
        entropy = self.spray.choose_path(self.cc.cwnd, now)
        pkt = Packet(DATA, self.flow, psn, size, entropy, now)
        pkt.rtx = rtx
        self.bytes_sent += size
        return pkt

    def make_probe(self, now: float) -> Packet:
        self.probes_sent += 1
        self.probe_deadline = now + self.p.probe_rtts * self.p.base_rtt_us
        entropy = self.spray.choose_path(self.cc.cwnd, now)
        return Packet(PROBE, self.flow, self.epsn, ACK_SIZE, entropy, now)

    # -- loss declaration ---------------------------------------------------
    def _declare_lost(self, psns) -> None:
        for psn in psns:
            if psn in self.claimed or psn in self.sacked or psn < self.epsn:
                continue
            self.claimed.add(psn)
            self.bytes_claimed_rtx += self.pkt_size(psn)
            self.rtx_queue.append(psn)
        self.rtx_queue.sort()

    def _enter_recovery(self, high: int) -> None:
        self.in_recovery = True
        self.recover_high = max(self.recover_high, high)
        lost = [psn for psn in range(self.epsn, self.recover_high)
                if psn not in self.sacked]
        self._declare_lost(lost)

    # -- Algorithm 1: on_receiving_ack ---------------------------------------
    def on_sack(self, sack: Packet, now: float) -> None:
        p = self.p
        measured_rtt = now - sack.ts
        self.rtt_samples.append(measured_rtt)
        if measured_rtt < self.cc.base_rtt:
            self.cc.base_rtt = measured_rtt
        qdelay = measured_rtt - self.cc.base_rtt
        self.probe_deadline = now + p.probe_rtts * p.base_rtt_us

        # Probe-based loss detection (Algo 1 line 13).
        if (sack.is_probe_reply and qdelay < 2 * p.base_rtt_us
                and self.cc.achieved_bdp_pkts == 0.0
                and not self.done()):
            self._enter_recovery(self.psn_next)

        if not sack.is_probe_reply:
            self.spray.update_ecn_bitmap(sack.ecn, sack.entropy)

        # Cumulative + selective ack bookkeeping.
        old_epsn = self.epsn
        if sack.epsn > self.epsn:
            self.epsn = sack.epsn
            self.rto_deadline = now + p.rto_us
            self.sacked = {s for s in self.sacked if s >= self.epsn}
            for psn in list(self.claimed):
                if psn < self.epsn:
                    # acked before we retransmitted: un-claim
                    self.claimed.discard(psn)
                    self.bytes_claimed_rtx -= self.pkt_size(psn)
                    self.spurious_rtx += 1
            self.rtx_queue = [x for x in self.rtx_queue if x >= self.epsn]
        for i in range(p.sack_bitmap_bits):
            if sack.sack_bitmap & (1 << i):
                psn = sack.sack_base + i
                if psn >= self.epsn and psn not in self.sacked:
                    self.sacked.add(psn)
                    if psn in self.claimed:
                        self.claimed.discard(psn)
                        self.bytes_claimed_rtx -= self.pkt_size(psn)
                        self.spurious_rtx += 1
                        if psn in self.rtx_queue:
                            self.rtx_queue.remove(psn)

        acked_bytes = max(0.0, sack.bytes_recvd - self.bytes_recvd_seen)
        self.bytes_recvd_seen = max(self.bytes_recvd_seen, sack.bytes_recvd)

        achieved = self.cc.update_achieved_bdp(
            acked_bytes, sack.is_probe_reply, now)
        self.cc.adjust_cwnd(sack.ecn, qdelay, achieved, now)

        # OOO-based loss detection (Section 3.3.2).
        thresh = max(self.cc.cwnd, float(p.min_ooo_threshold))
        if sack.ooo_cnt > thresh:
            high = max(self.sacked) if self.sacked else self.epsn
            self._enter_recovery(high)

        # Recovery exit: everything up to recover_high acked.
        if self.in_recovery and self.epsn >= self.recover_high:
            self.in_recovery = False
            self.recover_high = -1

        if self.done() and self.done_ts is None:
            self.done_ts = now

    # -- timers ---------------------------------------------------------------
    def next_timer_deadline(self) -> float:
        if self.done():
            return math.inf
        return min(self.probe_deadline, self.rto_deadline)

    def on_timer(self, now: float) -> Optional[Packet]:
        """Fire whichever timer expired; may return a probe packet to send."""
        if self.done():
            return None
        if now >= self.rto_deadline:
            # Timeout: all unacked packets declared lost.
            self.rto_deadline = now + self.p.rto_us
            self._enter_recovery(self.psn_next)
            return None
        if now >= self.probe_deadline:
            return self.make_probe(now)
        return None


# ---------------------------------------------------------------------------
# RoCEv2 baseline: DCQCN + go-back-N (PFC lives in the switch model)
# ---------------------------------------------------------------------------

class DCQCNState:
    """DCQCN rate state (Zhu et al., SIGCOMM'15)."""

    __slots__ = ("p", "rate", "target", "alpha", "t_stage", "b_stage",
                 "bytes_ctr", "last_rate_ts", "last_alpha_ts", "max_rate",
                 "last_cut_ts")

    def __init__(self, p: DCQCNParams, line_rate: float, now: float = 0.0):
        self.p = p
        self.rate = line_rate
        self.target = line_rate
        self.max_rate = line_rate
        self.alpha = 1.0
        self.t_stage = 0
        self.b_stage = 0
        self.bytes_ctr = 0.0
        self.last_rate_ts = now
        self.last_alpha_ts = now
        self.last_cut_ts = now

    def on_cnp(self, now: float) -> None:
        self.target = self.rate
        self.rate = max(self.rate * (1 - self.alpha / 2), self.p.min_rate_Bpus)
        self.alpha = (1 - self.p.g) * self.alpha + self.p.g
        self.t_stage = 0
        self.b_stage = 0
        self.bytes_ctr = 0.0
        self.last_rate_ts = now
        self.last_alpha_ts = now
        self.last_cut_ts = now

    def _increase(self) -> None:
        # DCQCN phases (Zhu'15): hyper when BOTH counters passed F,
        # additive when EITHER did, else fast recovery.
        if min(self.t_stage, self.b_stage) > self.p.f_fast_recovery:
            self.target = min(self.target + self.p.hai_mbps, self.max_rate)
        elif max(self.t_stage, self.b_stage) > self.p.f_fast_recovery:
            self.target = min(self.target + self.p.rai_mbps, self.max_rate)
        # fast recovery: rate -> (rate+target)/2, target unchanged
        self.rate = min((self.rate + self.target) / 2, self.max_rate)

    def on_bytes_sent(self, nbytes: float) -> None:
        self.bytes_ctr += nbytes
        if self.bytes_ctr >= self.p.byte_counter:
            self.bytes_ctr = 0.0
            self.b_stage += 1
            self._increase()

    def on_timer(self, now: float) -> None:
        if now - self.last_alpha_ts >= self.p.alpha_timer_us:
            self.alpha = (1 - self.p.g) * self.alpha
            self.last_alpha_ts = now
        if now - self.last_rate_ts >= self.p.rate_timer_us:
            self.t_stage += 1
            self.last_rate_ts = now
            self._increase()


class RoCESender:
    """Go-back-N sender paced by DCQCN. Single path (fixed entropy)."""

    __slots__ = ("p", "dcqcn", "flow", "total_pkts", "msg_bytes", "mtu",
                 "snd_una", "psn_next", "entropy", "next_send_ts",
                 "rto_deadline", "done_ts", "start_ts", "rto_us", "window_pkts",
                 "retransmits")

    def __init__(self, dcqcn_p: DCQCNParams, flow: int, msg_bytes: float,
                 mtu: int, line_rate: float, entropy: int, rto_us: float,
                 window_bdp_pkts: float, now: float = 0.0):
        self.p = dcqcn_p
        self.dcqcn = DCQCNState(dcqcn_p, line_rate, now)
        self.flow = flow
        self.msg_bytes = msg_bytes
        self.mtu = mtu
        self.total_pkts = max(1, math.ceil(msg_bytes / mtu))
        self.snd_una = 0
        self.psn_next = 0
        self.entropy = entropy
        self.next_send_ts = now
        self.rto_us = rto_us
        self.rto_deadline = now + rto_us
        self.done_ts: Optional[float] = None
        self.start_ts = now
        self.window_pkts = window_bdp_pkts  # static window (lossless net)
        self.retransmits = 0

    def pkt_size(self, psn: int) -> int:
        if psn == self.total_pkts - 1:
            rem = int(self.msg_bytes - (self.total_pkts - 1) * self.mtu)
            return max(1, rem)
        return self.mtu

    def done(self) -> bool:
        return self.snd_una >= self.total_pkts

    def can_send(self, now: float) -> bool:
        return (not self.done() and self.psn_next < self.total_pkts
                and now >= self.next_send_ts
                and (self.psn_next - self.snd_una) < self.window_pkts)

    def next_packet(self, now: float) -> Optional[Packet]:
        if not self.can_send(now):
            return None
        psn = self.psn_next
        self.psn_next += 1
        size = self.pkt_size(psn)
        pkt = Packet(DATA, self.flow, psn, size, self.entropy, now)
        self.dcqcn.on_bytes_sent(size)
        # pace at DCQCN rate
        self.next_send_ts = now + size / max(self.dcqcn.rate, 1e-9)
        return pkt

    def on_ack(self, ack: Packet, now: float) -> None:
        if ack.kind == CNP:
            self.dcqcn.on_cnp(now)
            return
        if ack.kind == NACK:
            # go-back-N: rewind to receiver's expected psn
            if ack.epsn > self.snd_una:
                self.snd_una = ack.epsn
            if self.psn_next > ack.epsn:
                self.retransmits += self.psn_next - ack.epsn
            self.psn_next = max(self.snd_una, ack.epsn)
            self.rto_deadline = now + self.rto_us
            return
        if ack.epsn > self.snd_una:
            self.snd_una = ack.epsn
            self.rto_deadline = now + self.rto_us
        if self.done() and self.done_ts is None:
            self.done_ts = now

    def next_timer_deadline(self) -> float:
        if self.done():
            return math.inf
        # NB: next_send_ts (pacing) is the NIC pump's responsibility, not a
        # timer — mixing them causes same-instant timer/pump livelock.
        return min(self.rto_deadline,
                   self.dcqcn.last_alpha_ts + self.p.alpha_timer_us,
                   self.dcqcn.last_rate_ts + self.p.rate_timer_us)

    def on_timer(self, now: float) -> None:
        self.dcqcn.on_timer(now)
        if now >= self.rto_deadline and not self.done():
            self.psn_next = self.snd_una  # go-back-N from snd_una
            self.rto_deadline = now + self.rto_us


class RoCEReceiver:
    """In-order-only receiver: acks cumulative EPSN, NACKs on gaps, CNPs on ECN."""

    __slots__ = ("epsn", "total_pkts", "coalesce", "since_ack", "last_cnp_ts",
                 "cnp_interval", "bytes_recvd")

    def __init__(self, total_pkts: int, coalesce_pkts: int,
                 cnp_interval_us: float):
        self.epsn = 0
        self.total_pkts = total_pkts
        self.coalesce = coalesce_pkts
        self.since_ack = 0
        self.last_cnp_ts = -1e18
        self.cnp_interval = cnp_interval_us
        self.bytes_recvd = 0.0

    def on_data(self, pkt: Packet, now: float) -> list[Packet]:
        out: list[Packet] = []
        if pkt.ecn and now - self.last_cnp_ts >= self.cnp_interval:
            cnp = Packet(CNP, pkt.flow, 0, ACK_SIZE, pkt.entropy, pkt.ts,
                         src=pkt.dst, dst=pkt.src)
            self.last_cnp_ts = now
            out.append(cnp)
        if pkt.psn == self.epsn:
            self.epsn += 1
            self.bytes_recvd += pkt.size
            self.since_ack += 1
            if self.since_ack >= self.coalesce or self.epsn >= self.total_pkts:
                ack = Packet(SACK, pkt.flow, pkt.psn, ACK_SIZE, pkt.entropy,
                             pkt.ts, src=pkt.dst, dst=pkt.src)
                ack.epsn = self.epsn
                ack.bytes_recvd = self.bytes_recvd
                self.since_ack = 0
                out.append(ack)
        elif pkt.psn > self.epsn:
            # out-of-order: go-back-N NACK with expected psn
            nack = Packet(NACK, pkt.flow, pkt.psn, ACK_SIZE, pkt.entropy,
                          pkt.ts, src=pkt.dst, dst=pkt.src)
            nack.epsn = self.epsn
            out.append(nack)
        else:
            # duplicate of already-delivered packet: re-ack
            ack = Packet(SACK, pkt.flow, pkt.psn, ACK_SIZE, pkt.entropy,
                         pkt.ts, src=pkt.dst, dst=pkt.src)
            ack.epsn = self.epsn
            ack.bytes_recvd = self.bytes_recvd
            out.append(ack)
        return out
