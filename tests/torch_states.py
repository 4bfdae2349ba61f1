"""Random per-flow transport states from a numpy seed, as numpy arrays.

The port's parity tests feed them to the JAX reference and the port alike;
``chip_smoke.py`` feeds them to the transition kernel and its plain version
on the card.  The draws cover the rare branches a fabric run seldom takes:
expired RTO and probe deadlines, flows in recovery, claimed ledger bits,
stale and future SACKs; for RoCEv2, timer and pacing comparisons on and
next to their thresholds, byte counters a packet short of a stage, CNPs
and rewinding NACKs.  Only numpy is imported here.
"""
from __future__ import annotations

import numpy as np

W = 512


def _times(rng, n, lo=0.0, hi=200.0):
    """Times on a 1/8 us grid (exact ties exercise strict comparisons),
    mixed with arbitrary float32 values."""
    grid = rng.integers(int(lo * 8), int(hi * 8), n) / 8.0
    free = rng.uniform(lo, hi, n)
    return np.where(rng.random(n) < 0.5, grid, free).astype(np.float32)


def random_cc(rng, n, p) -> dict:
    return dict(
        cwnd=rng.uniform(p.min_cwnd_pkts, p.max_cwnd_pkts, n).astype(
            np.float32),
        base_rtt=np.where(rng.random(n) < 0.5, p.base_rtt_us,
                          rng.uniform(4, 12, n)).astype(np.float32),
        avg_delay=_times(rng, n, 0, 40),
        last_decrease_ts=_times(rng, n),
        last_selfai_ts=_times(rng, n),
        achieved_bdp_pkts=np.where(rng.random(n) < 0.3, 0.0,
                                   rng.uniform(0, 40, n)).astype(np.float32),
        rx_count_bytes=rng.integers(0, 200, n).astype(np.float32) * 4096,
        rxcount_clear_ts=_times(rng, n))


def random_spray(rng, n, p) -> dict:
    P = p.max_paths
    return dict(
        bitmap=(rng.random((n, P)) < rng.uniform(0, 1, (n, 1))).astype(
            np.int8),
        rr=rng.integers(0, P, n).astype(np.int32),
        next_path_id=np.where(rng.random(n) < 0.5, -1,
                              rng.integers(0, P, n)).astype(np.int32),
        last_reset_ts=_times(rng, n))


def random_rel(rng, n, p) -> dict:
    epsn = rng.integers(0, 40, n).astype(np.int32)
    total = np.where(rng.random(n) < 0.15, epsn,
                     epsn + rng.integers(1, 600, n)).astype(np.int32)
    dens = rng.uniform(0, 0.6, (n, 1))
    return dict(
        epsn=epsn,
        sacked=rng.random((n, W)) < dens,
        claimed=rng.random((n, W)) < dens * rng.random((n, 1)),
        psn_next=(epsn + rng.integers(0, W + 1, n)).astype(np.int32),
        total_pkts=total,
        tail_bytes=np.where(rng.random(n) < 0.5, 4096.0,
                            rng.integers(1, 4097, n)).astype(np.float32),
        bytes_sent=rng.integers(0, 800, n).astype(np.float32) * 4096,
        bytes_recvd_seen=rng.integers(0, 400, n).astype(np.float32) * 4096,
        bytes_claimed=rng.integers(0, 100, n).astype(np.float32) * 4096,
        in_recovery=rng.random(n) < 0.3,
        recover_high=np.where(rng.random(n) < 0.5, -1,
                              epsn + rng.integers(0, 600, n)).astype(np.int32),
        probe_deadline=_times(rng, n),
        rto_deadline=_times(rng, n, 0, 600),
        done_ts=np.where(rng.random(n) < 0.8, -1.0,
                         _times(rng, n)).astype(np.float32),
        rto_fires=rng.integers(0, 3, n).astype(np.int32),
        recoveries=rng.integers(0, 3, n).astype(np.int32))


def random_sack(rng, n, p, rel: dict, now: float) -> dict:
    B = p.sack_bitmap_bits
    epsn = (rel["epsn"] + rng.integers(-3, 80, n)).astype(np.int32)
    return dict(
        valid=rng.random(n) < 0.8,
        epsn=epsn,
        sack_base=(epsn + B * rng.integers(-1, 4, n)
                   + rng.integers(-2, 3, n)).astype(np.int32),
        sack_bits=rng.random((n, B)) < 0.4,
        bytes_recvd=(rel["bytes_recvd_seen"]
                     + rng.integers(-5, 60, n) * 4096).astype(np.float32),
        ooo_cnt=rng.integers(0, 120, n).astype(np.int32),
        ecn=rng.random(n) < 0.4,
        entropy=rng.integers(0, p.max_paths + 1, n).astype(np.int32),
        ts=np.where(rng.random(n) < 0.5, now - p.base_rtt_us,
                    rng.uniform(0, now, n)).astype(np.float32),
        probe_reply=rng.random(n) < 0.3)


def random_receiver(rng, n) -> dict:
    epsn = rng.integers(0, 50, n).astype(np.int32)
    bitmap = rng.random((n, W)) < rng.uniform(0, 0.5, (n, 1))
    bitmap[rng.random(n) < 0.2] = True
    return dict(
        epsn=epsn, bitmap=bitmap,
        bytes_recvd=rng.integers(0, 300, n).astype(np.float32) * 4096,
        bytes_since_sack=rng.integers(0, 3, n).astype(np.float32) * 4096,
        lpsn=np.where(rng.random(n) < 0.5, -1,
                      epsn + rng.integers(0, 500, n)).astype(np.int32),
        total_pkts=(epsn + rng.integers(0, 700, n)).astype(np.int32))


def _near(rng, n, centre, spread):
    """float32 values at ``centre`` and up to two ulps either side (the
    ties of a ``>=`` comparison), mixed with values up to ``spread``
    away."""
    c = np.float32(centre)
    steps = rng.integers(-2, 3, n)
    tie = np.full(n, c, dtype=np.float32)
    for k in (1, 2):
        up, dn = steps >= k, steps <= -k
        tie[up] = np.nextafter(tie[up], np.float32(np.inf))
        tie[dn] = np.nextafter(tie[dn], np.float32(-np.inf))
    free = (c + rng.uniform(-spread, spread, n)).astype(np.float32)
    return np.where(rng.random(n) < 0.5, tie, free).astype(np.float32)


def random_roce_flow(rng, n, p, now: float) -> dict:
    """RoCEv2 sender states (``dcqcn_fab.RoceFlow``) around time ``now``:
    RTO deadlines, alpha/rate timer stamps and pacing gates on and next to
    their thresholds, byte counters one packet short of a stage, stage
    counts on both sides of fast recovery, closed and open windows, done
    flows."""
    dc = p.dcqcn
    snd = rng.integers(0, 200, n).astype(np.int32)
    total = np.where(rng.random(n) < 0.15, snd - rng.integers(0, 2, n),
                     snd + rng.integers(1, 300, n)).astype(np.int32)
    psn_next = (snd + rng.integers(0, int(p.window_pkts) + 8, n)
                ).astype(np.int32)
    line = np.float32(p.line_rate_Bpus)
    rate = np.where(rng.random(n) < 0.3, line,
                    rng.uniform(dc.min_rate_Bpus, line, n)).astype(np.float32)
    mtu = p.mtu_bytes
    bytes_ctr = np.where(
        rng.random(n) < 0.5,
        dc.byte_counter - mtu * rng.integers(0, 3, n),
        rng.integers(0, int(dc.byte_counter // mtu), n) * mtu
    ).astype(np.float32)
    return dict(
        snd_una=snd, psn_next=psn_next, total_pkts=total, rate=rate,
        target=np.where(rng.random(n) < 0.3, line,
                        rng.uniform(dc.min_rate_Bpus, line, n)
                        ).astype(np.float32),
        alpha=np.where(rng.random(n) < 0.2, 1.0,
                       rng.uniform(0, 1, n)).astype(np.float32),
        t_stage=rng.integers(0, 9, n).astype(np.int32),
        b_stage=rng.integers(0, 9, n).astype(np.int32),
        bytes_ctr=bytes_ctr,
        last_rate_ts=_near(rng, n, np.float32(now) - np.float32(
            dc.rate_timer_us), 60.0),
        last_alpha_ts=_near(rng, n, np.float32(now) - np.float32(
            dc.alpha_timer_us), 60.0),
        next_send_ts=_near(rng, n, np.float32(now) + np.float32(
            0.5 * p.tick_us), 2.0),
        rto_deadline=_near(rng, n, now, 100.0),
        entropy=rng.integers(0, 1 << 16, n).astype(np.int32),
        retransmits=rng.integers(0, 6, n).astype(np.int32),
        tail_bytes=np.where(rng.random(n) < 0.5, float(mtu),
                            rng.integers(1, mtu + 1, n)).astype(np.float32),
        max_psn=(psn_next + np.where(rng.random(n) < 0.5, 0,
                                     rng.integers(0, 60, n))).astype(np.int32),
        rto_fires=rng.integers(0, 3, n).astype(np.int32),
        gbn_rewinds=rng.integers(0, 3, n).astype(np.int32))


def random_roce_msg(rng, n, flow: dict) -> dict:
    """Return-pipe messages (``dcqcn_fab.RoceMsg``) for ``flow``: CNPs,
    ACKs below, at and past ``snd_una``, NACKs that rewind and that do
    not."""
    return dict(
        valid=rng.random(n) < 0.8,
        ack=rng.random(n) < 0.5,
        nack=rng.random(n) < 0.3,
        cnp=rng.random(n) < 0.4,
        epsn=(flow["snd_una"] + rng.integers(-3, 120, n)).astype(np.int32),
        bytes_recvd=(rng.integers(0, 400, n) * 4096).astype(np.float32))


def random_roce_rcv(rng, n, now: float) -> dict:
    """RoCEv2 receivers (``dcqcn_fab.RoceRcv``): coalescing counters on
    both sides of the ACK threshold, last CNP times around the CNP
    interval before ``now`` (and never)."""
    epsn = rng.integers(0, 100, n).astype(np.int32)
    return dict(
        epsn=epsn,
        total_pkts=(epsn + rng.integers(0, 4, n)).astype(np.int32),
        since_ack=rng.integers(0, 3, n).astype(np.int32),
        last_cnp_ts=np.where(rng.random(n) < 0.2, np.float32(-1e18),
                             _near(rng, n, np.float32(now) - np.float32(50.0),
                                   60.0)).astype(np.float32),
        bytes_recvd=(rng.integers(0, 400, n) * 4096).astype(np.float32))
