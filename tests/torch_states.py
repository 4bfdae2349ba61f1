"""Random per-flow transport states from a numpy seed, as numpy arrays.

The port's parity tests feed them to the JAX reference and the port alike;
``chip_smoke.py`` feeds them to the transition kernel and its plain version
on the card.  The draws cover the rare branches a fabric run seldom takes:
expired RTO and probe deadlines, flows in recovery, claimed ledger bits,
stale and future SACKs.  Only numpy is imported here.
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
