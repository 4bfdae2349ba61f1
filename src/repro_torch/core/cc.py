"""Algorithms 3 & 4 — STrack congestion control, batched over flows.

The port of ``repro.core.cc``: every field of :class:`CCState` is a
float32 tensor with the flow axis leading, and each function updates all
flows at once where the reference ``vmap``s a scalar function.  cwnd is in
packets (MTU units); time in microseconds.  Constants are rounded to
float32 on the host in the reference's grouping (``numerics``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics import f32, fma32, recip32
from .params import STrackParams


class CCState(NamedTuple):
    cwnd: torch.Tensor              # f32, packets
    base_rtt: torch.Tensor          # f32, us (min observed)
    avg_delay: torch.Tensor         # f32, us (ewma of queuing delay)
    last_decrease_ts: torch.Tensor  # f32, us
    last_selfai_ts: torch.Tensor    # f32, us
    achieved_bdp_pkts: torch.Tensor  # f32, packets
    rx_count_bytes: torch.Tensor    # f32, bytes
    rxcount_clear_ts: torch.Tensor  # f32, us


def init_cc(p: STrackParams, n: int, device, now: float = 0.0) -> CCState:
    f = lambda v: torch.full((n,), f32(v), dtype=torch.float32, device=device)
    return CCState(
        cwnd=f(p.max_cwnd_pkts),
        base_rtt=f(p.base_rtt_us),
        avg_delay=f(0.0),
        last_decrease_ts=f(now),
        last_selfai_ts=f(now),
        achieved_bdp_pkts=f(0.0),
        rx_count_bytes=f(0.0),
        rxcount_clear_ts=f(now),
    )


def update_achieved_bdp(s: CCState, p: STrackParams, acked_bytes: torch.Tensor,
                        ack_for_probe: torch.Tensor, now: float) -> CCState:
    """Algorithm 4: delivered-bytes window over (base_rtt + target_Qdelay)."""
    now = f32(now)
    can_clear = (now - s.rxcount_clear_ts) > (s.base_rtt
                                              + f32(p.target_qdelay_us))
    rx = s.rx_count_bytes + torch.where(ack_for_probe, 0.0, acked_bytes)
    achieved = torch.where(can_clear, rx * recip32(p.mtu_bytes),
                           s.achieved_bdp_pkts)
    return s._replace(
        achieved_bdp_pkts=achieved,
        rx_count_bytes=torch.where(can_clear, 0.0, rx),
        rxcount_clear_ts=torch.where(can_clear, now, s.rxcount_clear_ts),
    )


def adjust_cwnd(s: CCState, p: STrackParams, ecn: torch.Tensor,
                delay: torch.Tensor, now: float) -> CCState:
    """Algorithm 3: the four-quadrant window update."""
    now = f32(now)
    achieved = s.achieved_bdp_pkts
    tq, th = f32(p.target_qdelay_us), f32(p.target_qhigh_us)

    can_decrease = (now - s.last_decrease_ts) > s.base_rtt
    can_fairness = (now - s.last_selfai_ts) > s.base_rtt
    # s.avg_delay * (1 - ewma) + ewma * delay, contracted as XLA does
    avg_delay = fma32(s.avg_delay, f32(1 - p.ewma), f32(p.ewma) * delay)

    b1 = (~ecn) & (delay > th)
    b2 = (~b1) & (~ecn) & (delay < tq)
    b3 = (~b1) & (~b2) & can_decrease & (avg_delay > tq)
    b3a = b3 & (delay > th) & (achieved < f32(p.max_cwnd_pkts / 8))
    b3b = b3 & (~b3a) & (delay > tq)

    cwnd = s.cwnd
    cwnd = torch.where(b1, cwnd + torch.full_like(cwnd, f32(p.beta_pkts))
                       / cwnd, cwnd)
    cwnd = torch.where(
        b2, cwnd + (f32(p.alpha_pkts_per_us) * (tq - delay)) / cwnd, cwnd)
    cwnd = torch.where(b3a, achieved, cwnd)
    md = s.cwnd * torch.clamp_min(
        1.0 - (f32(p.gamma) * (avg_delay - tq))
        / torch.clamp_min(avg_delay, f32(1e-9)), 0.5)
    cwnd = torch.where(b3b, md, cwnd)
    last_decrease_ts = torch.where(b3a | b3b, now, s.last_decrease_ts)

    cwnd = torch.where(can_fairness, cwnd + f32(p.eta_pkts), cwnd)
    last_selfai_ts = torch.where(can_fairness, now, s.last_selfai_ts)

    cwnd = torch.clamp(cwnd, f32(p.min_cwnd_pkts), f32(p.max_cwnd_pkts))
    return s._replace(cwnd=cwnd, avg_delay=avg_delay,
                      last_decrease_ts=last_decrease_ts,
                      last_selfai_ts=last_selfai_ts)
