"""The composed STrack flow engine, batched over flows.

The port of ``repro.core.transport``: :class:`FlowState` bundles CC
(Algo 3/4), spray (Algo 2) and reliability (S3.3) state for N flows;
``flow_on_sack`` / ``flow_next_packet`` / ``flow_on_timer`` are the three
entry points of Algorithm 1, each updating every flow at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cc as cc_mod
from . import lb as lb_mod
from . import reliability as rel_mod
from ..numerics import f32
from .cc import CCState
from .lb import SprayState
from .params import STrackParams
from .reliability import RelState, SackMsg


class FlowState(NamedTuple):
    cc: CCState
    spray: SprayState
    rel: RelState


class TxPacket(NamedTuple):
    valid: torch.Tensor     # bool[N]
    psn: torch.Tensor       # i32[N]
    entropy: torch.Tensor   # i32[N]
    is_rtx: torch.Tensor    # bool[N]
    is_probe: torch.Tensor  # bool[N]


def tree_where(mask: torch.Tensor, new, old):
    """Per-flow select over a state tuple; ``mask`` is bool[N] and
    broadcasts over trailing dims (bitmaps)."""
    if isinstance(new, tuple):
        return type(new)(*[tree_where(mask, n, o) for n, o in zip(new, old)])
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


def init_flow(p: STrackParams, total_pkts: torch.Tensor,
              tail_bytes: torch.Tensor, now: float = 0.0) -> FlowState:
    n, dev = total_pkts.shape[0], total_pkts.device
    return FlowState(
        cc=cc_mod.init_cc(p, n, dev, now),
        spray=lb_mod.init_spray(p, n, dev, now),
        rel=rel_mod.init_rel(p, total_pkts, tail_bytes, now),
    )


def flow_on_sack(fs: FlowState, p: STrackParams, sack: SackMsg,
                 now: float) -> FlowState:
    """Algorithm 1, on_receiving_ack — a no-op where ``sack.valid`` is
    unset."""
    measured_rtt = f32(now) - sack.ts
    base_rtt = torch.minimum(fs.cc.base_rtt, measured_rtt)
    qdelay = measured_rtt - base_rtt

    spray = lb_mod.update_ecn_bitmap(fs.spray, sack.ecn, sack.entropy)
    spray = tree_where(sack.probe_reply, fs.spray, spray)

    rel, acked_bytes = rel_mod.rel_on_sack(
        fs.rel, p, sack, fs.cc.cwnd, fs.cc.achieved_bdp_pkts, qdelay, now)

    cc = fs.cc._replace(base_rtt=base_rtt)
    cc = cc_mod.update_achieved_bdp(cc, p, acked_bytes, sack.probe_reply, now)
    cc = cc_mod.adjust_cwnd(cc, p, sack.ecn, qdelay, now)

    return tree_where(sack.valid, FlowState(cc=cc, spray=spray, rel=rel), fs)


def flow_next_packet(fs: FlowState, p: STrackParams, now: float
                     ) -> tuple[FlowState, TxPacket]:
    """on_sending_packet: window check + PSN pick + Algo 2 path choice."""
    rel, psn, is_rtx, valid = rel_mod.rel_next_psn(fs.rel, p, fs.cc.cwnd)
    entropy, spray = lb_mod.choose_path(fs.spray, p, fs.cc.cwnd, now)
    spray = tree_where(valid, spray, fs.spray)
    rel = tree_where(valid, rel, fs.rel)
    return (FlowState(cc=fs.cc, spray=spray, rel=rel),
            TxPacket(valid=valid, psn=psn, entropy=entropy, is_rtx=is_rtx,
                     is_probe=torch.zeros_like(valid)))


def flow_on_timer(fs: FlowState, p: STrackParams, now: float
                  ) -> tuple[FlowState, TxPacket]:
    """RTO / probe timers; may emit a probe packet."""
    rel, probe = rel_mod.rel_on_timer(fs.rel, p, now)
    entropy, spray = lb_mod.choose_path(fs.spray, p, fs.cc.cwnd, now)
    spray = tree_where(probe, spray, fs.spray)
    return (FlowState(cc=fs.cc, spray=spray, rel=rel),
            TxPacket(valid=probe, psn=rel.epsn, entropy=entropy,
                     is_rtx=torch.zeros_like(probe), is_probe=probe))


def flow_done(fs: FlowState) -> torch.Tensor:
    return rel_mod.rel_done(fs.rel)


def flow_next_event(fs: FlowState, p: STrackParams
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(next timer event time, next pacing release time) per flow for the
    event-horizon loop; STrack has no pacing gate, so the send time is
    always +inf."""
    del p
    active = ~rel_mod.rel_done(fs.rel)
    timer_ev = torch.where(
        active, torch.minimum(fs.rel.probe_deadline, fs.rel.rto_deadline),
        float("inf"))
    return timer_ev, torch.full_like(timer_ev, float("inf"))
