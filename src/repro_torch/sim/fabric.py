"""The multi-queue fat-tree fabric on PyTorch.

The port of ``repro.sim.fabric`` for both of the paper's transports,
STrack (window CC, adaptive spray, SACK) and RoCEv2 (DCQCN, go-back-N, one
path per flow: ``dcqcn_fab``), over lossy queues or lossless PFC queues: a
2-tier Clos fabric (host NICs -> per-ToR uplink queues -> per-spine
downlink queues -> per-host downlink queues) held as fixed-shape
ring-buffer tensors, ticked in the reference's stage order:

  0. dependency gate: a message is sendable once every message it
     depends on has completed and its open-loop arrival tick has come,
     0a. under the active set (``active_cap = A``), the lane slate: the
     released, unfinished flows in ascending order, padded with N to A
     lanes (``FabricProgram.lane_slate``),
     0b. under PFC, the effective pause masks, ``PD`` ticks old,
     0c. under a fault schedule (``sim.faults``), the tick's down, duty
     and corruption rows, down NICs and live uplinks,
  1. transport lanes — due ACKs, timer sweep, next packet, NIC
     round-robin, the PFC NIC gate (``kernels.flow_transition``, or
     ``kernels.flow_transition_active`` on the slate's A lanes),
  2. spray/ECMP injection targets over the live uplinks (RoCEv2: the
     flow's pinned entropy); a down NIC blackholes what it sends,
  3. ring service of unpaused, duty-open rows + two-pass enqueue
     (``kernels.serve_enqueue``: one launch on the card; its plain version
     ranks like ``kernels.rank_in_queue``); down rows blackhole what they
     pop, corrupting rows drop data on a counter-keyed draw,
  4. deliveries of the surviving packets -> receivers -> the per-flow
     return pipe,
  5. under PFC (the reference's stage 6b), ingress byte accounting, the
     pause/resume gates and the pause-frame delay line
     (``kernels.pfc_account``),
  6. completion (a message is done when all its stripes are; a newly
     done message releases its children on the next tick) and
     observability counters.

Time model: 1 tick = 1 MTU serialization time; every hop adds one tick of
serialization plus ``K`` ticks of propagation (the departure-time lane
``PktQ.ready``); SACKs return through a per-flow pipe of the reverse
path's latency.  The event-horizon loop (``FabricConfig.time_warp``)
skips ticks that are provably idle and is bit-identical to dense ticking.

Under the active set every per-flow stage of the tick runs on the A lanes
instead of the N flows, as the reference's active branch does; the
state stays [N], and a run in which more than A flows were live on some
tick raises ``RuntimeError`` when it ends.  A cap at or above N runs the
dense program.

Messages are striped over ``subflows`` equal sub-flows and carry
dependency edges (:func:`expand_messages`), as in the reference: the
collectives of ``repro_torch.collective`` run on the same program.  With
``trace_every = k`` (dense ticking) a trace row samples the state at the
end of every block of k ticks (:meth:`FabricProgram.snapshot`).

:func:`run_fabric_trace_batch` runs B traces of one program shape as one
:class:`BatchProgram`: every state leaf and bound input has a leading
axis B and each stage is one kernel call for the whole batch.  A trip
ticks the entries whose next tick is the earliest; the others are frozen,
so each entry steps exactly the ticks it steps alone.  Sharding raises
``NotImplementedError`` naming ROADMAP A11, the active set in a batch
ROADMAP A14.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import reliability as rel
from ..core import transport as tp
from ..core.params import (NetworkSpec, RoCEParams, STrackParams,
                           make_roce_params, make_strack_params)
from ..core.reliability import SackMsg
from ..kernels.fabric_kernels import (PfcDims, PfcState, PktQ, ServeDims,
                                      TransDims, flat_entries,
                                      flow_transition,
                                      flow_transition_active,
                                      flow_transition_batch, pfc_account,
                                      pfc_account_batch, pfc_flows,
                                      pfc_flows_batch, serve_enqueue,
                                      serve_enqueue_batch, src_index,
                                      src_index_batch, tree_map)
from ..numerics import Now, f32, recip32
from . import dcqcn_fab as dq
from .faults import FaultData, FaultSpec, build_fault_data, duty_open, \
    validate_faults
from .topology import FatTree

LB_MODES = ("adaptive", "oblivious", "fixed")
ACK_PATHS = ("perhop", "folded")
PROTOCOLS = ("strack", "rocev2")


def ecmp_mix(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """Tensor mirror of ``topology._mix``: the uint32 wrap-around hash,
    computed in int64 with a 32-bit mask after every multiply."""
    m = 0xFFFFFFFF
    u = lambda x: x.to(torch.int64) & m
    h = (u(a) * 2654435761) & m
    h = h ^ ((u(b) * 2246822519) & m)
    h = (h * 3266489917) & m
    h = h ^ ((u(c) * 668265263) & m)
    h = (h * 374761393) & m
    return ((h >> 8) ^ (h & 0xFF)).to(torch.int32)


class ArrayTopo(NamedTuple):
    """Array-ized FatTree: everything the fabric needs as tensors."""

    n_tor: int
    n_spine: int
    hosts_per_tor: int
    n_hosts: int
    live_mask: torch.Tensor   # bool[T, S]: (tor, spine) link is up
    live_list: torch.Tensor   # i32[T, S]: i-th live spine of tor (padded)
    n_live: torch.Tensor      # i32[T]

    @classmethod
    def from_fat_tree(cls, topo: FatTree, device="cpu") -> "ArrayTopo":
        T, S = topo.n_tor, topo.n_spine
        mask = [[(t, s) not in topo.dead_links for s in range(S)]
                for t in range(T)]
        llist, nlive = [], []
        for t in range(T):
            ups = topo.live_up[t]
            llist.append(ups + [ups[0]] * (S - len(ups)))
            nlive.append(len(ups))
        return cls(n_tor=T, n_spine=S, hosts_per_tor=topo.hosts_per_tor,
                   n_hosts=topo.n_hosts,
                   live_mask=torch.tensor(mask, dtype=torch.bool,
                                          device=device),
                   live_list=torch.tensor(llist, dtype=torch.int32,
                                          device=device),
                   n_live=torch.tensor(nlive, dtype=torch.int32,
                                       device=device))

    def tor_of(self, host: torch.Tensor) -> torch.Tensor:
        return torch.div(host, self.hosts_per_tor, rounding_mode="floor")

    def ecmp_spine(self, src: torch.Tensor, dst: torch.Tensor,
                   entropy: torch.Tensor, live=None) -> torch.Tensor:
        """ECMP onto a live uplink (bit-exact vs FatTree.ecmp_spine);
        ``live`` is ``(live_list, n_live)`` of a tick with flapped
        uplinks, the static lists by default."""
        live_list, n_live = live if live is not None else (self.live_list,
                                                            self.n_live)
        tor = self.tor_of(src).long()
        k = ecmp_mix(src, dst, entropy) % n_live[tor]
        return live_list[tor, k.long()]


# --------------------------------------------------------------------------- #
# Protocol record: the per-flow transport plugged into the fabric
# --------------------------------------------------------------------------- #

class Protocol(NamedTuple):
    """Per-flow transport engine record (every function is batched over
    flows).  The fabric's hot transitions run through the transition
    kernel; these entries serve set-up, deliveries, the warp target and
    the final statistics."""

    name: str
    uses_spray: bool         # lb_mode applies; else the flow's own entropy
    init: Callable           # (total_pkts, tail_bytes, entropy0) -> (f, r)
    empty_msgs: Callable     # (h, n, device) -> message tuple, dims (h, n)
    on_data: Callable        # (rcv, psn, size, ecn, ent, ts, probe, now)
    on_ack: Callable         # (flows, msg, now) -> flows
    on_timer: Callable       # (flows, now) -> (flows, TxPacket), probe-gated
    next_packet: Callable    # (flows, now) -> (flows, TxPacket)
    done: Callable           # flows -> bool[N]
    cong_pkts: Callable      # flows -> f32[N]
    next_event: Callable     # flows -> (timer_us[N], send_us[N])
    stat_retx: Callable      # flows -> i32[N]
    stat_recovery: Callable  # flows -> {rto_fires, sack_recoveries, ...}


def _empty_sack_pipe(p: STrackParams, h: int, n: int, device) -> SackMsg:
    z = lambda dt: torch.zeros((h, n), dtype=dt, device=device)
    return SackMsg(valid=z(torch.bool), epsn=z(torch.int32),
                   sack_base=z(torch.int32),
                   sack_bits=torch.zeros((h, n, p.sack_bitmap_bits),
                                         dtype=torch.bool, device=device),
                   bytes_recvd=z(torch.float32), ooo_cnt=z(torch.int32),
                   ecn=z(torch.bool), entropy=z(torch.int32),
                   ts=z(torch.float32), probe_reply=z(torch.bool))


def make_strack_protocol(p: STrackParams) -> Protocol:
    """STrack: window CC (Algo 3/4) + spray (Algo 2) + SACK reliability."""

    def init(total_pkts, tail_bytes, entropy0):
        del entropy0  # spray picks paths; no per-flow pinned entropy
        return (tp.init_flow(p, total_pkts, tail_bytes),
                rel.init_receiver(total_pkts))

    def on_timer(f, now):
        # the oracle arms a flow's timers when the flow is added; hold
        # probes until the flow has actually sent data
        f2, tx = tp.flow_on_timer(f, p, now)
        probe = tx.valid & (f.rel.bytes_sent > 0)
        return f2, tx._replace(valid=probe, is_probe=probe)

    def stat_retx(f):
        mtu = f32(p.mtu_bytes)
        wire = (f.rel.total_pkts - 1).to(torch.float32) * mtu \
            + f.rel.tail_bytes
        extra = torch.round((f.rel.bytes_sent - wire) * recip32(mtu))
        return torch.where(f.rel.total_pkts > 0,
                           torch.clamp_min(extra, 0.0).to(torch.int32), 0)

    return Protocol(
        name="strack", uses_spray=True, init=init,
        empty_msgs=lambda h, n, dev: _empty_sack_pipe(p, h, n, dev),
        on_data=lambda r, psn, size, ecn, ent, ts, probe, now:
            rel.receiver_on_data(r, p, psn, size, ecn, ent, ts, probe),
        on_ack=lambda f, m, now: tp.flow_on_sack(f, p, m, now),
        on_timer=on_timer,
        next_packet=lambda f, now: tp.flow_next_packet(f, p, now),
        done=tp.flow_done,
        cong_pkts=lambda f: f.cc.cwnd,
        next_event=lambda f: tp.flow_next_event(f, p),
        stat_retx=stat_retx,
        stat_recovery=lambda f: {
            "rto_fires": f.rel.rto_fires,
            "sack_recoveries": f.rel.recoveries,
            "gbn_rewinds": torch.zeros_like(f.rel.rto_fires)})


def make_rocev2_protocol(p: dq.RoceFabParams) -> Protocol:
    """RoCEv2: DCQCN rate CC + go-back-N, one fixed path per flow."""

    def init(total_pkts, tail_bytes, entropy0):
        return (dq.init_roce_flow(p, total_pkts, entropy0, tail_bytes),
                dq.init_roce_rcv(total_pkts))

    def next_packet(f, now):
        f2, (valid, psn, entropy, is_rtx) = dq.roce_next_packet(f, p, now)
        return f2, tp.TxPacket(valid=valid, psn=psn, entropy=entropy,
                               is_rtx=is_rtx,
                               is_probe=torch.zeros_like(valid))

    def on_timer(f, now):
        f2, probe = dq.roce_on_timer(f, p, now)
        return f2, tp.TxPacket(valid=probe, psn=torch.zeros_like(f.psn_next),
                               entropy=f.entropy,
                               is_rtx=torch.zeros_like(probe),
                               is_probe=probe)

    # window-equivalent in packets: instantaneous rate x base-ish RTT
    rtt_us = p.window_pkts * p.mtu_bytes / p.line_rate_Bpus

    return Protocol(
        name="rocev2", uses_spray=False, init=init,
        empty_msgs=dq.empty_roce_msgs,
        on_data=lambda r, psn, size, ecn, ent, ts, probe, now:
            dq.roce_on_data(r, p, psn, size, ecn, now),
        on_ack=lambda f, m, now: tp.tree_where(
            m.valid, dq.roce_on_ack(f, p, m, now), f),
        on_timer=on_timer,
        next_packet=next_packet,
        done=dq.roce_done,
        cong_pkts=lambda f: f.rate * f32(rtt_us) * recip32(p.mtu_bytes),
        next_event=lambda f: dq.roce_next_event(f, p),
        stat_retx=lambda f: f.retransmits,
        stat_recovery=lambda f: {
            "rto_fires": f.rto_fires,
            "sack_recoveries": torch.zeros_like(f.rto_fires),
            "gbn_rewinds": f.gbn_rewinds})


# --------------------------------------------------------------------------- #
# Messages and state
# --------------------------------------------------------------------------- #

class _FlowMsg(NamedTuple):
    """Minimal message record for the deps-free ``run_fabric`` wrapper."""

    mid: int
    src: int
    dst: int
    size: float
    deps: tuple = ()
    group: int = 0
    arrival: int = 0


class DepSpec(NamedTuple):
    """Static message structure a fabric program closes over.  Flows are
    the striped sub-flows of messages: ``msg_of_flow`` maps each sub-flow
    to its message; ``edge_parent[e] -> edge_child[e]`` are the dependency
    edges (the child waits for the parent); ``init_pending`` is each
    message's in-degree.  ``msg_ids`` / ``group_ids`` keep the caller's
    identifiers for reporting."""

    n_msgs: int
    n_groups: int
    msg_of_flow: torch.Tensor   # i32[N]
    group_of_msg: torch.Tensor  # i32[n_msgs]
    init_pending: torch.Tensor  # i32[n_msgs]
    edge_parent: torch.Tensor   # i32[E]
    edge_child: torch.Tensor    # i32[E]
    msg_ids: tuple
    group_ids: tuple


def expand_messages(messages, subflows: int = 1, device="cpu"):
    """Fan messages out into striped sub-flows -> ``(flows, dep)``:
    ``flows`` the ``[(src, dst, bytes), ...]`` sub-flows (each message
    split into ``subflows`` equal stripes, the oracle's multi-QP striping)
    and ``dep`` the :class:`DepSpec` tying them back together."""
    k = max(1, int(subflows))
    messages = list(messages)
    if not messages:
        raise ValueError("expand_messages() needs at least one message")
    mid_ix = {m.mid: i for i, m in enumerate(messages)}
    if len(mid_ix) != len(messages):
        raise ValueError("duplicate message ids in trace")
    group_ids = tuple(sorted({m.group for m in messages}))
    gid_ix = {g: i for i, g in enumerate(group_ids)}
    flows, msg_of_flow = [], []
    edge_parent, edge_child, pending = [], [], []
    for i, m in enumerate(messages):
        pending.append(len(m.deps))
        for d in m.deps:
            if d not in mid_ix:
                raise ValueError(f"message {m.mid} depends on unknown "
                                 f"message {d}")
            edge_parent.append(mid_ix[d])
            edge_child.append(i)
        for _ in range(k):
            flows.append((m.src, m.dst, m.size / k))
            msg_of_flow.append(i)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return flows, DepSpec(
        n_msgs=len(messages), n_groups=len(group_ids),
        msg_of_flow=i32(msg_of_flow),
        group_of_msg=i32([gid_ix[m.group] for m in messages]),
        init_pending=i32(pending), edge_parent=i32(edge_parent),
        edge_child=i32(edge_child), msg_ids=tuple(m.mid for m in messages),
        group_ids=group_ids)


def _to_device(dep: DepSpec, device) -> DepSpec:
    return dep._replace(**{k: getattr(dep, k).to(device) for k in (
        "msg_of_flow", "group_of_msg", "init_pending", "edge_parent",
        "edge_child")})


def _trivial_dep(n: int, device="cpu") -> DepSpec:
    """Deps-free 1:1 flow<->message mapping (the plain-flow case)."""
    iota = torch.arange(n, dtype=torch.int32, device=device)
    e = torch.zeros((0,), dtype=torch.int32, device=device)
    z = torch.zeros((n,), dtype=torch.int32, device=device)
    return DepSpec(n_msgs=n, n_groups=1, msg_of_flow=iota, group_of_msg=z,
                   init_pending=z.clone(), edge_parent=e, edge_child=e,
                   msg_ids=tuple(range(n)), group_ids=(0,))


class FabricState(NamedTuple):
    flows: tuple             # [N]: tp.FlowState or dcqcn_fab.RoceFlow
    rcv: tuple               # [N]: rel.ReceiverState or dcqcn_fab.RoceRcv
    q: PktQ                  # [Q+1, cap]
    qhead: torch.Tensor      # i32[Q+1]
    qsize: torch.Tensor      # i32[Q+1]
    pipe: tuple              # [H, N]: per-flow return pipe (SackMsg/RoceMsg)
    obl_rr: torch.Tensor     # i32[N]: oblivious-spray round robin
    drops: torch.Tensor      # i32
    delivered: torch.Tensor  # f32[N]
    done_tick: torch.Tensor  # i32[N], -1 until message completion
    # --- PFC (all-zero and untouched on lossy queues) ---
    qbytes: torch.Tensor     # f32[Q+1]: per-queue wire-byte occupancy
    ing_host: torch.Tensor   # f32[NH]: bytes at ToR(h) from host h's NIC
    ing_sd: torch.Tensor     # f32[S, T]: bytes at ToR t from spine s
    ing_up: torch.Tensor     # f32[T, S]: bytes at spine s from ToR t
    paused_nic: torch.Tensor  # bool[NH]
    paused_sd: torch.Tensor  # bool[S, T]: spine_down[s][t] paused by ToR t
    paused_up: torch.Tensor  # bool[T, S]: tor_up[t][s] paused by spine s
    pfc_line: torch.Tensor   # bool[max(PD,1), NH+2*TS]: pause-frame delay
    pauses: torch.Tensor     # i32: cumulative pause (xoff) events
    # --- dependency scheduling (trivial without deps) ---
    pending: torch.Tensor
    msg_done: torch.Tensor
    msg_release_tick: torch.Tensor
    msg_done_tick: torch.Tensor
    group_done_tick: torch.Tensor
    act_overflow: torch.Tensor
    # --- observability counters ---
    ecn_marks: torch.Tensor
    qdepth_hi: torch.Tensor
    # --- chaos counters (zeros without faults) ---
    blackholed: torch.Tensor
    corrupt_drops: torch.Tensor
    tx_rows: torch.Tensor
    win_retx: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """The reference's ``FabricConfig`` with the fields the port honours;
    the others keep their defaults and raise when set."""

    net: NetworkSpec = dataclasses.field(default_factory=NetworkSpec)
    max_paths: int = 64
    lb_mode: str = "adaptive"        # adaptive | oblivious | fixed
    timer_every: int = 8             # ticks between timer sweeps
    delay_ticks: Optional[int] = None  # return-pipe latency override
    protocol: str = "strack"
    pfc: Optional[bool] = None       # None -> lossless iff rocev2
    ack_path: str = "perhop"         # perhop | folded
    hop_prop_us: Optional[float] = None
    pfc_delay_ticks: Optional[int] = None
    subflows: int = 1
    # Shared-buffer bytes per switch for PFC accounting (the reference's
    # fabric default, sized so lossless backpressure is exercised).
    switch_buffer_bytes: float = 4e6
    pfc_alpha: float = 1.0           # dynamic threshold: a * free / (1 + a)
    pfc_xon_frac: float = 0.5        # resume below this fraction of xoff
    roce: Optional[RoCEParams] = None  # rocev2 constant overrides
    # Per-flow QP entropy from ``random.Random(seed)`` in flow order; None
    # hashes (src, dst, flow index).
    roce_entropy_seed: Optional[int] = None
    time_warp: bool = False
    trace_every: int = 1
    active_cap: Optional[int] = None
    shard: int = 0
    faults: Optional[FaultSpec] = None  # chaos schedule (sim.faults)

    @property
    def pfc_enabled(self) -> bool:
        return self.pfc if self.pfc is not None else (
            self.protocol == "rocev2")


def check_slice(cfg: FabricConfig) -> None:
    """Check ``cfg`` as the reference does, and raise
    ``NotImplementedError`` for what the port does not run yet (sharding),
    naming the ROADMAP item that brings it."""
    trace_every = 0 if cfg.time_warp else cfg.trace_every
    A = int(cfg.active_cap) if cfg.active_cap else 0
    if A < 0:
        raise ValueError(f"active_cap must be positive, got {A}")
    if A and trace_every:
        raise ValueError(
            "active_cap requires trace_every=0 (or time_warp): the dense "
            "trace samples all-flow means the active set skips")
    if A and int(cfg.shard) > 1:
        raise ValueError("active_cap and shard are mutually exclusive")
    if cfg.protocol not in PROTOCOLS:
        raise ValueError(f"unknown protocol {cfg.protocol!r}; "
                         f"expected one of {PROTOCOLS}")
    if cfg.faults is not None and not isinstance(cfg.faults, FaultSpec):
        raise TypeError(f"faults must be a FaultSpec, got "
                        f"{type(cfg.faults).__name__}")
    if int(cfg.shard) > 1:
        raise NotImplementedError(
            "repro_torch does not port shard > 1 yet (ROADMAP A11)")
    if cfg.lb_mode not in LB_MODES:
        raise ValueError(f"unknown lb_mode {cfg.lb_mode!r}; "
                         f"expected one of {LB_MODES}")
    if cfg.ack_path not in ACK_PATHS:
        raise ValueError(f"unknown ack_path {cfg.ack_path!r}; "
                         f"expected one of {ACK_PATHS}")
    if cfg.trace_every < 0:
        raise ValueError(f"trace_every must be >= 0, got {cfg.trace_every}")


def _hop_delays(cfg: FabricConfig) -> dict:
    """Per-hop delay constants: K (per-link propagation, whole ticks),
    D_same/D_cross (SACK return-pipe ticks), PD (PFC frame ticks), H (pipe
    depth).  Rounded once here, as in the reference."""
    net = cfg.net
    tick_us = net.mtu_serialize_us
    folded = cfg.ack_path == "folded" or cfg.delay_ticks is not None
    if folded:
        if cfg.delay_ticks is not None:
            d = int(cfg.delay_ticks)
        else:
            d = max(1, round(net.base_rtt_us / tick_us) - 3)
        K, D_same, D_cross = 0, d, d
    else:
        prop_us = (cfg.hop_prop_us if cfg.hop_prop_us is not None
                   else net.hop_prop_effective_us)
        k_f = prop_us / tick_us
        a_f = net.ack_serialize_us / tick_us
        K = int(round(k_f))

        def ret(hops):
            rtt_f = hops * (1.0 + a_f + 2.0 * k_f)
            return max(1, int(round(rtt_f - (hops - 1) * (1 + K))))

        D_same, D_cross = ret(2), ret(4)
    if cfg.pfc_delay_ticks is not None:
        PD = max(0, int(cfg.pfc_delay_ticks))
    else:
        PD = K
    return dict(K=K, D_same=D_same, D_cross=D_cross, PD=PD,
                H=max(D_same, D_cross) + 2)


def _make_protocol(cfg: FabricConfig):
    """cfg -> (Protocol, its parameters, ECN kmin/kmax in packets, target
    queueing delay in us)."""
    net = cfg.net
    if cfg.protocol == "strack":
        p = make_strack_params(net, max_paths=cfg.max_paths)
        return (make_strack_protocol(p), p, net.ecn_kmin_bytes / net.mtu_bytes,
                net.ecn_kmax_bytes / net.mtu_bytes, p.target_qdelay_us)
    rp = cfg.roce or make_roce_params(net)
    p = dq.make_roce_fab_params(net, rp)
    # "ECN threshold to one BDP for DCQCN" (paper Section 4.1)
    return (make_rocev2_protocol(p), p, rp.ecn_kmin_bdp * net.bdp_pkts,
            rp.ecn_kmax_bdp * net.bdp_pkts, net.base_rtt_us)


def _rto_us(cfg: FabricConfig) -> float:
    """The resolved protocol's retransmission timeout (us): the unit of
    the flap windows' retransmit attribution and of the fault horizon."""
    if cfg.protocol == "strack":
        return make_strack_params(cfg.net, max_paths=cfg.max_paths).rto_us
    rp = cfg.roce or make_roce_params(cfg.net)
    return dq.make_roce_fab_params(cfg.net, rp).rto_us


class FaultMasks(NamedTuple):
    """The fault schedule at one tick (stage 0c); each field is ``None``
    when the schedule has no entry of its class."""

    row_down: Optional[torch.Tensor]   # bool[Q]: rows blackholing
    nic_down: Optional[torch.Tensor]   # bool[NH]: NICs whose link is down
    row_duty: Optional[torch.Tensor]   # bool[Q]: False on a closed duty tick
    row_cor_p: Optional[torch.Tensor]  # f32[Q]: corruption probability
    fseed: Optional[int]               # the draw's seed (with row_cor_p)
    live: Optional[tuple]              # (live_list i32[T,S], n_live i32[T])


class Lanes(NamedTuple):
    """The active set's transport lanes at one tick (stage 0a)."""

    idx: torch.Tensor        # i32[A]: the slate, ascending, padded with N
    flow: torch.Tensor       # i32[A]: min(idx, N - 1), the lane's flow row
    src: torch.Tensor        # i32[A]: the lane's flow's source host
    dst: torch.Tensor        # i32[A]
    src_tor: torch.Tensor    # i32[A]
    fixed_ent: torch.Tensor  # i32[A]: the fixed-path entropy
    same_tor: torch.Tensor   # bool[A]


def _set_rows(vec: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              n: int) -> torch.Tensor:
    """``vec`` with rows ``idx`` set to ``val``; ``idx == n`` hits a trash
    row that is dropped."""
    out = torch.cat([vec, vec.new_zeros((1,) + tuple(vec.shape[1:]))])
    out[idx.long()] = val
    return out[:n]


def _clone_tree(tree):
    return tree_map(torch.clone, tree)


def _scatter_rows(tree_all, tree_rows, idx: torch.Tensor, n: int):
    """Scatter rows into per-flow state tuples; ``idx == n`` hits a trash
    row that is dropped."""
    def one(a, b):
        pad = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        out = torch.cat([a, pad], 0)
        out[idx.long()] = b
        return out[:n]
    return type(tree_all)(*[one(a, b) for a, b in zip(tree_all, tree_rows)])


def _scatter_pipe(pipe, rows, slot, fidx, valid, h, n):
    """Write per-delivery message rows into the [H, N] return pipe at
    per-flow slots; invalid entries hit a trash slot past the flattened
    pipe.  Generic over the message tuple (``SackMsg``, ``RoceMsg``)."""
    flat_idx = torch.where(valid, slot * n + fidx, h * n).long()

    def one(a, b):
        flat = a.reshape((h * n,) + tuple(a.shape[2:]))
        pad = torch.zeros((1,) + tuple(flat.shape[1:]), dtype=a.dtype,
                          device=a.device)
        out = torch.cat([flat, pad], 0)
        out[flat_idx] = b
        return out[:h * n].reshape(a.shape)

    return type(pipe)(*[one(a, b) for a, b in zip(pipe, rows)])


#: Programs built in this process (``FabricProgram`` and ``BatchProgram``
#: instances): the soak's one-program check reads its growth.
program_builds = 0


class FabricProgram:
    """One fabric program for fixed (topology, flows, ticks, config):
    the initial state, ``tick``, ``warp_target`` and the two loops."""

    def __init__(self, topo: FatTree, n_flows: int, n_ticks: int,
                 cfg: FabricConfig, device, dep: Optional[DepSpec] = None):
        global program_builds
        check_slice(cfg)
        program_builds += 1
        if n_flows <= 0:
            raise ValueError("fabric program needs at least one flow")
        self.cfg, self.n_ticks, self.device = cfg, int(n_ticks), device
        net = cfg.net
        self.proto, self.p, kmin_p, kmax_p, _ = _make_protocol(cfg)
        self.pfc = cfg.pfc_enabled
        self.at = ArrayTopo.from_fat_tree(topo, device)
        T, S, NH = topo.n_tor, topo.n_spine, topo.n_hosts
        HPT = topo.hosts_per_tor
        TS = T * S
        Q = 2 * TS + NH
        N = n_flows
        self.dep = dep if dep is not None else _trivial_dep(N, device)
        # a trace with edges releases messages inside a tick (stage 6)
        self.has_edges = int(self.dep.edge_parent.shape[0]) > 0
        tick_us = net.mtu_serialize_us
        drop_pkts = int(net.drop_bytes // net.mtu_bytes)
        buffer_pkts = int(cfg.switch_buffer_bytes // net.mtu_bytes)
        # worst-case same-tick arrivals at one queue
        max_extra = max(T, S + 2 * HPT)
        if self.pfc:
            # lossless: PFC backpressure bounds the queues; data is shed
            # only at the (never-expected) ring hard cap
            drop_pkts = buffer_pkts + max_extra
            hard_pkts = drop_pkts
        else:
            hard_pkts = drop_pkts + max_extra  # probes squeeze past drop
        cap = hard_pkts + max_extra + 2
        hd = _hop_delays(cfg)
        self.K, self.H, self.PD = hd["K"], hd["H"], hd["PD"]
        self.D_same, self.D_cross = hd["D_same"], hd["D_cross"]
        self.T, self.S, self.NH, self.HPT = T, S, NH, HPT
        self.TS, self.Q, self.N, self.cap = TS, Q, N, cap
        self.tick_us = tick_us
        self.trans_dims = TransDims(p=self.p, proto=self.proto,
                                    tick_us=tick_us,
                                    timer_every=cfg.timer_every,
                                    n_hosts=NH, n_real=N)
        self.serve_dims = ServeDims(
            n_tor=T, n_spine=S, n_hosts=NH, n_flows=N, cap=cap, K=self.K,
            data_drop_pkts=drop_pkts, hard_pkts=hard_pkts, kmin_p=kmin_p,
            kmax_p=kmax_p, mtu_bytes=net.mtu_bytes, tick_us=tick_us)
        self.pfc_dims = PfcDims(
            n_tor=T, n_spine=S, n_hosts=NH, hosts_per_tor=HPT, PD=self.PD,
            buffer_bytes=cfg.switch_buffer_bytes, alpha=cfg.pfc_alpha,
            xon_frac=cfg.pfc_xon_frac, mtu_bytes=net.mtu_bytes)
        # the active set's lane count; a cap at or above N is the dense
        # program (the reference's A = 0)
        A = int(cfg.active_cap) if cfg.active_cap else 0
        self.A = A if A < N else 0
        self.dims = dict(T=T, S=S, NH=NH, TS=TS, Q=Q, cap=cap, H=self.H,
                         K=self.K, D_same=self.D_same, D_cross=self.D_cross,
                         PD=self.PD, shard=1, active_cap=self.A)
        # The fault schedule's entry counts decide which chaos stages
        # exist; a fault-free program runs none of them.
        faults = cfg.faults if cfg.faults is not None else FaultSpec()
        self.F_ROW = (2 * len(faults.link_flaps) + len(faults.uplink_flaps)
                      + len(faults.host_flaps))
        self.F_NIC = len(faults.host_flaps)
        self.F_UP = len(faults.link_flaps) + len(faults.uplink_flaps)
        self.F_DEG = 2 * len(faults.link_degrade)
        self.F_COR = 2 * len(faults.link_corrupt) + len(faults.host_corrupt)
        self.FW = faults.n_flap_windows
        self.has_faults = faults.total_entries > 0
        # retransmits are attributed to a flap window and two RTOs after
        self.rto_ticks = int(math.ceil(_rto_us(cfg) / tick_us))
        self.fd: Optional[FaultData] = (
            build_fault_data(faults, T, S, HPT, device) if self.has_faults
            else None)

    # ---- set-up ---------------------------------------------------------
    def rebind(self, n_flows: int, n_ticks: int, cfg: FabricConfig,
               dep: DepSpec) -> None:
        """Take ``cfg``'s fault schedule as this program's data, for a
        trace of ``n_flows`` flows with dependency structure ``dep`` over
        ``n_ticks`` ticks; raises unless all of that, and ``cfg`` but for
        its data (``lb_mode``, ``roce_entropy_seed``, the fault values),
        are this program's.  :meth:`bind` then takes the trace."""
        check_slice(cfg)
        data = lambda c: dataclasses.replace(c, lb_mode="adaptive",
                                             roce_entropy_seed=None,
                                             faults=None)
        shape = lambda fs: (fs or FaultSpec()).shape_key
        mine, theirs = self.dep, dep
        same_dep = (mine.msg_ids == theirs.msg_ids
                    and mine.group_ids == theirs.group_ids
                    and all(torch.equal(getattr(mine, k).cpu(),
                                        getattr(theirs, k).cpu())
                            for k in ("msg_of_flow", "group_of_msg",
                                      "init_pending", "edge_parent",
                                      "edge_child")))
        if (n_flows != self.N or int(n_ticks) != self.n_ticks
                or data(cfg) != data(self.cfg) or not same_dep
                or shape(cfg.faults) != shape(self.cfg.faults)):
            raise ValueError(
                "rebind needs the program's flow count, horizon, dependency "
                "structure, fault shape and static config")
        self.cfg = cfg
        if self.has_faults:
            self.fd = build_fault_data(cfg.faults, self.T, self.S, self.HPT,
                                       self.device)

    def bind(self, src, dst, total_pkts, tail_b, arrival, lb_mode: str,
             ent0):
        """Per-run inputs (tensors on the program's device); ``ent0`` is
        each flow's pinned entropy (read by RoCEv2 only)."""
        dev, N, HPT = self.device, self.N, self.HPT
        self.src = src.to(dev, torch.int32)
        self.dst = dst.to(dev, torch.int32)
        self.total_pkts = total_pkts.to(dev, torch.int32)
        self.tail_b = tail_b.to(dev, torch.float32)
        self.arrival = arrival.to(dev, torch.int32)
        self.ent0 = ent0.to(dev, torch.int32)
        self.lb_code = LB_MODES.index(lb_mode)
        self.src_tor = torch.div(self.src, HPT, rounding_mode="floor")
        self.dst_tor = torch.div(self.dst, HPT, rounding_mode="floor")
        self.same_tor = self.src_tor == self.dst_tor
        iota = torch.arange(N, dtype=torch.int32, device=dev)
        self.fixed_ent = ecmp_mix(self.src, self.dst, iota) \
            % self.cfg.max_paths
        self.dflow = torch.where(self.same_tor, self.D_same, self.D_cross
                                 ).to(torch.int32)
        self.iota = iota
        # the per-flow columns a lane reads, gathered once a tick
        self.flow_cols = torch.stack([self.src, self.dst, self.src_tor,
                                      self.fixed_ent,
                                      self.same_tor.to(torch.int32)], 1)
        # the flows grouped by source: the transitions arbitrate each NIC
        # inside one block of it, the PFC stage sums a host's injections
        # in its order
        self.src_index = src_index(self.src, self.NH)
        self.pfc_flows = (pfc_flows(self.src, self.src_tor, self.same_tor,
                                    self.total_pkts, self.tail_b,
                                    self.src_index)
                          if self.pfc else None)

    def init_state(self) -> FabricState:
        dev, N, Q, cap, H = self.device, self.N, self.Q, self.cap, self.H
        T, S, NH = self.T, self.S, self.NH
        fl0, rcv0 = self.proto.init(self.total_pkts, self.tail_b, self.ent0)
        if self.A:
            # the active transition updates the flow record in place: it
            # must not share storage with the run's inputs
            fl0 = _clone_tree(fl0)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        neg = lambda n: torch.full((n,), -1, dtype=torch.int32, device=dev)
        q0 = PktQ(flow=torch.full((Q + 1, cap), -1, dtype=torch.int32,
                                  device=dev),
                  psn=zi(Q + 1, cap), ts=zf(Q + 1, cap), probe=zb(Q + 1, cap),
                  ecn=zb(Q + 1, cap), ent=zi(Q + 1, cap),
                  ready=zi(Q + 1, cap), spine=zi(Q + 1, cap))
        dep = self.dep
        return FabricState(
            flows=fl0, rcv=rcv0, q=q0, qhead=zi(Q + 1), qsize=zi(Q + 1),
            pipe=self.proto.empty_msgs(H, N, dev),
            obl_rr=torch.arange(N, dtype=torch.int32, device=dev)
            % self.cfg.max_paths,
            drops=zi(), delivered=zf(N), done_tick=neg(N),
            qbytes=zf(Q + 1), ing_host=zf(NH), ing_sd=zf(S, T),
            ing_up=zf(T, S), paused_nic=zb(NH), paused_sd=zb(S, T),
            paused_up=zb(T, S),
            pfc_line=zb(max(self.PD, 1), NH + 2 * self.TS), pauses=zi(),
            pending=dep.init_pending.to(dev).clone(),
            msg_done=zb(dep.n_msgs), msg_release_tick=neg(dep.n_msgs),
            msg_done_tick=neg(dep.n_msgs),
            group_done_tick=neg(dep.n_groups), act_overflow=zi(),
            ecn_marks=zi(), qdepth_hi=zi(Q + 1), blackholed=zi(),
            corrupt_drops=zi(), tx_rows=zi(Q + 1), win_retx=zi(self.FW))

    # ---- one tick -------------------------------------------------------
    def sendable_msg(self, st: FabricState, t: int) -> torch.Tensor:
        """Messages released at tick ``t``: dependencies met and open-loop
        arrival reached.  The mask of a tick's input state serves the
        transition, the warp loop's idle test and ``warp_target`` (see
        :meth:`run` for the messages a tick releases)."""
        return (st.pending <= 0) & (self.arrival <= t)

    def lane_slate(self, act_mask: torch.Tensor):
        """Stage 0a: the active set's lanes for ``act_mask`` (bool[N], the
        released flows not yet done) -> ``(Lanes, overflow)``.  The slate
        holds the indices of the first A set flows in ascending order,
        padded with N (``nonzero(size=A, fill_value=N)``), built at a fixed
        size on the device: each set flow's exclusive prefix count is its
        lane, and flows past the A-th land in a trash slot.  ``overflow``
        (an i32 scalar tensor) is 1 when more than A flows are live."""
        N, A = self.N, self.A
        m = act_mask.to(torch.int32)
        pos = torch.cumsum(m, 0, dtype=torch.int32) - m
        slot = torch.where(act_mask & (pos < A), pos, A).long()
        slate = torch.full((A + 1,), N, dtype=torch.int32,
                           device=self.device)
        slate.scatter_(0, slot, self.iota)
        return (self.lanes(slate[:A]),
                (m.sum(dtype=torch.int32) > A).to(torch.int32))

    def lanes(self, idx: torch.Tensor) -> Lanes:
        """The :class:`Lanes` of a slate ``idx`` (i32[A], ascending flow
        ids padded with N)."""
        flow = idx.clamp(max=self.N - 1)
        cols = self.flow_cols[flow.long()]
        return Lanes(idx=idx, flow=flow, src=cols[:, 0], dst=cols[:, 1],
                     src_tor=cols[:, 2], fixed_ent=cols[:, 3],
                     same_tor=cols[:, 4] != 0)

    def eff_pause(self, st: FabricState, t: int):
        """Stage 0b under PFC: the effective pause masks, the switches'
        decisions of ``PD`` ticks ago (pause frames travel one hop
        upstream) -> ``(eff_nic bool[NH], paused_row bool[Q])``; ``(None,
        None)`` on lossy queues."""
        if not self.pfc:
            return None, None
        NH, TS = self.NH, self.TS
        if self.PD > 0:
            eff = st.pfc_line[t % self.PD]
            eff_nic, eff_sd, eff_up = eff[:NH], eff[NH:NH + TS], eff[NH + TS:]
        else:
            eff_nic = st.paused_nic
            eff_sd, eff_up = st.paused_sd.reshape(-1), st.paused_up.reshape(-1)
        paused_row = torch.cat([eff_up, eff_sd,
                                torch.zeros_like(eff_nic)])
        return eff_nic, paused_row

    def fault_masks(self, t: int) -> Optional[FaultMasks]:
        """Stage 0c: the schedule's state at tick ``t``, ``None`` without
        faults.  Inactive windows scatter into a trash row, so inert
        entries change nothing; overlapping corruption entries take the
        larger probability.  Flapped uplinks leave the live set, which
        lists each ToR's live spines in ascending order (a stable argsort
        of the down mask, as the static list is built)."""
        if not self.has_faults:
            return None
        fd, Q, dev = self.fd, self.Q, self.device
        active = lambda t0, t1: (t0 <= t) & (t < t1)
        trash = lambda act, idx, n: torch.where(act, idx, n).long()
        row_down = nic_down = row_duty = row_cor_p = fseed = live = None
        if self.F_ROW:
            down = torch.zeros((Q + 1,), dtype=torch.bool, device=dev)
            down[trash(active(fd.flap_row_t0, fd.flap_row_t1), fd.flap_row,
                       Q)] = True
            row_down = down[:Q]
        if self.F_NIC:
            nic = torch.zeros((self.NH + 1,), dtype=torch.bool, device=dev)
            nic[trash(active(fd.flap_nic_t0, fd.flap_nic_t1), fd.flap_nic,
                      self.NH)] = True
            nic_down = nic[:self.NH]
        if self.F_DEG:
            closed = active(fd.deg_t0, fd.deg_t1) & ~duty_open(t, fd.deg_num)
            duty = torch.ones((Q + 1,), dtype=torch.bool, device=dev)
            duty[trash(closed, fd.deg_row, Q)] = False
            row_duty = duty[:Q]
        if self.F_COR:
            prob = torch.zeros((Q + 1,), dtype=torch.float32, device=dev)
            prob = prob.scatter_reduce(
                0, trash(active(fd.cor_t0, fd.cor_t1), fd.cor_row, Q),
                fd.cor_p, "amax")
            row_cor_p, fseed = prob[:Q], fd.seed
        if self.F_UP:
            up = torch.zeros((self.TS + 1,), dtype=torch.bool, device=dev)
            up[trash(active(fd.flap_up_t0, fd.flap_up_t1), fd.flap_up,
                     self.TS)] = True
            live_now = self.at.live_mask & ~up[:self.TS].view(self.T, self.S)
            n_live = torch.clamp_min(live_now.sum(1, dtype=torch.int32), 1)
            order = torch.argsort((~live_now).to(torch.int8), dim=1,
                                  stable=True).to(torch.int32)
            live = (order, n_live)
        return FaultMasks(row_down, nic_down, row_duty, row_cor_p, fseed,
                          live)

    def transport_args(self, st: FabricState, t: int,
                       sendable_msg: torch.Tensor, eff_nic=None,
                       lanes: Optional[Lanes] = None) -> tuple:
        """Arguments of the transition stage at tick ``t`` (stage 1):
        ``flow_transition``'s, or ``flow_transition_active``'s on the
        slate of ``lanes``; the program's source index last, on every
        protocol and path."""
        due = type(st.pipe)(*[a[t % self.H] for a in st.pipe])
        gate = (sendable_msg[self.dep.msg_of_flow.long()] if lanes is None
                else lanes.idx)
        return (st.flows, due, gate, self.src, t, self.trans_dims, eff_nic,
                self.src_index)

    def serve_args(self, st: FabricState, t: int, tx, probe_tx, sel,
                   probe_valid, paused_row=None,
                   fm: Optional[FaultMasks] = None,
                   lanes: Optional[Lanes] = None) -> tuple:
        """Stage 2 (spray/ECMP injection targets over the tick's live
        uplinks; a down NIC's data and probes withheld from the enqueue)
        and the arguments of the serve/enqueue stage at tick ``t``, per
        transport lane: the N flows, or the active set's ``lanes`` (the
        oblivious round robin then writes its pointers back through the
        slate).  Also returns the new oblivious round-robin pointers and
        the data injection rows."""
        TS, S = self.TS, self.S
        if lanes is None:
            src, dst, stor, same, fix = (self.src, self.dst, self.src_tor,
                                         self.same_tor, self.fixed_ent)
        else:
            src, dst, stor, same, fix = (lanes.src, lanes.dst, lanes.src_tor,
                                         lanes.same_tor, lanes.fixed_ent)
        obl_rr = st.obl_rr
        if not self.proto.uses_spray:  # the flow's pinned entropy
            ent, ent_probe = tx.entropy, probe_tx.entropy
        elif self.lb_code == 1:       # oblivious spray
            if lanes is None:
                ent_obl = (st.obl_rr + 1) % self.cfg.max_paths
                obl_rr = torch.where(sel, ent_obl, st.obl_rr)
            else:
                ent_obl = (st.obl_rr[lanes.flow.long()] + 1) \
                    % self.cfg.max_paths
                obl_rr = _set_rows(st.obl_rr,
                                   torch.where(sel, lanes.idx, self.N),
                                   ent_obl, self.N)
            ent, ent_probe = ent_obl, ent_obl
        elif self.lb_code == 2:     # fixed single path
            ent, ent_probe = fix, fix
        else:                       # adaptive spray (the transport's pick)
            ent, ent_probe = tx.entropy, probe_tx.entropy
        live = fm.live if fm is not None else None
        spine = self.at.ecmp_spine(src, dst, ent, live)
        inj_q = torch.where(same, 2 * TS + dst,
                            stor * S + spine).to(torch.int32)
        spine_p = self.at.ecmp_spine(src, dst, ent_probe, live)
        inj_qp = torch.where(same, 2 * TS + dst,
                             stor * S + spine_p).to(torch.int32)
        faults = (None,) * 4
        if fm is not None:
            if fm.nic_down is not None:
                lane_down = fm.nic_down[src.long()]
                sel = sel & ~lane_down
                probe_valid = probe_valid & ~lane_down
            faults = (fm.row_down, fm.row_duty, fm.row_cor_p, fm.fseed)
        args = (st.q, st.qhead, st.qsize, self.dst, self.dst_tor,
                self.total_pkts, self.tail_b, tx.psn, probe_tx.psn,
                ent.to(torch.int32), ent_probe.to(torch.int32), spine,
                spine_p, sel, probe_valid, inj_q, inj_qp, t, self.serve_dims,
                paused_row, *faults, None if lanes is None else lanes.flow)
        return args, obl_rr, inj_q

    def pfc_state(self, st: FabricState) -> PfcState:
        return PfcState(*[getattr(st, k) for k in PfcState._fields])

    def tick(self, st: FabricState, t: int):
        """One dense tick at tick index ``t`` -> (new_state, can_any,
        sendable_msg), in the reference's stage order.  ``can_any`` (a bool
        tensor) is whether any released flow offered a data packet this
        tick; ``sendable_msg`` is :meth:`sendable_msg` of the input state."""
        N, Q, TS, H = self.N, self.Q, self.TS, self.H
        dep = self.dep

        # 0. dependency gate (+ open-loop arrival ticks)
        sendable_msg = self.sendable_msg(st, t)
        msg_release_tick = torch.where(
            sendable_msg & (st.msg_release_tick < 0), t,
            st.msg_release_tick).to(torch.int32)

        # 0a. the active set's lanes: released flows not yet done
        lanes = None
        if self.A:
            done_prev = self.proto.done(st.flows)
            lanes, overflow = self.lane_slate(
                sendable_msg[dep.msg_of_flow.long()] & ~done_prev)

        # 0b. PFC effective-pause masks; 0c. the fault schedule's masks
        eff_nic, paused_row = self.eff_pause(st, t)
        fm = self.fault_masks(t)

        # 1. transport lanes: due ACKs, timers, sends, NIC arbitration
        targs = self.transport_args(st, t, sendable_msg, eff_nic, lanes)
        if lanes is None:
            flows, tx, probe_tx, probe_valid, sel, can_tx = flow_transition(
                *targs)
        else:
            (flows, tx, probe_tx, probe_valid, sel, can_tx,
             done_lane) = flow_transition_active(*targs)
        pipe_valid = st.pipe.valid.clone()
        pipe_valid[t % H] = False
        pipe = st.pipe._replace(valid=pipe_valid)

        # chaos counters of the transport stage: the retransmits committed
        # (before a down NIC blackholes them) and the NIC blackhole
        blackholed, corrupt_drops = st.blackholed, st.corrupt_drops
        if self.FW:
            rtx_n = (sel & tx.is_rtx).sum(dtype=torch.int32)
        if fm is not None and fm.nic_down is not None:
            lane_down = fm.nic_down[
                (self.src if lanes is None else lanes.src).long()]
            blackholed = blackholed + (
                (sel & lane_down).sum(dtype=torch.int32)
                + (probe_valid & lane_down).sum(dtype=torch.int32))

        # 2. spray / ECMP injection targets; 3. ring service + two-pass
        # enqueue (the ring is updated in place)
        args, obl_rr, inj_q = self.serve_args(st, t, tx, probe_tx, sel,
                                              probe_valid, paused_row, fm,
                                              lanes)
        (qhead, qsize, pop, has, ecn_out, pop_bytes, cand_qid, accept,
         drops_add, cand_bytes, surv, bh_add, cor_add) = serve_enqueue(*args)
        fclip = pop.flow.clamp(0, N - 1)
        drops = st.drops + drops_add
        if bh_add is not None:
            blackholed = blackholed + bh_add
            corrupt_drops = corrupt_drops + cor_add

        # 4. deliveries -> receivers -> SACK return pipe (the survivors:
        # blackholed and corrupted packets left their buffer but never
        # arrive)
        del_has = surv[2 * TS:]
        del_flow = fclip[2 * TS:]
        slot_del = (t + self.dflow[del_flow.long()]) % H
        rrows = type(st.rcv)(*[a[del_flow.long()] for a in st.rcv])
        d_probe = pop.probe[2 * TS:]
        rnew, sack = self.proto.on_data(
            rrows, pop.psn[2 * TS:], pop_bytes[2 * TS:], ecn_out[2 * TS:],
            pop.ent[2 * TS:], pop.ts[2 * TS:], d_probe,
            Now(t, self.tick_us))
        rnew = tp.tree_where(del_has, rnew, rrows)
        rcv = _scatter_rows(st.rcv, rnew,
                            torch.where(del_has, del_flow, N), N)
        delivered = st.delivered.clone()
        didx = torch.where(del_has & (~d_probe), del_flow, N).long()
        delivered = torch.cat([delivered, delivered.new_zeros(1)])
        delivered.index_add_(0, didx, pop_bytes[2 * TS:])
        delivered = delivered[:N]
        ecn_add = (del_has & ecn_out[2 * TS:] & (~d_probe)
                   ).sum(dtype=torch.int32)
        sack_valid = sack.valid & del_has
        pipe = _scatter_pipe(pipe, sack._replace(valid=sack_valid), slot_del,
                             del_flow, sack_valid, H, N)

        # 5. PFC (the reference's stage 6b): ingress accounting, the
        # pause/resume gates, the pause-frame delay line
        pfc = self.pfc_state(st)
        if self.pfc:
            pfc = pfc_account(pfc, has, pop, pop_bytes, cand_qid, cand_bytes,
                              accept, st.q, qhead, st.qsize, qsize, t,
                              self.pfc_flows, self.pfc_dims,
                              None if lanes is None else lanes.idx)

        # 6. completion + metrics (under the active set only lanes can
        # finish: a flow completes on an ACK, and every released unfinished
        # flow is a lane)
        if lanes is None:
            done = self.proto.done(flows)
        else:
            done = _set_rows(done_prev, lanes.idx, done_lane, N)
        done_tick = torch.where(done & (st.done_tick < 0), t,
                                st.done_tick).to(torch.int32)
        undone = torch.zeros(dep.n_msgs, dtype=torch.int32,
                             device=self.device)
        undone.index_add_(0, dep.msg_of_flow.long(), (~done).to(torch.int32))
        msg_done = undone == 0
        newly = msg_done & (~st.msg_done)
        pending = st.pending
        if self.has_edges:
            # newly completed messages release their children: sendable
            # from the next tick on, through stage 0's gate (an integer
            # sum, the same in any order)
            dec = torch.zeros(dep.n_msgs, dtype=torch.int32,
                              device=self.device)
            dec.index_add_(0, dep.edge_child.long(),
                           newly[dep.edge_parent.long()].to(torch.int32))
            pending = pending - dec
        msg_done_tick = torch.where(newly, t, st.msg_done_tick
                                    ).to(torch.int32)
        g_undone = torch.zeros(dep.n_groups, dtype=torch.int32,
                               device=self.device)
        g_undone.index_add_(0, dep.group_of_msg.long(),
                            (~msg_done).to(torch.int32))
        group_done_tick = torch.where(
            (g_undone == 0) & (st.group_done_tick < 0), t,
            st.group_done_tick).to(torch.int32)
        acc_data = accept[2 * TS:2 * TS + sel.shape[0]]
        tx_rows = st.tx_rows.clone()
        tx_rows.index_add_(0, torch.where(acc_data, inj_q, Q).long(),
                           torch.ones_like(inj_q))
        win_retx = st.win_retx
        if self.FW:
            fd = self.fd
            in_win = (fd.win_t0 <= t) & (t < fd.win_t1 + 2 * self.rto_ticks)
            win_retx = win_retx + torch.where(in_win, rtx_n, 0)

        new_st = st._replace(
            **pfc._asdict(),
            flows=flows, rcv=rcv, qhead=qhead, qsize=qsize, pipe=pipe,
            obl_rr=obl_rr, drops=drops, delivered=delivered,
            done_tick=done_tick, pending=pending, msg_done=msg_done,
            msg_release_tick=msg_release_tick, msg_done_tick=msg_done_tick,
            group_done_tick=group_done_tick,
            act_overflow=(st.act_overflow + overflow if lanes is not None
                          else st.act_overflow),
            ecn_marks=st.ecn_marks + ecn_add,
            qdepth_hi=torch.maximum(st.qdepth_hi, qsize), tx_rows=tx_rows,
            blackholed=blackholed, corrupt_drops=corrupt_drops,
            win_retx=win_retx)
        return new_st, can_tx.any(), sendable_msg

    # ---- event horizon ----------------------------------------------------
    def warp_target(self, st: FabricState, t: int,
                    sendable_msg: torch.Tensor) -> torch.Tensor:
        """Earliest tick > t that could change state given an idle fabric:
        the first timer sweep with an expired deadline, a return-pipe slot
        holding a SACK, the earliest head-of-queue arrival, a pending
        open-loop arrival, or the next edge of the fault schedule (an int32
        scalar tensor).  ``sendable_msg`` is
        the release mask at ``t`` (:meth:`sendable_msg`)."""
        n_ticks, H, Q, cap = self.n_ticks, self.H, self.Q, self.cap
        dev = self.device
        timer_ev, send_ev = self.proto.next_event(st.flows)
        sendable = sendable_msg[self.dep.msg_of_flow.long()]
        inf = float("inf")
        timer_ev = torch.where(sendable, timer_ev, inf)
        send_ev = torch.where(sendable, send_ev, inf)

        def ev_tick(ev, half_early):
            e = ev.min()
            ratio = e * recip32(self.tick_us) - f32(half_early)
            tk = torch.where(
                torch.isfinite(e),
                torch.floor(torch.clamp_max(ratio, f32(n_ticks))
                            ).to(torch.int32),
                n_ticks)
            return torch.clamp_min(tk, t + 1)

        every = self.cfg.timer_every
        t_timer = ev_tick(timer_ev, 0.0)
        t_timer = torch.div(t_timer + every - 1, every,
                            rounding_mode="floor") * every
        t_send = ev_tick(send_ev, 0.5)
        slots = torch.arange(H, dtype=torch.int32, device=dev)
        due = t + 1 + (slots - t - 1) % H
        t_pipe = torch.where(st.pipe.valid.any(1), due, n_ticks).min()
        qrows = torch.arange(Q, device=dev)
        rdy = st.q.ready[qrows, (st.qhead[:Q] % cap).long()]
        pending_q = st.qsize[:Q] > 0
        if self.pfc:
            # a paused row cannot change state while the fabric is idle
            dec_row = torch.cat([st.paused_up.reshape(-1),
                                 st.paused_sd.reshape(-1),
                                 torch.zeros_like(st.paused_nic)])
            pending_q = pending_q & (~dec_row)
        t_queue = torch.clamp_min(
            torch.where(pending_q, rdy, n_ticks).min(), t + 1)
        t_arr = torch.clamp_min(torch.where(
            (st.pending <= 0) & (st.msg_release_tick < 0), self.arrival,
            n_ticks).min(), t + 1)
        tgt = torch.minimum(torch.minimum(t_timer, t_send),
                            torch.minimum(t_pipe, t_queue))
        tgt = torch.minimum(tgt, t_arr)
        if self.has_faults:
            # a trip never jumps over a flap / degrade / corruption edge
            edges = self.fd.edges
            tgt = torch.minimum(tgt, torch.clamp_min(
                torch.where(edges > t, edges, n_ticks).min(), t + 1))
        return torch.clamp_max(tgt, n_ticks).to(torch.int32)

    # ---- the per-tick trace ----------------------------------------------
    def snapshot(self, st: FabricState) -> dict:
        """One trace row, derived from the state alone (so dense and
        decimated traces sample the same quantities): the queue sizes,
        drops, done flows, the mean congestion window, the delivered
        bytes, pauses and paused ports."""
        return {
            "qsize": st.qsize[:self.Q],
            "drops_trace": st.drops,
            "done": self.proto.done(st.flows).sum(dtype=torch.int32),
            "cwnd_mean": self.proto.cong_pkts(st.flows).mean(),
            "delivered": st.delivered,
            "pauses_trace": st.pauses,
            "paused_ports": (st.paused_nic.sum(dtype=torch.int32)
                             + st.paused_sd.sum(dtype=torch.int32)
                             + st.paused_up.sum(dtype=torch.int32)),
        }

    def run(self):
        """Run to ``n_ticks``: (final_state, {"warp_trips", "end_tick"} for
        the warp loop, the trace's rows under ``trace_every``, {} for
        plain dense ticking)."""
        st = self.init_state()
        return self.run_warp(st) if self.cfg.time_warp else self.run_dense(st)

    def run_dense(self, st):
        """Dense ticks to ``n_ticks`` from ``st``; under ``trace_every =
        k`` a trace row at the end of every block of k ticks (the
        ``n_ticks % k`` ticks past the last block run after it,
        unsampled), the rows kept on the device and stacked once at the
        end -> (final_state, {key: [rows, ...]}, or {})."""
        k = self.cfg.trace_every
        if not k:
            for t in range(self.n_ticks):
                st, _, _ = self.tick(st, t)
            return st, {}
        n_blocks, rem = divmod(self.n_ticks, k)
        rows = []
        for b in range(n_blocks):
            for i in range(k):
                st, _, _ = self.tick(st, b * k + i)
            rows.append(self.snapshot(st))
        for t in range(n_blocks * k, n_blocks * k + rem):
            st, _, _ = self.tick(st, t)
        if not rows:  # the trace has no row: its keys, with none
            return st, {key: v[None][:0]
                        for key, v in self.snapshot(st).items()}
        return st, {key: torch.stack([r[key] for r in rows])
                    for key in rows[0]}

    def run_warp(self, st):
        """The event-horizon loop from ``st`` to ``n_ticks`` ->
        (final_state, {"warp_trips", "end_tick"})."""
        t, trips = 0, 0
        while t < self.n_ticks:
            st, can_any, sendable_msg = self.tick(st, t)
            # a message this tick released wakes the next tick through
            # warp_target's t_arr (test_torch_collective_warp.py asserts it)
            idle = (~can_any) & ~(sendable_msg
                                  & (st.msg_release_tick < 0)).any()
            if self.pfc and self.PD > 0:
                # no pause frame in flight on the delay line
                dec = torch.cat([st.paused_nic, st.paused_sd.reshape(-1),
                                 st.paused_up.reshape(-1)])
                idle = idle & (st.pfc_line == dec[None, :]).all()
            t_next = torch.where(idle, self.warp_target(st, t, sendable_msg),
                                 t + 1)
            trips += 1
            t = int(t_next)   # one host read per trip
        return st, {"warp_trips": trips, "end_tick": t}


def _unflat(tree, b: int):
    """Leaves [B n, ...] as [B, n, ...] (a view)."""
    return tree_map(lambda x: x.view((b, -1) + tuple(x.shape[1:])), tree)


class BatchProgram(FabricProgram):
    """B entries of one fabric program (same topology, flow count,
    dependency structure, horizon and static config), stepped together:
    every state leaf and bound input has a leading axis B (the return
    pipe is kept [H, B, N], so that a tick's slot is one contiguous
    [B, N] block; :meth:`stacked` puts B first), and each stage is one
    kernel call for the batch (``kernels.flow_transition_batch``,
    ``serve_enqueue_batch``, ``pfc_account_batch``).  The fault schedule
    is shared by the batch; ``lb_mode`` and the pinned entropy are per
    entry.

    The warp loop keeps each entry's next tick: a trip ticks at the
    earliest, the entries due then step (``live``) and the others are
    frozen (the kernels leave their rows as they are and the tick's
    selects keep the rest), so each entry steps exactly the ticks, and
    counts exactly the trips, it does alone."""

    def __init__(self, topo: FatTree, n_flows: int, n_ticks: int,
                 cfg: FabricConfig, device, dep: Optional[DepSpec],
                 n_entries: int):
        super().__init__(topo, n_flows, n_ticks, cfg, device, dep)
        if self.A:
            raise NotImplementedError(
                "repro_torch does not run active_cap in a batch yet (ROADMAP "
                "A14); loop run_fabric_trace")
        self.B = int(n_entries)

    def bind(self, src, dst, total_pkts, tail_b, arrival, lb_modes,
             ent0):
        """Per-entry inputs, each with a leading axis B (``arrival``
        [B, n_msgs]); ``lb_modes`` one mode per entry."""
        dev, N, HPT, B = self.device, self.N, self.HPT, self.B
        self.src = src.to(dev, torch.int32)
        self.dst = dst.to(dev, torch.int32)
        self.total_pkts = total_pkts.to(dev, torch.int32)
        self.tail_b = tail_b.to(dev, torch.float32)
        self.arrival = arrival.to(dev, torch.int32)
        self.ent0 = ent0.to(dev, torch.int32)
        self.lb_codes = torch.tensor([LB_MODES.index(m) for m in lb_modes],
                                     dtype=torch.int32, device=dev)[:, None]
        self.src_tor = torch.div(self.src, HPT, rounding_mode="floor")
        self.dst_tor = torch.div(self.dst, HPT, rounding_mode="floor")
        self.same_tor = self.src_tor == self.dst_tor
        iota = torch.arange(N, dtype=torch.int32, device=dev)
        self.iota = iota
        self.fixed_ent = ecmp_mix(self.src, self.dst, iota[None, :]) \
            % self.cfg.max_paths
        self.dflow = torch.where(self.same_tor, self.D_same, self.D_cross
                                 ).to(torch.int32)
        # entry b's flow f is row b N + f of the flattened batch
        self.row0 = (torch.arange(B, dtype=torch.int32, device=dev)
                     * N)[:, None]
        self.src_index = src_index_batch(self.src, self.NH)
        self.pfc_flows = (pfc_flows_batch(self.src, self.src_tor,
                                          self.same_tor, self.total_pkts,
                                          self.tail_b, self.src_index)
                          if self.pfc else None)

    def init_state(self) -> FabricState:
        dev, B, N, Q, cap = self.device, self.B, self.N, self.Q, self.cap
        T, S, NH, H = self.T, self.S, self.NH, self.H
        fl0, rcv0 = self.proto.init(self.total_pkts.reshape(-1),
                                    self.tail_b.reshape(-1),
                                    self.ent0.reshape(-1))
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        neg = lambda n: torch.full((B, n), -1, dtype=torch.int32, device=dev)
        ring = lambda: zi(B, Q + 1, cap)
        q0 = PktQ(flow=torch.full((B, Q + 1, cap), -1, dtype=torch.int32,
                                  device=dev),
                  psn=ring(), ts=zf(B, Q + 1, cap), probe=zb(B, Q + 1, cap),
                  ecn=zb(B, Q + 1, cap), ent=ring(), ready=ring(),
                  spine=ring())
        dep = self.dep
        return FabricState(
            flows=_unflat(fl0, B), rcv=_unflat(rcv0, B), q=q0,
            qhead=zi(B, Q + 1), qsize=zi(B, Q + 1),
            pipe=tree_map(lambda x: x.view((H, B, N) + tuple(x.shape[2:])),
                          self.proto.empty_msgs(H, B * N, dev)),
            obl_rr=(self.iota % self.cfg.max_paths).repeat(B, 1),
            drops=zi(B), delivered=zf(B, N), done_tick=neg(N),
            qbytes=zf(B, Q + 1), ing_host=zf(B, NH), ing_sd=zf(B, S, T),
            ing_up=zf(B, T, S), paused_nic=zb(B, NH), paused_sd=zb(B, S, T),
            paused_up=zb(B, T, S),
            pfc_line=zb(B, max(self.PD, 1), NH + 2 * self.TS), pauses=zi(B),
            pending=dep.init_pending.to(dev).repeat(B, 1),
            msg_done=zb(B, dep.n_msgs), msg_release_tick=neg(dep.n_msgs),
            msg_done_tick=neg(dep.n_msgs),
            group_done_tick=neg(dep.n_groups), act_overflow=zi(B),
            ecn_marks=zi(B), qdepth_hi=zi(B, Q + 1), blackholed=zi(B),
            corrupt_drops=zi(B), tx_rows=zi(B, Q + 1),
            win_retx=zi(B, self.FW))

    def stacked(self, st: FabricState) -> FabricState:
        """``st`` with the return pipe's axes as every other leaf's: B
        first ([B, H, N, ...])."""
        return st._replace(pipe=tree_map(lambda x: x.transpose(0, 1),
                                         st.pipe))

    def eff_pause(self, st: FabricState, t: int):
        """Stage 0b for each entry -> ``(eff_nic bool[B, NH], paused_row
        bool[B, Q])``; ``(None, None)`` on lossy queues."""
        if not self.pfc:
            return None, None
        B, NH, TS = self.B, self.NH, self.TS
        if self.PD > 0:
            eff = st.pfc_line[:, t % self.PD]
            eff_nic = eff[:, :NH].contiguous()
            eff_sd, eff_up = eff[:, NH:NH + TS], eff[:, NH + TS:]
        else:
            eff_nic = st.paused_nic
            eff_sd = st.paused_sd.reshape(B, TS)
            eff_up = st.paused_up.reshape(B, TS)
        paused_row = torch.cat([eff_up, eff_sd, torch.zeros_like(eff_nic)], 1)
        return eff_nic, paused_row

    def entropies(self, st: FabricState, tx, probe_tx, sel):
        """Stage 2's path entropies of each entry's data and probes, and
        the new oblivious round-robin pointers, by the entry's
        ``lb_mode``."""
        if not self.proto.uses_spray:  # the flow's pinned entropy
            return tx.entropy, probe_tx.entropy, st.obl_rr
        ent_obl = (st.obl_rr + 1) % self.cfg.max_paths
        c = self.lb_codes   # LB_MODES' index, per entry
        pick = lambda adaptive: torch.where(
            c == 1, ent_obl, torch.where(c == 2, self.fixed_ent, adaptive))
        return (pick(tx.entropy), pick(probe_tx.entropy),
                torch.where((c == 1) & sel, ent_obl, st.obl_rr))

    def transport_args(self, st: FabricState, t: int,
                       sendable_msg: torch.Tensor, eff_nic=None,
                       live=None) -> tuple:
        """Arguments of ``flow_transition_batch`` at tick ``t`` (stage 1):
        each entry's due pipe slot and release mask, the entries that step
        last."""
        due = type(st.pipe)(*[a[t % self.H] for a in st.pipe])
        return (st.flows, due, sendable_msg[:, self.dep.msg_of_flow.long()],
                self.src, t, self.trans_dims, eff_nic, self.src_index, live)

    def serve_args(self, st: FabricState, t: int, tx, probe_tx, sel,
                   probe_valid, paused_row=None,
                   fm: Optional[FaultMasks] = None, live=None) -> tuple:
        """Stage 2 (each entry's injection targets by its ``lb_mode``; a
        down NIC's data and probes withheld) and the arguments of
        ``serve_enqueue_batch`` at tick ``t``; also the new oblivious
        round-robin pointers (moved on a send a down NIC then blackholes)
        and the data injection rows."""
        TS, S = self.TS, self.S
        ent, ent_p, obl_rr = self.entropies(st, tx, probe_tx, sel)
        live_up = fm.live if fm is not None else None
        spine = self.at.ecmp_spine(self.src, self.dst, ent, live_up)
        spine_p = self.at.ecmp_spine(self.src, self.dst, ent_p, live_up)
        host_q = 2 * TS + self.dst
        inj_q = torch.where(self.same_tor, host_q,
                            self.src_tor * S + spine).to(torch.int32)
        inj_qp = torch.where(self.same_tor, host_q,
                             self.src_tor * S + spine_p).to(torch.int32)
        faults = (None,) * 4
        if fm is not None:
            if fm.nic_down is not None:
                lane_down = fm.nic_down[self.src.long()]
                sel = sel & ~lane_down
                probe_valid = probe_valid & ~lane_down
            faults = (fm.row_down, fm.row_duty, fm.row_cor_p, fm.fseed)
        args = (st.q, st.qhead, st.qsize, self.dst, self.dst_tor,
                self.total_pkts, self.tail_b, tx.psn, probe_tx.psn,
                ent.to(torch.int32), ent_p.to(torch.int32), spine, spine_p,
                sel, probe_valid, inj_q, inj_qp, t, self.serve_dims,
                paused_row, *faults, live)
        return args, obl_rr, inj_q

    def tick(self, st: FabricState, t: int, live=None):
        """One dense tick ``t`` of every entry with ``live[b]`` (bool[B];
        None: all of them) -> (new_state, can_any bool[B], sendable_msg
        [B, n_msgs]); a frozen entry's state comes out as it went in."""
        B, N, Q, TS, H = self.B, self.N, self.Q, self.TS, self.H
        dep = self.dep
        mof = dep.msg_of_flow.long()
        at_live = (lambda m: m) if live is None else (
            lambda m: m & live.view((B,) + (1,) * (m.dim() - 1)))

        # 0. dependency gate (+ open-loop arrival ticks)
        sendable_msg = (st.pending <= 0) & (self.arrival <= t)
        msg_release_tick = torch.where(
            at_live(sendable_msg & (st.msg_release_tick < 0)), t,
            st.msg_release_tick).to(torch.int32)

        # 0b. PFC effective-pause masks; 0c. the (shared) fault schedule
        eff_nic, paused_row = self.eff_pause(st, t)
        fm = self.fault_masks(t)

        # 1. transport lanes (a frozen entry neither acks nor sends)
        flows, tx, probe_tx, probe_valid, sel, can_tx = \
            flow_transition_batch(*self.transport_args(st, t, sendable_msg,
                                                       eff_nic, live))
        pipe_valid = st.pipe.valid.clone()
        pipe_valid[t % H] = (False if live is None
                             else pipe_valid[t % H] & ~live[:, None])
        pipe = st.pipe._replace(valid=pipe_valid)

        # chaos counters of the transport stage: the retransmits committed
        # (before a down NIC blackholes them) and the NIC blackhole
        blackholed, corrupt_drops = st.blackholed, st.corrupt_drops
        if self.FW:
            rtx_n = (sel & tx.is_rtx).sum(1, dtype=torch.int32)
        if fm is not None and fm.nic_down is not None:
            lane_down = fm.nic_down[self.src.long()]
            blackholed = blackholed + (
                (sel & lane_down).sum(1, dtype=torch.int32)
                + (probe_valid & lane_down).sum(1, dtype=torch.int32))

        # 2. spray / ECMP injection targets; 3. ring service + enqueue
        args, obl_rr, inj_q = self.serve_args(st, t, tx, probe_tx, sel,
                                              probe_valid, paused_row, fm,
                                              live)
        (qhead, qsize, pop, has, ecn_out, pop_bytes, cand_qid, accept,
         drops_add, cand_bytes, surv, bh_add, cor_add) = \
            serve_enqueue_batch(*args)
        if bh_add is not None:
            blackholed = blackholed + bh_add
            corrupt_drops = corrupt_drops + cor_add

        # 4. deliveries -> receivers -> SACK return pipe, on the flattened
        # batch (entry b's flow f is row b N + f)
        del_has = surv[:, 2 * TS:]
        del_flow = pop.flow[:, 2 * TS:].clamp(0, N - 1)
        d_probe = pop.probe[:, 2 * TS:]
        slot_del = (t + self.dflow.gather(1, del_flow.long())) % H
        g_flow = (del_flow + self.row0).reshape(-1)
        has_f = del_has.reshape(-1)
        rcv_all = flat_entries(st.rcv)
        rrows = type(st.rcv)(*[a[g_flow.long()] for a in rcv_all])
        rnew, sack = self.proto.on_data(
            rrows, *[x[:, 2 * TS:].reshape(-1) for x in (
                pop.psn, pop_bytes, ecn_out, pop.ent, pop.ts)],
            d_probe.reshape(-1), Now(t, self.tick_us))
        rnew = tp.tree_where(has_f, rnew, rrows)
        rcv = _unflat(_scatter_rows(rcv_all, rnew,
                                    torch.where(has_f, g_flow, B * N),
                                    B * N), B)
        didx = torch.where(has_f & ~d_probe.reshape(-1), g_flow, B * N)
        delivered = torch.cat([st.delivered.reshape(-1),
                               st.delivered.new_zeros(1)])
        delivered.index_add_(0, didx.long(),
                             pop_bytes[:, 2 * TS:].reshape(-1))
        delivered = delivered[:B * N].view(B, N)
        ecn_add = (del_has & ecn_out[:, 2 * TS:] & ~d_probe
                   ).sum(1, dtype=torch.int32)
        sack_valid = sack.valid & has_f
        pipe = tree_map(
            lambda x: x.view((H, B, N) + tuple(x.shape[2:])),
            _scatter_pipe(tree_map(lambda x: x.view((H, B * N)
                                                    + tuple(x.shape[3:])),
                                   pipe),
                          sack._replace(valid=sack_valid),
                          slot_del.reshape(-1), g_flow, sack_valid, H,
                          B * N))

        # 5. PFC: ingress accounting, the gates, the delay line
        pfc = self.pfc_state(st)
        if self.pfc:
            pfc = pfc_account_batch(pfc, has, pop, pop_bytes, cand_qid,
                                    cand_bytes, accept, st.q, qhead,
                                    st.qsize, qsize, t, self.pfc_flows,
                                    self.pfc_dims, live)

        # 6. completion + metrics
        done = self.proto.done(flat_entries(flows)).view(B, N)
        done_tick = torch.where(at_live(done & (st.done_tick < 0)), t,
                                st.done_tick).to(torch.int32)
        msg_undone = torch.zeros((B, dep.n_msgs), dtype=torch.int32,
                                 device=self.device)
        msg_undone.index_add_(1, mof, (~done).to(torch.int32))
        msg_done = msg_undone == 0
        newly = msg_done & ~st.msg_done
        pending = st.pending
        if self.has_edges:
            dec = torch.zeros_like(pending)
            dec.index_add_(1, dep.edge_child.long(),
                           newly[:, dep.edge_parent.long()].to(torch.int32))
            pending = pending - dec
        msg_done_tick = torch.where(newly, t, st.msg_done_tick
                                    ).to(torch.int32)
        g_undone = torch.zeros((B, dep.n_groups), dtype=torch.int32,
                               device=self.device)
        g_undone.index_add_(1, dep.group_of_msg.long(),
                            (~msg_done).to(torch.int32))
        group_done_tick = torch.where(
            at_live((g_undone == 0) & (st.group_done_tick < 0)), t,
            st.group_done_tick).to(torch.int32)
        acc_data = accept[:, 2 * TS:2 * TS + N]
        rows = (torch.where(acc_data, inj_q, Q)
                + (torch.arange(B, device=self.device) * (Q + 1))[:, None])
        tx_rows = st.tx_rows.clone().view(-1)
        tx_rows.index_add_(0, rows.reshape(-1).long(),
                           at_live(torch.ones_like(inj_q, dtype=torch.bool)
                                   ).to(torch.int32).view(-1))
        win_retx = st.win_retx
        if self.FW:
            fd = self.fd
            in_win = (fd.win_t0 <= t) & (t < fd.win_t1 + 2 * self.rto_ticks)
            win_retx = win_retx + torch.where(in_win[None, :],
                                              rtx_n[:, None], 0)

        new_st = st._replace(
            **pfc._asdict(),
            flows=flows, rcv=rcv, qhead=qhead, qsize=qsize, pipe=pipe,
            obl_rr=obl_rr, drops=st.drops + drops_add, delivered=delivered,
            done_tick=done_tick, pending=pending, msg_done=msg_done,
            msg_release_tick=msg_release_tick, msg_done_tick=msg_done_tick,
            group_done_tick=group_done_tick,
            ecn_marks=st.ecn_marks + ecn_add,
            qdepth_hi=torch.maximum(st.qdepth_hi, qsize),
            tx_rows=tx_rows.view(B, Q + 1), blackholed=blackholed,
            corrupt_drops=corrupt_drops, win_retx=win_retx)
        return new_st, can_tx.any(1), sendable_msg

    def warp_target(self, st: FabricState, t: int,
                    sendable_msg: torch.Tensor) -> torch.Tensor:
        """:meth:`FabricProgram.warp_target` of each entry (i32[B]): every
        minimum is over the entry's own flows, slots, rows and messages."""
        n_ticks, H, Q, cap, B = self.n_ticks, self.H, self.Q, self.cap, \
            self.B
        dev = self.device
        timer_ev, send_ev = [x.view(B, self.N) for x in
                             self.proto.next_event(flat_entries(st.flows))]
        sendable = sendable_msg[:, self.dep.msg_of_flow.long()]
        inf = float("inf")
        timer_ev = torch.where(sendable, timer_ev, inf)
        send_ev = torch.where(sendable, send_ev, inf)

        def ev_tick(ev, half_early):
            e = ev.amin(1)
            ratio = e * recip32(self.tick_us) - f32(half_early)
            tk = torch.where(
                torch.isfinite(e),
                torch.floor(torch.clamp_max(ratio, f32(n_ticks))
                            ).to(torch.int32),
                n_ticks)
            return torch.clamp_min(tk, t + 1)

        every = self.cfg.timer_every
        t_timer = ev_tick(timer_ev, 0.0)
        t_timer = torch.div(t_timer + every - 1, every,
                            rounding_mode="floor") * every
        t_send = ev_tick(send_ev, 0.5)
        slots = torch.arange(H, dtype=torch.int32, device=dev)
        due = (t + 1 + (slots - t - 1) % H)[:, None]
        t_pipe = torch.where(st.pipe.valid.any(2), due, n_ticks).amin(0)
        head = (st.qhead[:, :Q] % cap).long()
        rdy = st.q.ready[:, :Q].gather(2, head[:, :, None])[:, :, 0]
        pending_q = st.qsize[:, :Q] > 0
        if self.pfc:
            dec_row = torch.cat([st.paused_up.reshape(B, -1),
                                 st.paused_sd.reshape(B, -1),
                                 torch.zeros_like(st.paused_nic)], 1)
            pending_q = pending_q & ~dec_row
        t_queue = torch.clamp_min(
            torch.where(pending_q, rdy, n_ticks).amin(1), t + 1)
        t_arr = torch.clamp_min(torch.where(
            (st.pending <= 0) & (st.msg_release_tick < 0), self.arrival,
            n_ticks).amin(1), t + 1)
        tgt = torch.minimum(torch.minimum(t_timer, t_send),
                            torch.minimum(t_pipe, t_queue))
        tgt = torch.minimum(tgt, t_arr)
        if self.has_faults:
            edges = self.fd.edges
            tgt = torch.minimum(tgt, torch.clamp_min(
                torch.where(edges > t, edges, n_ticks).min(), t + 1))
        return torch.clamp_max(tgt, n_ticks).to(torch.int32)

    def snapshot(self, st: FabricState) -> dict:
        """:meth:`FabricProgram.snapshot` of each entry (a leading axis B
        on every key)."""
        B, N = self.B, self.N
        flows = flat_entries(st.flows)
        return {
            "qsize": st.qsize[:, :self.Q],
            "drops_trace": st.drops,
            "done": self.proto.done(flows).view(B, N).sum(
                1, dtype=torch.int32),
            "cwnd_mean": self.proto.cong_pkts(flows).view(B, N).mean(1),
            "delivered": st.delivered,
            "pauses_trace": st.pauses,
            "paused_ports": (st.paused_nic.sum(1, dtype=torch.int32)
                             + st.paused_sd.sum((1, 2), dtype=torch.int32)
                             + st.paused_up.sum((1, 2), dtype=torch.int32)),
        }

    def run_warp(self, st):
        """The event-horizon loop of every entry from ``st`` ->
        (final_state, {"warp_trips", "end_tick"}, i32[B] each); the trace
        rows of :meth:`run_dense` come out [rows, B, ...]."""
        B = self.B
        self.trips = 0   # the loop's trips (each steps one or more entries)
        nxt = torch.zeros((B,), dtype=torch.int32, device=self.device)
        trips = torch.zeros_like(nxt)
        t = 0
        while t < self.n_ticks:
            live = nxt == t
            st, can_any, sendable_msg = self.tick(st, t, live)
            idle = ~can_any & ~(sendable_msg
                                & (st.msg_release_tick < 0)).any(1)
            if self.pfc and self.PD > 0:
                dec = torch.cat([st.paused_nic, st.paused_sd.reshape(B, -1),
                                 st.paused_up.reshape(B, -1)], 1)
                idle = idle & (st.pfc_line == dec[:, None, :]).all(2).all(1)
            step = torch.where(idle, self.warp_target(st, t, sendable_msg),
                               t + 1)
            nxt = torch.where(live, step, nxt)
            trips = trips + live.to(torch.int32)
            t = int(nxt.min())   # one host read per trip
            self.trips += 1
        return st, {"warp_trips": trips, "end_tick": nxt}


# --------------------------------------------------------------------------- #
# Host-side inputs and metrics
# --------------------------------------------------------------------------- #

def _check_flows(flows, n_hosts: int) -> None:
    for s_, d_, _ in flows:
        if not (0 <= s_ < n_hosts and 0 <= d_ < n_hosts and s_ != d_):
            raise ValueError(f"bad flow endpoint (src={s_}, dst={d_}) for "
                             f"{n_hosts} hosts")


def _flow_arrays(flows, cfg: FabricConfig):
    """Host-side inputs for one flow list: ``(src, dst, total_pkts,
    tail_bytes, ent0)``; ``tail_bytes`` is the wire size of each flow's
    final PSN, ``ent0`` each flow's pinned entropy (RoCEv2's one QP):
    ``random.Random(cfg.roce_entropy_seed)`` draws in flow order, else a
    hash of (src, dst, flow index)."""
    mtu = cfg.net.mtu_bytes
    src = torch.tensor([f[0] for f in flows], dtype=torch.int32)
    dst = torch.tensor([f[1] for f in flows], dtype=torch.int32)
    npkts = [max(1, int(math.ceil(f[2] / mtu))) for f in flows]
    total_pkts = torch.tensor(npkts, dtype=torch.int32)
    tail_bytes = torch.tensor(
        [max(1.0, float(f[2]) - (n - 1) * mtu)
         for f, n in zip(flows, npkts)], dtype=torch.float32)
    if cfg.roce_entropy_seed is not None:
        rng = random.Random(cfg.roce_entropy_seed)
        ent0 = torch.tensor([rng.randrange(1 << 16) for _ in flows],
                            dtype=torch.int32)
    else:
        iota = torch.arange(len(flows), dtype=torch.int32)
        ent0 = ecmp_mix(src, dst, iota + 40503) % (1 << 16)
    return src, dst, total_pkts, tail_bytes, ent0


def _arrival_array(messages) -> torch.Tensor:
    """Per-message earliest-launch ticks (i32[n_msgs], input order)."""
    return torch.tensor([max(0, int(getattr(m, "arrival", 0)))
                         for m in messages], dtype=torch.int32)


def _us_or_none(ticks, ok, tick_us: float) -> list:
    us = np.asarray(ticks, dtype=np.float64) * tick_us
    return [float(v) if o else None
            for v, o in zip(us, np.asarray(ok, dtype=bool))]


def _finish_metrics(metrics: dict, fin: dict, cfg: FabricConfig,
                    dims: dict, dep: DepSpec) -> dict:
    """Host-side derived metrics for one run (``fin``: final-state arrays
    as numpy).  ``fct_us`` is message-level: release to completion."""
    T, S, TS = dims["T"], dims["S"], dims["TS"]
    tick_us = cfg.net.mtu_serialize_us
    target_qdelay_us = _make_protocol(cfg)[4]
    metrics["tick_us"] = tick_us
    metrics["trace_every"] = 0 if cfg.time_warp else cfg.trace_every
    metrics["target_qdelay_pkts"] = target_qdelay_us / tick_us
    dt = np.asarray(fin["done_tick"])
    metrics["done_tick"] = dt
    metrics["subflow_fct_us"] = _us_or_none(dt + 1, dt >= 0, tick_us)
    mdt = np.asarray(fin["msg_done_tick"])
    mrt = np.asarray(fin["msg_release_tick"])
    metrics["fct_us"] = _us_or_none(mdt + 1 - np.maximum(mrt, 0),
                                    mdt >= 0, tick_us)
    metrics["msg_release_us"] = _us_or_none(mrt, mrt >= 0, tick_us)
    metrics["msg_ids"] = dep.msg_ids
    gof = np.asarray(dep.group_of_msg.cpu())
    metrics["msg_group_ids"] = tuple(dep.group_ids[g] for g in gof)
    metrics["drops"] = int(fin["drops"])
    metrics["pauses"] = int(fin["pauses"])
    ov = int(fin["act_overflow"])
    if ov:
        raise RuntimeError(
            f"active_cap={dims.get('active_cap')} exceeded on {ov} tick(s) "
            f"— sendable flows beyond the cap would silently stall; raise "
            f"FabricConfig.active_cap (or set it to None)")
    metrics["delivered_final"] = np.asarray(fin["delivered"])
    metrics["ecn_marks"] = int(fin["ecn_marks"])
    metrics["qdepth_hi_pkts"] = np.asarray(fin["qdepth_hi"])[:dims["Q"]]
    metrics["retransmits"] = int(np.sum(fin["retx"]))
    for k in ("rto_fires", "sack_recoveries", "gbn_rewinds"):
        metrics[k] = int(np.sum(fin[k]))
    metrics["blackholed_pkts"] = int(fin["blackholed"])
    metrics["corrupt_drops"] = int(fin["corrupt_drops"])
    metrics["tx_rows_pkts"] = np.asarray(fin["tx_rows"])[:dims["Q"]]
    metrics["win_retx"] = np.asarray(fin["win_retx"])
    # group completion only for traces with group structure, as in the
    # reference: dependency edges or several groups
    if int(dep.edge_parent.shape[0]) > 0 or dep.n_groups > 1:
        gdt = np.asarray(fin["group_done_tick"])
        metrics["group_ids"] = dep.group_ids
        metrics["group_done_us"] = _us_or_none(gdt + 1, gdt >= 0, tick_us)
    metrics["queue_ids"] = {
        "tor_up": lambda t_, s_: t_ * S + s_,
        "spine_down": lambda s_, t_: TS + s_ * T + t_,
        "host_down": lambda h_: 2 * TS + h_,
    }
    return metrics


_FINAL_KEYS = ("done_tick", "msg_done_tick", "msg_release_tick",
               "group_done_tick", "drops", "pauses", "delivered",
               "act_overflow", "ecn_marks", "qdepth_hi", "blackholed",
               "corrupt_drops", "tx_rows", "win_retx")


def trace_program(topo: FatTree, messages, n_ticks: int, cfg: FabricConfig,
                  device, prog: Optional[FabricProgram] = None
                  ) -> FabricProgram:
    """The bound :class:`FabricProgram` of a message trace on ``device``:
    each message striped over ``cfg.subflows`` sub-flows, its dependency
    edges and open-loop arrival kept.

    With ``prog``, that program is re-bound to this trace instead of a new
    one built (the soak's one program): the trace must have its flow
    count and dependency structure, and ``cfg`` its config but for what is
    data to it (``lb_mode``, ``roce_entropy_seed`` and the fault schedule's
    values at its ``shape_key``); ``n_ticks`` must be its horizon."""
    flows, dep = expand_messages(messages, cfg.subflows, device)
    _check_flows(flows, topo.n_hosts)
    if cfg.faults is not None:
        validate_faults(cfg.faults, topo)
    src, dst, total_pkts, tails, ent0 = _flow_arrays(flows, cfg)
    if prog is None:
        prog = FabricProgram(topo, len(flows), n_ticks, cfg, device, dep)
    else:
        prog.rebind(len(flows), n_ticks, cfg, dep)
    prog.bind(src, dst, total_pkts, tails, _arrival_array(messages),
              cfg.lb_mode, ent0)
    return prog


def run_program(prog: FabricProgram):
    """Run a bound :class:`FabricProgram` -> (final_state, metrics), the
    host metrics of :func:`run_fabric_trace`."""
    final, metrics = prog.run()
    fin = {k: getattr(final, k).cpu().numpy() for k in _FINAL_KEYS}
    fin["retx"] = prog.proto.stat_retx(final.flows).cpu().numpy()
    fin.update({k: v.cpu().numpy() for k, v in
                prog.proto.stat_recovery(final.flows).items()})
    metrics = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    metrics = _finish_metrics(metrics, fin, prog.cfg, prog.dims, prog.dep)
    return final, metrics


def run_fabric_trace(topo: FatTree, messages, n_ticks: int,
                     cfg: FabricConfig = FabricConfig(), device="cuda"):
    """Simulate a dependency-edged message trace on the fat-tree ->
    (final_state, metrics).

    ``messages`` are records with ``mid/src/dst/size/deps/group/arrival``
    (``workloads.Message``); ``cfg.subflows`` stripes each message over
    that many single-QP sub-flows.  Runs on ``device`` ("cuda" by
    default; raises without a GPU)."""
    dev = resolve_device(device)
    check_slice(cfg)
    return run_program(trace_program(topo, messages, n_ticks, cfg, dev))


def run_fabric(topo: FatTree, flows: Sequence[Tuple[int, int, float]],
               n_ticks: int, cfg: FabricConfig = FabricConfig(),
               device="cuda"):
    """Simulate ``flows`` = [(src_host, dst_host, msg_bytes), ...]; the
    deps-free special case of :func:`run_fabric_trace`."""
    msgs = [_FlowMsg(mid=i, src=s, dst=d, size=b)
            for i, (s, d, b) in enumerate(flows)]
    return run_fabric_trace(topo, msgs, n_ticks, cfg, device=device)


def batch_program(topo: FatTree, messages_batch, n_ticks: int,
                  cfg: FabricConfig, lb_modes=None, entropy_seeds=None,
                  device="cuda") -> BatchProgram:
    """The bound :class:`BatchProgram` of a batch of message traces on
    ``device``, after the reference's checks of the batch (see
    :func:`run_fabric_trace_batch`)."""
    if not messages_batch:
        raise ValueError("need at least one message trace")
    if int(cfg.shard) > 1:
        raise ValueError(
            "cfg.shard > 1 builds one shard_map program over the device "
            "mesh; vmapped batches are unsupported — loop "
            "run_fabric_trace instead")
    B = len(messages_batch)
    if lb_modes is None:
        lb_modes = [cfg.lb_mode] * B
    if entropy_seeds is None:
        entropy_seeds = [cfg.roce_entropy_seed] * B
    if len(lb_modes) != B or len(entropy_seeds) != B:
        raise ValueError(
            f"lb_modes/entropy_seeds must match the batch: got "
            f"{len(lb_modes)}/{len(entropy_seeds)} for {B} traces")
    for m in lb_modes:
        if m not in LB_MODES:
            raise ValueError(f"unknown lb_mode {m!r}; "
                             f"expected one of {LB_MODES}")
    dev = resolve_device(device)
    check_slice(cfg)
    expanded = [expand_messages(ms, cfg.subflows) for ms in messages_batch]
    dep = expanded[0][1]
    for i, (_, d) in enumerate(expanded[1:], start=1):
        if int(d.msg_of_flow.shape[0]) != int(dep.msg_of_flow.shape[0]):
            raise ValueError(
                f"batch entry {i} has {int(d.msg_of_flow.shape[0])} "
                f"sub-flows, entry 0 has {int(dep.msg_of_flow.shape[0])}")
        same_deps = (
            d.edge_parent.shape == dep.edge_parent.shape
            and bool(torch.equal(d.edge_parent, dep.edge_parent))
            and bool(torch.equal(d.edge_child, dep.edge_child))
            and bool(torch.equal(d.group_of_msg, dep.group_of_msg)))
        if not same_deps:
            raise ValueError(
                f"batch entry {i} has a different dependency/group "
                f"structure than entry 0 — the whole batch runs under "
                f"entry 0's static DepSpec, so structures must match")
    if cfg.faults is not None:
        validate_faults(cfg.faults, topo)
    arrs = []
    for (flows, _), seed in zip(expanded, entropy_seeds):
        _check_flows(flows, topo.n_hosts)
        arrs.append(_flow_arrays(
            flows, dataclasses.replace(cfg, roce_entropy_seed=seed)))
    prog = BatchProgram(topo, len(expanded[0][0]), n_ticks, cfg, dev,
                        _to_device(dep, dev), B)
    prog.bind(*[torch.stack([a[k] for a in arrs]) for k in range(4)],
              torch.stack([_arrival_array(m) for m in messages_batch]),
              lb_modes, torch.stack([a[4] for a in arrs]))
    return prog


def run_fabric_trace_batch(topo: FatTree, messages_batch, n_ticks: int,
                           cfg: FabricConfig = FabricConfig(),
                           lb_modes: Optional[Sequence[str]] = None,
                           entropy_seeds: Optional[Sequence] = None,
                           device="cuda"):
    """Run a batch of same-structure message traces as one
    :class:`BatchProgram` -> (stacked_final_state, [metrics per entry]).

    The entries share the topology and the dependency structure (message
    count, deps, groups, sub-flow fan-out); their src/dst/size patterns,
    ``lb_modes`` (per-entry spray mode) and ``entropy_seeds`` (per-entry
    QP-entropy seed, RoCEv2) may differ, and the fault schedule is shared.
    Each entry's final state, trace rows and warp trips are those it gives
    alone through :func:`run_fabric_trace`.  Every leaf of the returned
    state has a leading axis B."""
    prog = batch_program(topo, messages_batch, n_ticks, cfg, lb_modes,
                         entropy_seeds, device)
    B = prog.B
    final, stacked = prog.run()
    final = prog.stacked(final)
    flows_all = flat_entries(final.flows)
    fin_all = {k: getattr(final, k).cpu().numpy() for k in _FINAL_KEYS}
    fin_all["retx"] = prog.proto.stat_retx(flows_all).view(B, -1
                                                           ).cpu().numpy()
    fin_all.update({k: v.view(B, -1).cpu().numpy() for k, v in
                    prog.proto.stat_recovery(flows_all).items()})
    # [B] counters, or [rows, B, ...] trace rows: entry i of each
    stacked = {k: v.cpu().numpy() for k, v in stacked.items()}
    per_entry = []
    for i in range(B):
        m = {k: (v[i] if k in ("warp_trips", "end_tick") else v[:, i])
             for k, v in stacked.items()}
        fin_i = {k: v[i] for k, v in fin_all.items()}
        per_entry.append(_finish_metrics(m, fin_i, cfg, prog.dims,
                                         prog.dep))
    return final, per_entry


def run_fabric_batch(topo: FatTree,
                     flows_batch: Sequence[Sequence[Tuple[int, int, float]]],
                     n_ticks: int, cfg: FabricConfig = FabricConfig(),
                     device="cuda"):
    """Run a batch of same-shape flow lists (e.g. seeds of one workload)
    as one :class:`BatchProgram` (the deps-free special case of
    :func:`run_fabric_trace_batch`)."""
    sizes = {len(fl) for fl in flows_batch}
    if len(sizes) != 1:
        raise ValueError(f"flow lists must be same-shape, got sizes {sizes}")
    msgs_batch = [[_FlowMsg(mid=i, src=s, dst=d, size=b)
                   for i, (s, d, b) in enumerate(fl)] for fl in flows_batch]
    return run_fabric_trace_batch(topo, msgs_batch, n_ticks, cfg,
                                  device=device)


def summarize(metrics: dict) -> dict:
    """Event-oracle-style summary (max/avg FCT, unfinished, drops, pauses
    and the observability counters), keyed as the reference's; a trace
    with dependency edges or several groups adds the per-group keys
    (``group_fct``, ``max_collective_time``, ``finished_groups``,
    ``total_groups``), keyed by the caller's group ids."""
    fcts = [f for f in metrics["fct_us"] if f is not None]
    out = {
        "max_fct": max(fcts) if fcts else float("nan"),
        "avg_fct": sum(fcts) / len(fcts) if fcts else float("nan"),
        "unfinished": sum(1 for f in metrics["fct_us"] if f is None),
        "drops": int(metrics["drops"]),
        "pauses": int(metrics["pauses"]),
    }
    if "ecn_marks" in metrics:
        out["ecn_marks"] = int(metrics["ecn_marks"])
    for k in ("retransmits", "rto_fires", "sack_recoveries",
              "gbn_rewinds", "blackholed_pkts", "corrupt_drops"):
        out[k] = int(metrics.get(k, 0))
    txr = metrics.get("tx_rows_pkts")
    if txr is not None:
        out["tx_rows_pkts"] = tuple(int(v)
                                    for v in np.asarray(txr).reshape(-1))
    wr = metrics.get("win_retx")
    if wr is not None and np.asarray(wr).size:
        out["win_retx"] = tuple(int(v) for v in np.asarray(wr).reshape(-1))
    qhi = metrics.get("qdepth_hi_pkts")
    if qhi is not None:
        qhi = np.asarray(qhi)
        out["qdepth_max_pkts"] = int(qhi.max()) if qhi.size else 0
        out["qdepth_p99_pkts"] = (float(np.percentile(qhi, 99))
                                  if qhi.size else 0.0)
    gd = metrics.get("group_done_us")
    if gd is not None:
        gids = metrics.get("group_ids", tuple(range(len(gd))))
        group_fct = {g: t for g, t in zip(gids, gd) if t is not None}
        out["group_fct"] = group_fct
        out["max_collective_time"] = (max(group_fct.values())
                                      if group_fct else float("nan"))
        out["finished_groups"] = len(group_fct)
        out["total_groups"] = len(gd)
    mgids = metrics.get("msg_group_ids")
    if mgids is not None:
        by_g: dict = {}
        for g, f in zip(mgids, metrics["fct_us"]):
            by_g.setdefault(g, []).append(f)
        tenant = {}
        for g, fs in by_g.items():
            done = [f for f in fs if f is not None]
            row = {"count": len(fs), "unfinished": len(fs) - len(done)}
            if done:
                arr = np.asarray(done, dtype=np.float64)
                row.update(p50=float(np.percentile(arr, 50)),
                           p99=float(np.percentile(arr, 99)),
                           avg=float(arr.mean()), max=float(arr.max()))
            else:
                row.update(p50=float("nan"), p99=float("nan"),
                           avg=float("nan"), max=float("nan"))
            tenant[g] = row
        out["tenant_fct"] = tenant
    return out
