"""Event-driven packet-level network simulator (the semantics oracle).

htsim-style discrete-event simulation of the paper's evaluation fabric:

* directional FIFO queues with serialization + propagation delay,
* egress ECN marking (mark on dequeue from the residual queue depth —
  the paper's "egress-marked ECN" early signal),
* silent tail drops at ``drop_bytes`` (STrack mode, lossy),
* PFC with per-ingress accounting and dynamic-threshold shared buffer
  (RoCEv2 mode, lossless),
* pull-based host NICs (ACK-clocked window transports ask the flow engine
  for the next packet only when the wire is free),
* pluggable workloads (permutation / incast / collective traces) via a
  message-completion callback.

Transports plug in through the engines in ``repro_torch.core.ref``
(STrack) and the RoCEv2/DCQCN baseline.  Times in us, sizes in bytes.

This module is the *semantics oracle*, the port's copy of
``repro.sim.events``: the same code on the same f64 values and the same
Python ``random`` draws, so that it equals the reference's oracle bit for
bit.  Both protocols, dependency-scheduled collective traces and 4-QP
sub-flow striping also run on the port's fabric (``fabric.py``), which is
held against this oracle inside the fuzz parity band.  The public entry
point is ``workloads.run(scenario, RunConfig(backend="events"))``; it
runs on the host, in plain Python floats.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable, Optional

from ..core import ref
from ..core.params import (NetworkSpec, RoCEParams, STrackParams,
                           make_roce_params, make_strack_params)
from .faults import FaultSpec, fault_u01_py, validate_faults
from .topology import FatTree, _mix

#: Legacy default per-link propagation delay (us).  Since the per-hop
#: latency model landed, NetSim derives its propagation from
#: ``NetworkSpec.hop_prop_effective_us`` — the same knob the jitted fabric
#: uses — so an uncongested cross-ToR data+ACK round trip realizes exactly
#: ``net.base_rtt_us`` on BOTH backends.  This constant remains only as
#: the historical reference value.
PROP_DELAY_US = 0.5


class Queue:
    """Directional FIFO with serialization, ECN egress marking, drops, PFC."""

    __slots__ = ("name", "rate", "prop", "fifo", "occ", "busy", "paused",
                 "ecn_kmin", "ecn_kmax", "drop_bytes", "switch",
                 "drops", "max_occ", "delay_log", "sim", "drain_host",
                 "flap_wins", "degrade", "cor_wins", "fault_row")

    def __init__(self, sim, name, rate, prop, ecn_kmin=None, ecn_kmax=None,
                 drop_bytes=None, switch=None, drain_host=None):
        self.sim = sim
        self.name = name
        self.rate = rate            # bytes/us
        self.prop = prop            # us
        self.fifo: list = []        # list of (pkt, next_hop, enq_ts)
        self.occ = 0.0              # bytes
        self.busy = False
        self.paused = False
        self.ecn_kmin = ecn_kmin
        self.ecn_kmax = ecn_kmax
        self.drop_bytes = drop_bytes
        self.switch = switch        # Switch owning this EGRESS queue (or None)
        self.drain_host = drain_host  # host id to re-pump when NIC drains
        self.drops = 0
        self.max_occ = 0.0
        self.delay_log: Optional[list] = None
        # chaos schedule (sim/faults.py), windows in us:
        self.flap_wins: tuple = ()   # (t0, t1): link down, blackhole
        self.degrade: tuple = ()     # (t0, t1, credit): scaled service rate
        self.cor_wins: tuple = ()    # (t0, t1, p): seeded corruption drop
        self.fault_row = -1          # fabric queue-row id (PRNG keying)

    def enqueue(self, pkt, next_hop, now):
        sim = self.sim
        if self.drop_bytes is not None and pkt.kind == ref.DATA \
                and self.occ + pkt.size > self.drop_bytes:
            self.drops += 1
            sim.total_drops += 1
            return  # silent drop
        self.fifo.append((pkt, next_hop, now))
        self.occ += pkt.size
        if self.occ > self.max_occ:
            self.max_occ = self.occ
        if self.switch is not None:
            self.switch.on_enqueue(pkt, self, now)
        if not self.busy and not self.paused:
            self.busy = True
            sim.schedule(now + pkt.size / self._rate_at(now), "deq", self)

    def _rate_at(self, now):
        """Service rate honouring any active degrade window (fractional
        service credit — the oracle's analogue of the fabric's duty
        gating)."""
        r = self.rate
        for a, b, c in self.degrade:
            if a <= now < b:
                r = self.rate * c
        return r

    def service(self, now):
        """Dequeue-completion event: head packet finished serializing."""
        pkt, next_hop, enq_ts = self.fifo.pop(0)
        self.occ -= pkt.size
        if self.delay_log is not None:
            qdelay = now - enq_ts - pkt.size / self.rate
            if qdelay > self.sim.qdelay_log_threshold:
                self.delay_log.append((now, qdelay))
        # Egress ECN: mark by the RESIDUAL queue (the queue behind this pkt).
        if self.ecn_kmin is not None and pkt.kind == ref.DATA:
            q = self.occ
            if q >= self.ecn_kmax:
                pkt.ecn = True
            elif q > self.ecn_kmin:
                frac = (q - self.ecn_kmin) / max(self.ecn_kmax - self.ecn_kmin, 1e-9)
                if self.sim.rng.random() < frac:
                    pkt.ecn = True
        if self.switch is not None:
            self.switch.on_dequeue(pkt, self, now)
        # Chaos schedule: a down link blackholes everything it serves (the
        # packet really left the buffer — PFC accounting above already ran
        # — it just never arrives); corruption drops DATA only, drawn from
        # the same counter-based PRNG the fabric uses, keyed by
        # (seed, queue-row, serve tick, psn).
        lost = False
        if self.flap_wins and any(a <= now < b for a, b in self.flap_wins):
            self.sim.blackholed_pkts += 1
            lost = True
        elif self.cor_wins and pkt.kind == ref.DATA:
            p = max((p_ for a, b, p_ in self.cor_wins if a <= now < b),
                    default=0.0)
            if p > 0.0:
                tick = int(now / self.sim.net.mtu_serialize_us)
                u = fault_u01_py(self.sim.fault_seed, self.fault_row,
                                 tick, pkt.psn)
                if u < p:
                    self.sim.corrupt_drops += 1
                    lost = True
        if not lost:
            self.sim.schedule(now + self.prop, "hop", (pkt, next_hop))
        if self.fifo and not self.paused:
            self.sim.schedule(now + self.fifo[0][0].size / self._rate_at(now),
                              "deq", self)
        else:
            self.busy = False
            if self.drain_host is not None and not self.fifo:
                # NIC wire is free again: let the host clock out more packets
                self.sim.schedule_pump(now, self.drain_host)

    def pause(self, now):
        self.paused = True

    def resume(self, now):
        if self.paused:
            self.paused = False
            if self.fifo and not self.busy:
                self.busy = True
                self.sim.schedule(now + self.fifo[0][0].size
                                  / self._rate_at(now), "deq", self)


class Switch:
    """Shared-buffer switch with per-ingress-port PFC (RoCEv2 mode)."""

    __slots__ = ("name", "buffer_bytes", "total_occ", "ingress_occ",
                 "upstream", "pfc_enabled", "paused_ports", "pfc_alpha",
                 "pause_events", "sim")

    def __init__(self, sim, name, buffer_bytes, pfc_enabled):
        self.sim = sim
        self.name = name
        self.buffer_bytes = buffer_bytes
        self.total_occ = 0.0
        self.ingress_occ: dict = {}
        self.upstream: dict = {}    # port -> upstream Queue to pause
        self.pfc_enabled = pfc_enabled
        self.paused_ports: set = set()
        self.pfc_alpha = 1.0
        self.pause_events = 0

    def register_ingress(self, port, upstream_queue):
        self.ingress_occ[port] = 0.0
        self.upstream[port] = upstream_queue

    def _xoff(self) -> float:
        # dynamic threshold (DT): alpha * remaining shared buffer
        free = max(self.buffer_bytes - self.total_occ, 0.0)
        return self.pfc_alpha * free / (1.0 + self.pfc_alpha)

    def on_enqueue(self, pkt, queue, now):
        port = getattr(pkt, "_ingress", None)
        if port is None:
            return
        self.total_occ += pkt.size
        self.ingress_occ[port] = self.ingress_occ.get(port, 0.0) + pkt.size
        if not self.pfc_enabled:
            return
        if port not in self.paused_ports \
                and self.ingress_occ[port] > self._xoff():
            self.paused_ports.add(port)
            self.pause_events += 1
            self.sim.pause_log.append(now)
            up = self.upstream.get(port)
            if up is not None:
                self.sim.schedule(now + self.sim.prop_us, "pause", up)

    def on_dequeue(self, pkt, queue, now):
        port = getattr(pkt, "_ingress", None)
        if port is None:
            return
        self.total_occ -= pkt.size
        self.ingress_occ[port] -= pkt.size
        if self.pfc_enabled and port in self.paused_ports \
                and self.ingress_occ[port] < 0.5 * self._xoff():
            self.paused_ports.discard(port)
            up = self.upstream.get(port)
            if up is not None:
                self.sim.schedule(now + self.sim.prop_us, "resume", up)


class Flow:
    """One message between (src, dst). Owns sender+receiver engines."""

    __slots__ = ("id", "src", "dst", "msg_bytes", "sender", "receiver",
                 "start_ts", "timer_seq", "meta", "_parent", "_parts",
                 "_remaining", "_done_ts")

    def __init__(self, fid, src, dst, msg_bytes, start_ts, meta=None):
        self.id = fid
        self.src = src
        self.dst = dst
        self.msg_bytes = msg_bytes
        self.start_ts = start_ts
        self.sender = None
        self.receiver = None
        self.timer_seq = 0
        self.meta = meta

    @property
    def done_ts(self):
        if getattr(self, "_parts", None) is not None:
            return getattr(self, "_done_ts", None)
        return self.sender.done_ts

    @property
    def fct(self):
        dt = self.done_ts
        return dt - self.start_ts if dt is not None else None


class NetSim:
    """The discrete-event engine."""

    def __init__(self, topo: FatTree, net: NetworkSpec, *,
                 transport: str = "strack",
                 strack_params: Optional[STrackParams] = None,
                 roce_params: Optional[RoCEParams] = None,
                 oblivious_spray: bool = False,
                 switch_buffer_bytes: float = 64e6,
                 qdelay_log_threshold: float = 8.0,
                 log_queues: bool = False,
                 faults: Optional[FaultSpec] = None,
                 seed: int = 1234):
        import random
        self.rng = random.Random(seed)
        self.topo = topo
        self.net = net
        self.transport = transport
        self.oblivious = oblivious_spray
        self.sp = strack_params or make_strack_params(net)
        self.rp = roce_params or make_roce_params(net)
        self.now = 0.0
        self.evq: list = []
        self.seq = itertools.count()
        self.flows: dict[int, Flow] = {}
        self.host_flows: dict[int, list] = {h: [] for h in range(topo.n_hosts)}
        self.host_rr: dict[int, int] = {h: 0 for h in range(topo.n_hosts)}
        self.total_drops = 0
        self.pause_log: list = []
        self.pump_pending: dict[int, float] = {}   # host -> scheduled t
        self.qdelay_log_threshold = qdelay_log_threshold
        self.on_flow_done: Optional[Callable] = None
        self.throughput_probe: Optional[Callable] = None
        self.ack_log: Optional[list] = None   # (t, flow, ecn, rtt) if enabled
        self.rx_bytes_log: Optional[list] = None  # (t, flow, bytes) if enabled
        self._fid = itertools.count()

        rate = net.rate_Bpus
        # Per-link propagation from the shared NetworkSpec delay model
        # (derived so the uncongested cross-ToR RTT == net.base_rtt_us,
        # exactly as the jitted fabric's per-hop pipeline realizes it).
        self.prop_us = net.hop_prop_effective_us
        prop = self.prop_us
        lossless = transport == "roce"
        kmin = net.ecn_kmin_bytes
        kmax = net.ecn_kmax_bytes
        if lossless:
            kmin = kmax = self.rp.ecn_kmin_bdp * net.bdp_bytes
        drop = None if lossless else net.drop_bytes

        # Switches
        self.tors = [Switch(self, f"tor{t}", switch_buffer_bytes, lossless)
                     for t in range(topo.n_tor)]
        self.spines = [Switch(self, f"sp{s}", switch_buffer_bytes, lossless)
                       for s in range(topo.n_spine)]
        # Queues
        self.nic_q = [Queue(self, f"nic{h}", rate, prop,
                            drain_host=h)
                      for h in range(topo.n_hosts)]
        self.tor_up = [[Queue(self, f"t{t}->s{s}", rate, prop,
                              kmin, kmax, drop, switch=self.tors[t])
                        for s in range(topo.n_spine)]
                       for t in range(topo.n_tor)]
        self.spine_down = [[Queue(self, f"s{s}->t{t}", rate, prop,
                                  kmin, kmax, drop, switch=self.spines[s])
                            for t in range(topo.n_tor)]
                           for s in range(topo.n_spine)]
        self.host_down = [Queue(self, f"t->h{h}", rate, prop,
                                kmin, kmax, drop,
                                switch=self.tors[topo.tor_of(h)])
                          for h in range(topo.n_hosts)]
        if log_queues:
            for t in range(topo.n_tor):
                for s in range(topo.n_spine):
                    self.tor_up[t][s].delay_log = []
                    self.spine_down[s][t].delay_log = []
            for h in range(topo.n_hosts):
                self.host_down[h].delay_log = []
        # PFC ingress registration: ingress port -> upstream queue
        for t in range(topo.n_tor):
            for h in range(t * topo.hosts_per_tor,
                           (t + 1) * topo.hosts_per_tor):
                self.tors[t].register_ingress(("h", h), self.nic_q[h])
            for s in range(topo.n_spine):
                self.tors[t].register_ingress(("s", s),
                                              self.spine_down[s][t])
                self.spines[s].register_ingress(("t", t), self.tor_up[t][s])

        # Chaos schedule (sim/faults.py): attach per-queue fault windows.
        # Window ticks convert to us via mtu_serialize_us (one fabric tick
        # = one MTU serialization slot); queue-row ids mirror the fabric's
        # layout so corruption PRNG keying matches across backends.
        self.faults = faults
        self.fault_seed = faults.seed32 if faults is not None else 0
        self.blackholed_pkts = 0
        self.corrupt_drops = 0
        self._flap_up: dict[int, list] = {}   # tor -> [(spine, t0us, t1us)]
        self._nic_flap: dict[int, list] = {}  # host -> [(t0us, t1us)]
        T, S = topo.n_tor, topo.n_spine
        for t in range(T):
            for s in range(S):
                self.tor_up[t][s].fault_row = t * S + s
                self.spine_down[s][t].fault_row = T * S + s * T + t
        for h in range(topo.n_hosts):
            self.host_down[h].fault_row = 2 * T * S + h
        if faults is not None:
            validate_faults(faults, topo)
            tick = net.mtu_serialize_us
            for (t, s, a, b) in faults.link_flaps:
                win = (a * tick, b * tick)
                self.tor_up[t][s].flap_wins += (win,)
                self.spine_down[s][t].flap_wins += (win,)
                self._flap_up.setdefault(t, []).append((s, *win))
            for (t, s, a, b) in faults.uplink_flaps:
                # up direction only (time-varying dead_links semantics)
                win = (a * tick, b * tick)
                self.tor_up[t][s].flap_wins += (win,)
                self._flap_up.setdefault(t, []).append((s, *win))
            for (h, a, b) in faults.host_flaps:
                self.host_down[h].flap_wins += ((a * tick, b * tick),)
                self._nic_flap.setdefault(h, []).append((a * tick, b * tick))
            for (t, s, a, b, c) in faults.link_degrade:
                win = (a * tick, b * tick, c)
                self.tor_up[t][s].degrade += (win,)
                self.spine_down[s][t].degrade += (win,)
            for (t, s, a, b, p) in faults.link_corrupt:
                win = (a * tick, b * tick, p)
                self.tor_up[t][s].cor_wins += (win,)
                self.spine_down[s][t].cor_wins += (win,)
            for (h, a, b, p) in faults.host_corrupt:
                self.host_down[h].cor_wins += ((a * tick, b * tick, p),)

    # ------------------------------------------------------------------ #
    def schedule(self, t, kind, payload):
        heapq.heappush(self.evq, (t, next(self.seq), kind, payload))

    def schedule_pump(self, t, host):
        """Deduplicated pump scheduling: at most one pending pump per host
        at or before any requested time (prevents event storms when many
        paced flows share a NIC)."""
        pending = self.pump_pending.get(host)
        if pending is not None and pending <= t + 1e-9:
            return
        self.pump_pending[host] = t
        heapq.heappush(self.evq, (t, next(self.seq), "pump", host))

    def add_flow(self, src, dst, msg_bytes, start_ts=0.0, meta=None) -> Flow:
        # RoCEv2 with QPS_PER_CONN > 1 ("optimized RoCEv2", paper Figs
        # 21-28): the message is striped over N QPs, each a single-path
        # sub-flow with its own entropy; the message completes when the
        # last QP completes.
        if self.transport == "roce" and self.rp.qps_per_conn > 1:
            n = self.rp.qps_per_conn
            parent = Flow(next(self._fid), src, dst, msg_bytes, start_ts,
                          meta)
            parts = [self._add_single(src, dst, msg_bytes / n, start_ts)
                     for _ in range(n)]
            parent._parts = parts
            for sub in parts:
                sub._parent = parent
            parent._remaining = n
            self.flows[parent.id] = parent
            return parent
        return self._add_single(src, dst, msg_bytes, start_ts, meta)

    def _add_single(self, src, dst, msg_bytes, start_ts=0.0,
                    meta=None) -> Flow:
        fid = next(self._fid)
        fl = Flow(fid, src, dst, msg_bytes, start_ts, meta)
        sp, rp, net = self.sp, self.rp, self.net
        if self.transport == "strack":
            fl.sender = ref.STrackSender(sp, fid, msg_bytes, start_ts)
            if self.oblivious:
                fl.sender.spray = _ObliviousSpray(sp, start_ts)
            fl.receiver = ref.STrackReceiver(sp, fl.sender.total_pkts)
        else:
            entropy = self.rng.randrange(1 << 16)
            fl.sender = ref.RoCESender(
                rp.dcqcn, fid, msg_bytes, net.mtu_bytes, net.rate_Bpus,
                entropy, rp.rto_us, window_bdp_pkts=net.bdp_pkts,
                now=start_ts)
            fl.receiver = ref.RoCEReceiver(
                fl.sender.total_pkts, rp.ack_coalesce_pkts,
                rp.dcqcn.cnp_interval_us)
        self.flows[fid] = fl
        self.host_flows[src].append(fl)
        self.schedule_pump(start_ts, src)
        self._arm_timer(fl, start_ts)
        return fl

    # ------------------------------------------------------------------ #
    def _route(self, pkt, src, dst):
        """Hop list (queue, tag) a packet takes from src NIC to dst host."""
        topo = self.topo
        st, dt = topo.tor_of(src), topo.tor_of(dst)
        hops = []
        if st == dt:
            hops.append((self.host_down[dst], ("h", src)))
        else:
            s = self._pick_spine(src, dst, pkt.entropy)
            hops.append((self.tor_up[st][s], ("h", src)))
            hops.append((self.spine_down[s][dt], ("t", st)))
            hops.append((self.host_down[dst], ("s", s)))
        return hops

    def _pick_spine(self, src, dst, entropy):
        """ECMP over the uplinks live *now*: flapped uplinks leave the
        candidate set while their window is active (routing reconverges —
        the fabric's time-varying live mask does the same), and rejoin
        when the window closes."""
        topo = self.topo
        st = topo.tor_of(src)
        flaps = self._flap_up.get(st)
        if flaps:
            now = self.now
            down = {s for (s, a, b) in flaps if a <= now < b}
            if down:
                live = [s for s in topo.live_up[st] if s not in down]
                if live:
                    return live[_mix(src, dst, entropy) % len(live)]
        return topo.ecmp_spine(src, dst, entropy)

    def _launch(self, pkt, now):
        """Send pkt from its src host NIC through the fabric to pkt.dst."""
        if self._nic_flap and pkt.kind in (ref.DATA, ref.PROBE):
            # flapped host NIC: the sender committed its send state but
            # the packet never reaches the wire (RTO recovers it)
            wins = self._nic_flap.get(pkt.src)
            if wins and any(a <= now < b for a, b in wins):
                self.blackholed_pkts += 1
                return
        pkt._route = self._route(pkt, pkt.src, pkt.dst)
        pkt._hop = 0
        self.nic_q[pkt.src].enqueue(pkt, ("fabric", pkt), now)

    def _pump(self, host, now):
        """Pull-based NIC: clock out packets while the wire is free."""
        nic = self.nic_q[host]
        if nic.busy:
            return
        flows = self.host_flows[host]
        n = len(flows)
        if n == 0:
            return
        start = self.host_rr[host]
        for i in range(n):
            fl = flows[(start + i) % n]
            snd = fl.sender
            if snd.done():
                continue
            if fl.start_ts > now + 1e-9:
                # future-dated flow (an open-loop arrival): a shared
                # host's pump must not clock it out early; re-arm for
                # its start time (the dedup in schedule_pump may have
                # swallowed the pump add_flow armed)
                self.schedule_pump(fl.start_ts, host)
                continue
            if self.transport == "strack":
                if not snd.can_send():
                    continue
                pkt = snd.next_packet(now)
            else:
                if not snd.can_send(now):
                    # paced: re-pump at next_send_ts if that's the blocker
                    if (not snd.done()
                            and snd.psn_next < snd.total_pkts
                            and (snd.psn_next - snd.snd_una)
                            < snd.window_pkts
                            and snd.next_send_ts > now):
                        self.schedule_pump(snd.next_send_ts, host)
                    continue
                pkt = snd.next_packet(now)
            if pkt is None:
                continue
            pkt.src, pkt.dst = fl.src, fl.dst
            self.host_rr[host] = (start + i + 1) % n
            self._launch(pkt, now)
            return

    # ------------------------------------------------------------------ #
    def _arm_timer(self, fl, now):
        dl = fl.sender.next_timer_deadline()
        if dl != math.inf:
            fl.timer_seq += 1
            self.schedule(max(dl, now + 1e-3), "timer", (fl, fl.timer_seq))

    def _on_timer(self, fl, seq, now):
        if seq != fl.timer_seq or fl.sender.done():
            return
        if self.transport == "strack":
            probe = fl.sender.on_timer(now)
            if probe is not None:
                probe.src, probe.dst = fl.src, fl.dst
                self._launch(probe, now)
        else:
            fl.sender.on_timer(now)
        self.schedule_pump(now, fl.src)
        self._arm_timer(fl, now)

    def _deliver(self, pkt, now):
        """Packet reached an endpoint host."""
        fl = self.flows[pkt.flow]
        if pkt.kind in (ref.DATA, ref.PROBE):
            out = fl.receiver.on_data(pkt, now)
            if out is None:
                return
            outs = out if isinstance(out, list) else [out]
            for o in outs:
                o.src, o.dst = fl.dst, fl.src
                self._launch(o, now)
        else:  # SACK / NACK / CNP back at the sender
            was_done = fl.sender.done()
            if self.ack_log is not None and pkt.kind == ref.SACK:
                self.ack_log.append((now, pkt.flow, pkt.ecn, now - pkt.ts))
            if self.rx_bytes_log is not None and pkt.kind == ref.SACK:
                self.rx_bytes_log.append((now, pkt.flow, pkt.bytes_recvd))
            if self.transport == "strack":
                fl.sender.on_sack(pkt, now)
            else:
                fl.sender.on_ack(pkt, now)
            self._arm_timer(fl, now)
            self.schedule_pump(now, fl.src)
            if fl.sender.done() and not was_done:
                parent = getattr(fl, "_parent", None)
                if parent is not None:
                    parent._remaining -= 1
                    if parent._remaining == 0:
                        parent._done_ts = now
                        if self.on_flow_done:
                            self.on_flow_done(parent, now)
                elif self.on_flow_done:
                    self.on_flow_done(fl, now)

    # ------------------------------------------------------------------ #
    def run(self, until: float = math.inf, max_events: int = 200_000_000):
        evq = self.evq
        n = 0
        while evq and n < max_events:
            t, seq, kind, payload = heapq.heappop(evq)
            if t > until:
                # keep the event for a later run(until=...) call
                heapq.heappush(evq, (t, seq, kind, payload))
                self.now = until
                return
            self.now = t
            n += 1
            if kind == "deq":
                payload.service(t)
            elif kind == "hop":
                pkt, nh = payload
                if nh[0] == "fabric":
                    self._advance(pkt, t)
                else:
                    self._deliver(pkt, t)
            elif kind == "pump":
                if self.pump_pending.get(payload) is not None \
                        and self.pump_pending[payload] <= t + 1e-9:
                    self.pump_pending.pop(payload, None)
                self._pump(payload, t)
            elif kind == "timer":
                fl, seq = payload
                self._on_timer(fl, seq, t)
            elif kind == "pause":
                payload.pause(t)
            elif kind == "resume":
                payload.resume(t)

    def _advance(self, pkt, now):
        """Move pkt to its next fabric hop or deliver at host."""
        hops = pkt._route
        i = pkt._hop
        if i < len(hops):
            q, ingress = hops[i]
            pkt._hop = i + 1
            pkt._ingress = ingress
            q.enqueue(pkt, ("fabric", pkt) if i + 1 < len(hops)
                      else ("host", pkt.dst), now)
            # after the NIC, subsequent "hop" events carry ("fabric", pkt)
        else:
            self._deliver(pkt, now)

    # metrics helpers ---------------------------------------------------- #
    def all_queue_delay_logs(self):
        logs = []
        for t in range(self.topo.n_tor):
            for s in range(self.topo.n_spine):
                for q in (self.tor_up[t][s], self.spine_down[s][t]):
                    if q.delay_log:
                        logs.extend(q.delay_log)
        for h in range(self.topo.n_hosts):
            if self.host_down[h].delay_log:
                logs.extend(self.host_down[h].delay_log)
        return sorted(logs)

    def max_fct(self):
        return max(fl.fct for fl in self.flows.values()
                   if fl.fct is not None)


class _ObliviousSpray:
    """Oblivious packet spray baseline: pure round-robin over entropies."""

    __slots__ = ("p", "rr")

    def __init__(self, p, now=0.0):
        self.p = p
        self.rr = 0

    def update_ecn_bitmap(self, ecn, path_id):
        pass

    def choose_path(self, cwnd_pkts, now):
        self.rr = (self.rr + 1) % self.p.max_paths
        return self.rr
