"""The experiment front door of the port: Scenario + RunConfig + run() +
sweep().

The port of ``repro.sim.workloads``: the same :class:`Message` /
:class:`Scenario` records (messages with dependency edges, striped over
``RunConfig.subflows``) and builders, the collectives of
:func:`collective_scenario` among them, a :class:`RunConfig` with the
fields the port honours (the per-tick trace and the queue-settling time
among them), :func:`run`, which returns the reference's summary dict, and
:func:`sweep`, which runs same-structure scenarios and configs as one
batched program per program shape.  Both take ``device`` ("cuda" by
default; a fabric run raises without a GPU).

``RunConfig.backend`` picks the backend: ``"fabric"``, the tick-stepped
fat-tree of ``fabric.py`` on ``device``, or ``"events"``, the
discrete-event oracle of ``events.py``, a host model in plain Python that
ignores ``device``.  :class:`TraceRunner` is the oracle's dependency
scheduler and :func:`run_scenario_on_sim` runs a scenario on a prebuilt
``NetSim`` (queue logs, custom parameters).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.params import NetworkSpec, make_roce_params
from .events import NetSim
from .fabric import (ACK_PATHS, LB_MODES, PROTOCOLS, FabricConfig, _rto_us,
                     run_fabric_trace, run_fabric_trace_batch, summarize)
from .faults import FaultSpec
from .topology import (FatTree, full_bisection, oversubscribed,
                       with_link_failures)

BACKENDS = ("fabric", "events")


def permutation_pairs(n_hosts: int, seed: int = 0) -> list[tuple[int, int]]:
    """Random derangement: every host sends one flow and receives one."""
    rng = random.Random(seed)
    while True:
        perm = list(range(n_hosts))
        rng.shuffle(perm)
        if all(perm[i] != i for i in range(n_hosts)):
            return [(i, perm[i]) for i in range(n_hosts)]


@dataclass(frozen=True)
class Message:
    """One message of a workload trace: ``src``/``dst`` host ids,
    ``deps`` (mids that must complete first), ``group`` and the earliest
    launch tick ``arrival``."""

    mid: int
    src: int
    dst: int
    size: float
    deps: Tuple[int, ...] = ()
    group: int = 0
    arrival: int = 0

    def __post_init__(self):
        object.__setattr__(self, "deps", tuple(self.deps))


@dataclass(frozen=True)
class Scenario:
    """A workload: who sends what, after whom, where."""

    name: str
    topo: FatTree
    net: NetworkSpec
    messages: Tuple[Message, ...]
    faults: Optional[FaultSpec] = None

    @classmethod
    def from_flows(cls, name: str, topo: FatTree, net: NetworkSpec,
                   flows: Sequence[Tuple[int, int, float]]) -> "Scenario":
        return cls(name=name, topo=topo, net=net,
                   messages=tuple(Message(mid=i, src=s, dst=d, size=float(b))
                                  for i, (s, d, b) in enumerate(flows)))

    @property
    def flows(self) -> Tuple[Tuple[int, int, float], ...]:
        return tuple((m.src, m.dst, m.size) for m in self.messages)

    @property
    def has_deps(self) -> bool:
        return any(m.deps for m in self.messages)

    @property
    def n_groups(self) -> int:
        return len({m.group for m in self.messages})

    @property
    def is_trace(self) -> bool:
        """True when the scenario carries trace structure (dependency
        edges or several groups) and so reports the group keys on both
        backends (the oracle schedules it through :class:`TraceRunner`)."""
        return self.has_deps or self.n_groups > 1

    def default_ticks(self) -> int:
        """Tick budget: the larger of the worst per-destination
        serialisation and the dependency critical path, with convergence
        margin (the reference's formula)."""
        mtu = self.net.mtu_bytes
        rtt_ticks = self.net.base_rtt_us / self.net.mtu_serialize_us + 2
        pkts: dict[int, float] = {}
        per_dst: dict[int, float] = {}
        for m in self.messages:
            pkts[m.mid] = math.ceil(m.size / mtu)
            per_dst[m.dst] = per_dst.get(m.dst, 0.0) + pkts[m.mid]
        bottleneck = max(per_dst.values()) if per_dst else 1.0
        by_mid = {m.mid: m for m in self.messages}
        depth: dict[int, float] = {}
        visiting: set[int] = set()
        for root in by_mid:
            stack = [root]
            while stack:
                mid = stack[-1]
                if mid in depth:
                    stack.pop()
                    visiting.discard(mid)
                    continue
                visiting.add(mid)
                todo = [d for d in by_mid[mid].deps
                        if d in by_mid and d not in depth
                        and d not in visiting]
                if todo:
                    stack.extend(todo)
                    continue
                stack.pop()
                visiting.discard(mid)
                base = max((depth[d] for d in by_mid[mid].deps
                            if d in depth), default=0.0)
                base = max(base, float(by_mid[mid].arrival))
                depth[mid] = base + pkts[mid] + rtt_ticks
        crit = max(depth.values()) if depth else 1.0
        return int(4 * max(bottleneck, crit) + 30 * rtt_ticks + 1000)


def permutation_scenario(topo: FatTree, msg_bytes: float,
                         net: Optional[NetworkSpec] = None,
                         seed: int = 0) -> Scenario:
    net = net or NetworkSpec()
    pairs = permutation_pairs(topo.n_hosts, seed)
    return Scenario.from_flows(
        f"permutation_{topo.n_hosts}", topo, net,
        [(s, d, float(msg_bytes)) for s, d in pairs])


def oversub_scenario(n_tor: int, hosts_per_tor: int, ratio: int,
                     msg_bytes: float, net: Optional[NetworkSpec] = None,
                     seed: int = 0) -> Scenario:
    """Permutation over an oversubscribed fat-tree (``ratio``:1 at the
    ToR uplinks)."""
    topo = oversubscribed(n_tor, hosts_per_tor, ratio)
    sc = permutation_scenario(topo, msg_bytes, net, seed)
    return Scenario(name=f"oversub_{ratio}:1", topo=topo, net=sc.net,
                    messages=sc.messages)


def linkdown_scenario(topo_kw: dict, frac_links_down: float,
                      msg_bytes: float, net: Optional[NetworkSpec] = None,
                      seed: int = 0) -> Scenario:
    """Permutation over an asymmetric (dead-link) full-bisection fabric:
    ``frac_links_down`` of the ToR-spine links dead, spread over half the
    ToRs."""
    base = full_bisection(**topo_kw)
    n_links = base.n_tor * base.n_spine
    n_down = max(1, int(frac_links_down * n_links))
    topo = with_link_failures(base, n_down,
                              n_tors_affected=max(1, base.n_tor // 2),
                              seed=seed)
    sc = permutation_scenario(topo, msg_bytes, net, seed)
    return Scenario(name=f"linkdown_{n_down}", topo=topo, net=sc.net,
                    messages=sc.messages)


def incast_scenario(topo: FatTree, fan_in: int, msg_bytes: float,
                    dst: int = 0, net: Optional[NetworkSpec] = None,
                    seed: int = 0) -> Scenario:
    """fan_in sources -> one destination."""
    net = net or NetworkSpec()
    rng = random.Random(seed)
    candidates = [h for h in range(topo.n_hosts) if h != dst]
    srcs = rng.sample(candidates, min(fan_in, len(candidates)))
    return Scenario.from_flows(
        f"incast_{fan_in}to1", topo, net,
        [(s, dst, float(msg_bytes)) for s in srcs])


def trace_digest(messages) -> str:
    """A hash of a message list (records with ``mid/src/dst/size/deps/
    group/arrival``): each message's fields in order, so two generators
    that emit the same trace give the same digest."""
    import hashlib
    h = hashlib.sha256()
    for m in messages:
        h.update(repr((m.mid, m.src, m.dst, float(m.size), tuple(m.deps),
                       m.group, m.arrival)).encode())
    return h.hexdigest()


def collective_scenario(topo: FatTree, algo: str, n_jobs: int,
                        ranks_per_job: int, collective_bytes: float,
                        net: Optional[NetworkSpec] = None, seed: int = 0,
                        **algo_kw) -> Scenario:
    """Dependency-scheduled collective trace (Figs 1-2, 21-28) as a
    Scenario: ``n_jobs`` instances of ``algo`` (ring / dbt / hd / a2a from
    ``repro_torch.collective.algorithms``), each group randomly placed on
    the cluster (the reference's shuffle of ``seed``); rank ids are
    resolved to hosts here.  ``algo_kw`` reaches the generator
    (``chunk=``, ``window=`` for a2a)."""
    from ..collective.algorithms import multi_job  # cycle: algorithms <- us
    net = net or NetworkSpec()
    msgs, placement = multi_job(algo, n_jobs, ranks_per_job, topo.n_hosts,
                                collective_bytes, seed=seed, **algo_kw)
    return Scenario(
        name=f"{algo}_x{n_jobs}r{ranks_per_job}",
        topo=topo, net=net,
        messages=tuple(Message(mid=m.mid, src=placement[m.src],
                               dst=placement[m.dst], size=m.size,
                               deps=tuple(m.deps), group=m.group,
                               arrival=m.arrival)
                       for m in msgs))


@dataclass(frozen=True)
class RunConfig:
    """How a scenario runs: the reference's fields that the port honours,
    checked as the reference checks them when the config is made.
    ``shard > 1`` raises ``NotImplementedError`` naming its ROADMAP item
    when a fabric run starts.  ``seed`` (the oracle's rng) and ``until``
    (its horizon in us) are read by the events backend only.
    ``faults`` (a ``FaultSpec``) overrides the scenario's; without
    ``n_ticks`` the horizon then reaches past the schedule's last edge.
    ``trace_every = k`` samples a trace row every k ticks and
    ``trace_queues`` adds ``queue_settle_us`` to the summary (a trace row
    every tick unless ``trace_every`` says otherwise); either runs dense
    ticks."""

    backend: str = "fabric"
    protocol: str = "strack"         # strack | rocev2
    lb_mode: str = "adaptive"
    pfc: Optional[bool] = None       # None -> lossless iff rocev2
    max_paths: int = 64
    subflows: int = 1
    n_ticks: Optional[int] = None
    switch_buffer_bytes: Optional[float] = None  # None -> fabric default
    roce_entropy_seed: Optional[int] = None      # QP entropy draws
    ack_path: str = "perhop"
    hop_prop_us: Optional[float] = None
    # ticks a PFC pause/resume frame takes to reach the upstream queue
    # (None -> one hop of propagation)
    pfc_delay_ticks: Optional[int] = None
    time_warp: bool = True
    trace_every: int = 0
    trace_queues: bool = False       # per-tick queue-depth settling time
    qdelay_threshold_us: float = 8.0
    active_cap: Optional[int] = None
    shard: int = 0
    faults: Optional[FaultSpec] = None
    seed: int = 1234                 # events-backend rng seed
    until: float = 1e9               # events-backend horizon (us)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {self.protocol!r}; "
                             f"expected one of {PROTOCOLS}")
        if self.lb_mode not in LB_MODES:
            raise ValueError(f"unknown lb_mode {self.lb_mode!r}; "
                             f"expected one of {LB_MODES}")
        if self.ack_path not in ACK_PATHS:
            raise ValueError(f"unknown ack_path {self.ack_path!r}; "
                             f"expected one of {ACK_PATHS}")
        if self.trace_every < 0:
            raise ValueError(
                f"trace_every must be >= 0, got {self.trace_every}")
        if self.active_cap is not None and self.active_cap <= 0:
            raise ValueError(
                f"active_cap must be positive, got {self.active_cap}")
        if self.shard < 0:
            raise ValueError(f"shard must be >= 0, got {self.shard}")
        if (self.active_cap or self.shard > 1) and (
                self.trace_every or self.trace_queues):
            raise ValueError(
                "active_cap/shard need the no-trace path "
                "(trace_every=0, trace_queues=False)")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultSpec):
            raise TypeError(f"faults must be a FaultSpec, got "
                            f"{type(self.faults).__name__}")


def _effective_faults(sc: Scenario, cfg: RunConfig) -> Optional[FaultSpec]:
    """RunConfig.faults wins over Scenario.faults."""
    return cfg.faults if cfg.faults is not None else sc.faults


def _scenario_ticks(sc: Scenario, cfg: RunConfig) -> int:
    """Fabric horizon: explicit n_ticks, else ``default_ticks()`` extended
    by the fault schedule: past its last edge by four RTOs of loss
    recovery plus the clean drain budget."""
    if cfg.n_ticks is not None:
        return cfg.n_ticks
    ticks = sc.default_ticks()
    fs = _effective_faults(sc, cfg)
    if fs is not None and fs.last_edge > 0:
        rto_ticks = math.ceil(_rto_us(_fabric_cfg(sc, cfg))
                              / sc.net.mtu_serialize_us)
        ticks = max(ticks, fs.last_edge + 4 * rto_ticks + ticks)
    return ticks


def _fabric_cfg(sc: Scenario, cfg: RunConfig) -> FabricConfig:
    time_warp, trace_every = cfg.time_warp, cfg.trace_every
    if cfg.trace_queues:
        trace_every = trace_every or 1
    if trace_every:
        # a per-tick trace stacks one row a block: dense ticking
        time_warp = False
    kw = dict(
        net=sc.net, max_paths=cfg.max_paths, lb_mode=cfg.lb_mode,
        protocol=cfg.protocol, pfc=cfg.pfc, subflows=cfg.subflows,
        roce_entropy_seed=cfg.roce_entropy_seed, ack_path=cfg.ack_path,
        hop_prop_us=cfg.hop_prop_us, pfc_delay_ticks=cfg.pfc_delay_ticks,
        time_warp=time_warp, trace_every=trace_every,
        active_cap=cfg.active_cap, shard=cfg.shard,
        faults=_effective_faults(sc, cfg))
    if cfg.switch_buffer_bytes is not None:
        kw["switch_buffer_bytes"] = cfg.switch_buffer_bytes
    return FabricConfig(**kw)


def _queue_settle_us(metrics: dict, threshold_us: float) -> float:
    """Last simulated time any fabric queue's delay (depth x tick) exceeded
    ``threshold_us`` (the paper's Fig. 8 settling time).  With a decimated
    trace (``trace_every = k``) rows sample block ends, so the settling
    time is quantised to k ticks."""
    q = np.asarray(metrics["qsize"], dtype=float)      # [rows, Q]
    tick = metrics["tick_us"]
    k = max(1, metrics.get("trace_every", 1))
    over = np.nonzero((q * tick > threshold_us).any(axis=1))[0]
    return float((over[-1] + 1) * k * tick) if len(over) else 0.0


def _fabric_summary(sc: Scenario, cfg: RunConfig, metrics: dict) -> dict:
    """The reference's summary dict of one run: ``warp_trips`` and
    ``end_tick`` under time warp, ``queue_settle_us`` with
    ``trace_queues``."""
    out = summarize(metrics)
    out.update(backend="fabric", name=sc.name, protocol=cfg.protocol,
               lb_mode=cfg.lb_mode, subflows=cfg.subflows)
    if "warp_trips" in metrics:
        out["warp_trips"] = int(np.asarray(metrics["warp_trips"]))
        out["end_tick"] = int(np.asarray(metrics["end_tick"]))
    if cfg.trace_queues:
        out["queue_settle_us"] = _queue_settle_us(metrics,
                                                  cfg.qdelay_threshold_us)
    return out


def run(sc: Scenario, cfg: RunConfig = RunConfig(), device="cuda") -> dict:
    """Run one scenario under one config; the reference's summary dict
    (``pauses``, ``gbn_rewinds`` and ``rto_fires`` among its counters).
    Dispatches on ``cfg.backend``: the fabric runs on ``device``; the
    event oracle runs on the host (``device`` unused), through
    :class:`TraceRunner` when the scenario is a trace."""
    if cfg.backend != "fabric":
        return _run_events_backend(sc, cfg)
    fcfg = _fabric_cfg(sc, cfg)
    _, metrics = run_fabric_trace(sc.topo, sc.messages,
                                  _scenario_ticks(sc, cfg), fcfg,
                                  device=device)
    return _fabric_summary(sc, cfg, metrics)


def sweep(scenarios: Sequence[Scenario], cfg=RunConfig(),
          device="cuda") -> list:
    """Run a batch of same-structure scenarios under one config, or under
    a matching list of configs (a multi-axis sweep), on ``device``.

    ``cfg`` is a :class:`RunConfig` or a sequence of them.  Lengths must
    match, or either side may be of length 1 and is broadcast: so
    ``sweep([sc], [cfg_a, cfg_b])`` sweeps config axes over one scenario
    and ``sweep(seeds, cfg)`` sweeps seeds under one config.  Everything
    that is data to the fabric program runs as one batched program
    (``fabric.run_fabric_trace_batch``) per program shape: message
    src/dst/sizes, ``lb_mode`` and ``roce_entropy_seed``; axes that change
    the program (protocol, pfc, ``subflows``, ``n_ticks``, buffer sizes,
    ``time_warp``, the trace) split the sweep into one batch per group.
    The fabric entries must share a topology, a network and a message /
    dependency structure; events entries loop :func:`run`.  Returns one summary dict per (scenario,
    config) pair, in input order; each equals :func:`run`'s."""
    if not scenarios:
        raise ValueError("sweep() needs at least one scenario")
    scenarios = list(scenarios)
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg]
    if not cfgs:
        raise ValueError("sweep() needs at least one config")
    if len(scenarios) == 1 and len(cfgs) > 1:
        scenarios = scenarios * len(cfgs)
    if len(cfgs) == 1 and len(scenarios) > 1:
        cfgs = cfgs * len(scenarios)
    if len(cfgs) != len(scenarios):
        raise ValueError(
            f"sweep() got {len(scenarios)} scenarios and {len(cfgs)} "
            f"configs; lengths must match, or either side must be 1")
    fabric_ix = [i for i, rc in enumerate(cfgs) if rc.backend == "fabric"]
    sc0 = scenarios[fabric_ix[0]] if fabric_ix else None
    for i in fabric_ix[1:]:
        sc = scenarios[i]
        if sc.topo != sc0.topo:
            raise ValueError(
                f"sweep() scenarios must share a topology: field 'topo' of "
                f"{sc.name!r} is {sc.topo}, of {sc0.name!r} is {sc0.topo}")
        if sc.net != sc0.net:
            raise ValueError(
                f"sweep() scenarios must share a network: field 'net' of "
                f"{sc.name!r} is {sc.net}, of {sc0.name!r} is {sc0.net}")
        if len(sc.messages) != len(sc0.messages):
            raise ValueError(
                f"sweep() scenarios must share the message structure: "
                f"field 'messages' of {sc.name!r} has {len(sc.messages)} "
                f"entries, of {sc0.name!r} has {len(sc0.messages)}")
        structure = [(m.deps, m.group) for m in sc.messages]
        structure0 = [(m.deps, m.group) for m in sc0.messages]
        if structure != structure0:
            bad = next(i for i, (a, b) in
                       enumerate(zip(structure, structure0)) if a != b)
            raise ValueError(
                f"sweep() scenarios must share the dependency structure: "
                f"field 'messages[{bad}].deps/group' of {sc.name!r} is "
                f"{structure[bad]}, of {sc0.name!r} is {structure0[bad]}")
    out: list = [None] * len(cfgs)
    # group the pairs by everything static to the program; lb_mode and the
    # entropy seed are data within a group
    groups: dict = {}
    for i, (sc, rc) in enumerate(zip(scenarios, cfgs)):
        if rc.backend != "fabric":
            out[i] = run(sc, rc, device)
            continue
        fcfg = _fabric_cfg(sc, rc)
        key = (replace(fcfg, lb_mode="adaptive", roce_entropy_seed=None),
               rc.n_ticks, rc.trace_queues)
        groups.setdefault(key, []).append(i)
    for idxs in groups.values():
        rc0 = cfgs[idxs[0]]
        fcfg0 = _fabric_cfg(scenarios[idxs[0]], rc0)
        ticks = rc0.n_ticks or max(_scenario_ticks(scenarios[i], cfgs[i])
                                   for i in idxs)
        _, per_entry = run_fabric_trace_batch(
            scenarios[idxs[0]].topo,
            [scenarios[i].messages for i in idxs], ticks, fcfg0,
            lb_modes=[cfgs[i].lb_mode for i in idxs],
            entropy_seeds=[cfgs[i].roce_entropy_seed for i in idxs],
            device=device)
        for i, metrics in zip(idxs, per_entry):
            out[i] = _fabric_summary(scenarios[i], cfgs[i], metrics)
    return out


# --------------------------------------------------------------------------- #
# The event oracle (events.py): NetSim wiring, TraceRunner
# --------------------------------------------------------------------------- #

def _events_sim(sc: Scenario, cfg: RunConfig, **netsim_kw) -> NetSim:
    if cfg.hop_prop_us is not None:
        # the oracle reads its per-link propagation from the NetworkSpec;
        # a RunConfig override rides in on a replaced spec
        sc = replace(sc, net=replace(sc.net, hop_prop_us=cfg.hop_prop_us))
    kw = dict(seed=cfg.seed)
    if cfg.switch_buffer_bytes is not None:
        kw["switch_buffer_bytes"] = cfg.switch_buffer_bytes
    fs = _effective_faults(sc, cfg)
    if fs is not None:
        kw["faults"] = fs
    kw.update(netsim_kw)
    if cfg.protocol == "strack":
        if cfg.lb_mode == "fixed":
            raise ValueError("lb_mode='fixed' (single-path pinning) only "
                             "exists on the fabric backend")
        # a caller-provided kwarg wins over lb_mode
        obl = kw.pop("oblivious_spray", cfg.lb_mode == "oblivious")
        return NetSim(sc.topo, sc.net, transport="strack",
                      oblivious_spray=obl, **kw)
    rp = kw.pop("roce_params",
                make_roce_params(sc.net, qps_per_conn=cfg.subflows))
    return NetSim(sc.topo, sc.net, transport="roce", roce_params=rp, **kw)


def _run_events_backend(sc: Scenario, cfg: RunConfig) -> dict:
    return run_scenario_on_sim(_events_sim(sc, cfg), sc, until=cfg.until)


def _summarize_sim(sim: NetSim) -> dict:
    """The oracle's summary, keyed as the fabric's ``summarize``; the
    per-protocol recovery counters live inside the engines and read 0."""
    fcts = [fl.fct for fl in sim.flows.values() if fl.fct is not None]
    return {
        "max_fct": max(fcts) if fcts else float("nan"),
        "avg_fct": sum(fcts) / len(fcts) if fcts else float("nan"),
        "unfinished": sum(1 for fl in sim.flows.values() if fl.fct is None),
        "drops": sim.total_drops,
        "pauses": len(sim.pause_log),
        "retransmits": 0,
        "rto_fires": 0,
        "sack_recoveries": 0,
        "gbn_rewinds": 0,
        "blackholed_pkts": getattr(sim, "blackholed_pkts", 0),
        "corrupt_drops": getattr(sim, "corrupt_drops", 0),
    }


class TraceRunner:
    """Replays dependency traces on a NetSim: a message launches when all
    its dependencies have completed (paper Section 4.3 trace semantics).

    ``placement`` maps message src/dst ids to hosts (identity when the
    messages already carry host ids, as ``Scenario.messages`` do)."""

    def __init__(self, sim: NetSim, messages: list,
                 placement: dict[int, int]):
        self.sim = sim
        self.msgs = {m.mid: m for m in messages}
        self.placement = placement  # rank -> host
        self.children: dict[int, list[int]] = {m.mid: [] for m in messages}
        self.pending_deps = {m.mid: len(m.deps) for m in messages}
        for m in messages:
            for d in m.deps:
                self.children[d].append(m.mid)
        self.flow_to_msg: dict[int, int] = {}
        self.done: set[int] = set()
        self.group_done_ts: dict[int, float] = {}
        self.group_msgs: dict[int, int] = {}
        for m in messages:
            self.group_msgs[m.group] = self.group_msgs.get(m.group, 0) + 1
        sim.on_flow_done = self._on_flow_done

    def _launch(self, m: Message, now: float):
        # honour the open-loop arrival tick: one fabric tick = one MTU
        # serialisation slot, so arrival converts via mtu_serialize_us
        start = max(now, m.arrival * self.sim.net.mtu_serialize_us)
        fl = self.sim.add_flow(self.placement[m.src], self.placement[m.dst],
                               m.size, start_ts=start, meta=m.mid)
        self.flow_to_msg[fl.id] = m.mid

    def _on_flow_done(self, fl, now: float):
        mid = self.flow_to_msg.get(fl.id)
        if mid is None:
            return
        m = self.msgs[mid]
        self.done.add(mid)
        self.group_msgs[m.group] -= 1
        if self.group_msgs[m.group] == 0:
            self.group_done_ts[m.group] = now
        for c in self.children[mid]:
            self.pending_deps[c] -= 1
            if self.pending_deps[c] == 0:
                self._launch(self.msgs[c], now)

    def run(self, until: float = 1e9) -> dict:
        for m in self.msgs.values():
            if self.pending_deps[m.mid] == 0:
                self._launch(m, 0.0)
        self.sim.run(until=until)
        finished = len(self.group_done_ts)
        msg_fct = {mid: fl.fct for fl in self.sim.flows.values()
                   if (mid := self.flow_to_msg.get(fl.id)) is not None
                   and fl.fct is not None}
        return {
            "group_fct": dict(self.group_done_ts),
            "max_collective_time": (max(self.group_done_ts.values())
                                    if self.group_done_ts else float("nan")),
            "finished_groups": finished,
            "total_groups": len(self.group_msgs) if self.group_msgs else 0,
            "drops": self.sim.total_drops,
            "pauses": len(self.sim.pause_log),
            "msg_fct": msg_fct,
        }


def run_scenario_on_sim(sim: NetSim, sc: Scenario,
                        until: float = 1e9) -> dict:
    """Run a scenario on a prebuilt NetSim (custom params / queue
    logging), honouring dependency edges via :class:`TraceRunner`."""
    if sc.is_trace:
        placement = {h: h for m in sc.messages for h in (m.src, m.dst)}
        res = TraceRunner(sim, list(sc.messages), placement).run(until=until)
        out = {**_summarize_sim(sim), **res}
    else:
        for m in sc.messages:
            sim.add_flow(m.src, m.dst, m.size,
                         start_ts=m.arrival * sim.net.mtu_serialize_us)
        sim.run(until=until)
        out = _summarize_sim(sim)
    out["backend"] = "events"
    out["name"] = sc.name
    return out
