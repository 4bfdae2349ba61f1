"""The multi-tenant traffic generator and the soak driver (the
observatory's feed).

The port of ``repro.sim.traffic``: the same counter-based splitmix64
stream, the same tenant records and the same :func:`mixed_scenario`,
emitting the port's :class:`~.workloads.Message` and
:class:`~.workloads.Scenario` message for message as the reference does
(pure Python with integer draws), and the same :func:`soak`.

An :class:`InferenceTenant` sends ``n_flows`` small messages with
Poisson-process (exponential) interarrival ticks into a few frontend
hosts: bursty inference load on a fabric shared with training.  Every
message is one flow with an open-loop ``arrival`` tick and no dependency
edges, so at any tick only the messages that have arrived and not yet
finished are live: the traffic the active set (``RunConfig.active_cap``)
is for.  Each tenant is one ``group``; ``summarize`` reports FCT
percentiles per tenant (``tenant_fct``).

A :class:`TrainingJob` is a training tenant: ``steps`` chained
collectives of ``repro_torch.collective.algorithms`` on a fixed placement,
each step's message waiting for its counterpart of the step before.

:func:`soak` chains epochs of the mix on the fabric, clean or under a
chaos schedule, with counters carried across epochs and folded into a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (Prometheus text for
``repro_torch.obs.exporter``).  Every epoch has the same trace structure
and horizon, so ONE :class:`~.fabric.FabricProgram` serves the soak: each
epoch re-binds its messages and fault values to it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .. import resolve_device
from ..core.params import NetworkSpec
from .faults import FaultSpec
from .topology import FatTree
from .workloads import Message, RunConfig, Scenario, _fabric_cfg, \
    _fabric_summary

# --------------------------------------------------------------------------- #
# Counter-based PRNG: splitmix64 over a (seed, *counters) key
# --------------------------------------------------------------------------- #

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(x: int) -> int:
    """One splitmix64 output step (Steele et al.): u64 -> u64."""
    x = (x + _GOLDEN) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def _u64(seed: int, *counters: int) -> int:
    """Stateless draw: hash the (seed, counters...) key path."""
    state = splitmix64(seed & _MASK64)
    for c in counters:
        state = splitmix64(state ^ ((c & _MASK64) * _GOLDEN & _MASK64))
    return state


def _u01(seed: int, *counters: int) -> float:
    """Uniform in [0, 1) with 53 usable bits."""
    return (_u64(seed, *counters) >> 11) / float(1 << 53)


def _shuffled(n: int, seed: int, *counters: int) -> List[int]:
    """Deterministic Fisher-Yates permutation of range(n)."""
    out = list(range(n))
    for i in range(n - 1, 0, -1):
        j = _u64(seed, *counters, i) % (i + 1)
        out[i], out[j] = out[j], out[i]
    return out


# --------------------------------------------------------------------------- #
# Tenant specs
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class TrainingJob:
    """One training tenant: ``steps`` chained collectives on a fixed
    placement.  ``algo_kw`` is a tuple of (key, value) pairs passed to the
    collective generator (e.g. ``(("chunk", 32768),)``).  ``hosts`` pins
    the placement; None carves a disjoint slice of the seed-shuffled host
    list."""

    name: str
    algo: str = "ring"
    ranks: int = 8
    collective_bytes: float = 256 * 2 ** 10
    steps: int = 1
    start_tick: int = 0
    algo_kw: Tuple[Tuple[str, object], ...] = ()
    hosts: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class InferenceTenant:
    """Open-loop bursty tenant: ``n_flows`` messages per epoch with
    exponential (Poisson-process) interarrival ticks into ``n_targets``
    frontend hosts.  ``size_jitter`` scales each message's size by a
    uniform factor in [1-j, 1+j]."""

    name: str
    n_flows: int = 64
    mean_interarrival_ticks: float = 8.0
    size_bytes: float = 16 * 2 ** 10
    size_jitter: float = 0.0
    n_targets: int = 1
    targets: Optional[Tuple[int, ...]] = None
    start_tick: int = 0


# --------------------------------------------------------------------------- #
# The generator
# --------------------------------------------------------------------------- #

def _job_messages(job: TrainingJob, tenant_idx: int, job_hosts: Sequence[int],
                  n_hosts: int, mid_base: int) -> List[Message]:
    from ..collective.algorithms import multi_job  # cycle: algorithms <- sim
    msgs, placement = multi_job(job.algo, 1, job.ranks, n_hosts,
                                job.collective_bytes, hosts=list(job_hosts),
                                **dict(job.algo_kw))
    per_step = len(msgs)
    out: List[Message] = []
    for s in range(job.steps):
        base = mid_base + s * per_step
        prev = mid_base + (s - 1) * per_step
        for m in msgs:
            deps = tuple(d + base for d in m.deps)
            if s > 0:
                # chain the steps: each message also waits for its
                # same-index message of the previous step
                deps = deps + (prev + m.mid,)
            out.append(Message(
                mid=base + m.mid, src=placement[m.src],
                dst=placement[m.dst], size=m.size, deps=deps,
                group=tenant_idx, arrival=job.start_tick))
    return out


def _burst_messages(ten: InferenceTenant, tenant_idx: int,
                    targets: Sequence[int], n_hosts: int, mid_base: int,
                    seed: int, epoch: int) -> List[Message]:
    out: List[Message] = []
    t = float(ten.start_tick)
    for k in range(ten.n_flows):
        u = _u01(seed, tenant_idx, epoch, k, 0)
        # inverse-CDF exponential, clamped to >= 1 tick so arrivals
        # strictly advance
        t += max(1.0, round(-ten.mean_interarrival_ticks
                            * math.log(1.0 - u)))
        dst = targets[_u64(seed, tenant_idx, epoch, k, 1) % len(targets)]
        src = _u64(seed, tenant_idx, epoch, k, 2) % n_hosts
        if src == dst:
            src = (src + 1) % n_hosts
        size = ten.size_bytes
        if ten.size_jitter:
            j = ten.size_jitter * (2.0 * _u01(seed, tenant_idx, epoch,
                                              k, 3) - 1.0)
            size = max(1.0, size * (1.0 + j))
        out.append(Message(mid=mid_base + k, src=src, dst=dst,
                           size=float(size), group=tenant_idx,
                           arrival=int(t)))
    return out


def mixed_scenario(topo: FatTree, jobs: Sequence[TrainingJob],
                   tenants: Sequence[InferenceTenant],
                   net: Optional[NetworkSpec] = None, seed: int = 0,
                   epoch: int = 0) -> Tuple[Scenario, Dict[int, str]]:
    """One epoch of the multi-tenant mix as a Scenario.

    Returns ``(scenario, tenant_of_group)`` where group ``g`` in the
    scenario (and in ``summarize()['tenant_fct']``) belongs to tenant
    ``tenant_of_group[g]``.  Placements and targets depend only on
    ``seed``; burst arrivals, sources and sizes on ``(seed, epoch)``; the
    trace's structure (message count, deps, groups) on neither."""
    net = net or NetworkSpec()
    names = [j.name for j in jobs] + [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    # seed-keyed placement pool; jobs take disjoint slices off the front,
    # burst targets come off the back
    pool = _shuffled(topo.n_hosts, seed, 0)
    cursor = 0
    messages: List[Message] = []
    tenant_of_group: Dict[int, str] = {}
    for g, job in enumerate(jobs):
        if job.hosts is not None:
            job_hosts = list(job.hosts)
        else:
            if cursor + job.ranks > topo.n_hosts:
                raise ValueError(f"job {job.name!r}: not enough hosts "
                                 f"({cursor + job.ranks} needed, "
                                 f"{topo.n_hosts} available)")
            job_hosts = pool[cursor:cursor + job.ranks]
            cursor += job.ranks
        messages += _job_messages(job, g, job_hosts, topo.n_hosts,
                                  len(messages))
        tenant_of_group[g] = job.name
    back = topo.n_hosts
    for i, ten in enumerate(tenants):
        g = len(jobs) + i
        if ten.targets is not None:
            targets = list(ten.targets)
        else:
            n_t = max(1, min(ten.n_targets, topo.n_hosts))
            targets = pool[max(cursor, back - n_t):back]
            targets = targets or pool[-n_t:]
            back = max(cursor, back - n_t)
        messages += _burst_messages(ten, g, targets, topo.n_hosts,
                                    len(messages), seed, epoch)
        tenant_of_group[g] = ten.name
    sc = Scenario(name=f"mixed_s{seed}e{epoch}", topo=topo, net=net,
                  messages=tuple(messages))
    return sc, tenant_of_group


# --------------------------------------------------------------------------- #
# The soak driver: chained epochs on one program, carried counters
# --------------------------------------------------------------------------- #

_COUNTERS = ("drops", "pauses", "ecn_marks", "retransmits", "rto_fires",
             "sack_recoveries", "gbn_rewinds", "blackholed_pkts",
             "corrupt_drops")


def inert_faults_like(fs: FaultSpec) -> FaultSpec:
    """A FaultSpec with every window collapsed to [0, 0): the same
    ``shape_key`` (so the same program serves it), no effect.  Chaos
    soaks run their clean epochs on it."""
    return FaultSpec(
        link_flaps=tuple((t, s, 0, 0) for (t, s, _a, _b) in fs.link_flaps),
        uplink_flaps=tuple((t, s, 0, 0)
                           for (t, s, _a, _b) in fs.uplink_flaps),
        host_flaps=tuple((h, 0, 0) for (h, _a, _b) in fs.host_flaps),
        link_degrade=tuple((t, s, 0, 0, c)
                           for (t, s, _a, _b, c) in fs.link_degrade),
        link_corrupt=tuple((t, s, 0, 0, p)
                           for (t, s, _a, _b, p) in fs.link_corrupt),
        host_corrupt=tuple((h, 0, 0, p)
                           for (h, _a, _b, p) in fs.host_corrupt),
        seed=fs.seed)


def record_epoch(reg, res: dict, tenant_of_group: Dict[int, str]) -> None:
    """Fold one epoch's summary into a MetricsRegistry (strack_* names;
    catalogue in docs/observatory.md)."""
    reg.declare("strack_epochs_total", "soak epochs completed", "counter")
    reg.inc("strack_epochs_total")
    for key in _COUNTERS:
        reg.declare(f"strack_{key}_total",
                    f"fabric {key.replace('_', ' ')} across epochs",
                    "counter")
        reg.inc(f"strack_{key}_total", float(res.get(key, 0)))
    reg.declare("strack_unfinished", "messages unfinished in the last "
                "epoch (0 = every epoch drained)", "gauge")
    reg.set("strack_unfinished", float(res.get("unfinished", 0)))
    reg.declare("strack_qdepth_max_pkts",
                "deepest switch queue of the last epoch (packets)",
                "gauge")
    reg.declare("strack_qdepth_p99_pkts",
                "p99 over queues of per-queue max depth, last epoch",
                "gauge")
    reg.set("strack_qdepth_max_pkts", float(res.get("qdepth_max_pkts", 0)))
    reg.set("strack_qdepth_p99_pkts", float(res.get("qdepth_p99_pkts", 0)))
    reg.declare("strack_fct_us", "per-tenant FCT percentiles of the last "
                "epoch (us)", "gauge")
    reg.declare("strack_messages_total", "messages finished per tenant",
                "counter")
    for g, row in (res.get("tenant_fct") or {}).items():
        tenant = tenant_of_group.get(g, str(g))
        for q in ("p50", "p99", "avg", "max"):
            v = row.get(q, float("nan"))
            reg.set("strack_fct_us", v, tenant=tenant, quantile=q)
        reg.inc("strack_messages_total",
                float(row["count"] - row["unfinished"]), tenant=tenant)


def soak(topo: FatTree, jobs: Sequence[TrainingJob],
         tenants: Sequence[InferenceTenant], epochs: int = 10,
         net: Optional[NetworkSpec] = None, seed: int = 0,
         cfg: Optional[RunConfig] = None, n_ticks: Optional[int] = None,
         registry=None, out_path: Optional[str] = None,
         chaos=None, verbose: bool = False, device="cuda") -> dict:
    """Long-horizon mixed-workload soak on ``device``: ``epochs`` chained
    fabric runs, counters carried across epochs.

    Every epoch re-samples the open-loop burst arrivals (epoch-keyed
    PRNG streams) but keeps the trace structure and tick horizon fixed,
    so ONE fabric program serves the whole soak (the returned
    ``program_builds``): each epoch re-binds its messages to it
    (:func:`~.fabric.trace_program` with ``prog``), and equals a fresh
    :func:`~.workloads.run` of that epoch.  ``registry`` (a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`) accumulates
    Prometheus metrics per epoch; ``out_path`` additionally dumps the
    rendered exposition after every epoch (so an exporter serving the
    file shows the soak live).

    ``chaos`` turns on chaos epochs: a single :class:`FaultSpec` (every
    epoch faulted) or a per-epoch sequence where ``None`` entries mean a
    clean epoch.  Fault *values* are program data, so every entry must
    share one ``shape_key``: clean epochs run the same program through an
    inert schedule (:func:`inert_faults_like`).  Per-tenant p99 FCT from
    chaos epochs is ratioed against clean epochs into the
    ``strack_fct_degradation_ratio`` gauge (and the returned
    ``per_tenant[...]["degradation_p99"]``)."""
    from . import fabric
    net = net or NetworkSpec()
    cfg = cfg or RunConfig()
    if cfg.backend != "fabric":
        raise ValueError("soak() drives the warp fabric; use run() "
                         "directly for one-shot oracle runs")
    epochs = int(epochs)
    if epochs < 1:
        raise ValueError("epochs must be >= 1")
    dev = resolve_device(device)
    # normalize the chaos schedule to one FaultSpec per epoch (None when
    # chaos is off entirely); clean epochs get an inert same-shape spec
    chaos_flags = [False] * epochs
    epoch_faults: List[Optional[FaultSpec]] = [None] * epochs
    if chaos is not None:
        specs = ([chaos] * epochs if isinstance(chaos, FaultSpec)
                 else list(chaos))
        if len(specs) != epochs:
            raise ValueError(f"chaos schedule has {len(specs)} entries "
                             f"for {epochs} epochs")
        proto = next((fs for fs in specs if fs is not None), None)
        if proto is None:
            raise ValueError("chaos schedule is all-None; pass chaos=None "
                             "for a clean soak")
        inert = inert_faults_like(proto)
        for e, fs in enumerate(specs):
            if fs is None:
                epoch_faults[e] = inert
            else:
                if fs.shape_key != proto.shape_key:
                    raise ValueError(
                        f"chaos epoch {e} has shape_key {fs.shape_key}, "
                        f"expected {proto.shape_key}: every epoch must "
                        f"share one fault shape so ONE program serves "
                        f"the soak")
                epoch_faults[e] = fs
                chaos_flags[e] = fs.last_edge > 0
    scs = [mixed_scenario(topo, jobs, tenants, net=net, seed=seed, epoch=e)
           for e in range(epochs)]
    if n_ticks is None:
        # one fixed horizon covering every epoch's arrivals and critical
        # path; chaos epochs extend it past the last fault edge so
        # recovery completes inside the same horizon
        n_ticks = max(sc.default_ticks() for sc, _ in scs)
        last = max((fs.last_edge for fs in epoch_faults
                    if fs is not None), default=0)
        if last > 0:
            n_ticks = max(n_ticks, last + max(
                sc.default_ticks() for sc, _ in scs))
    cfg = replace(cfg, n_ticks=int(n_ticks))
    totals = {k: 0 for k in _COUNTERS}
    totals["unfinished"] = 0
    totals["messages"] = 0
    per_tenant: Dict[str, dict] = {}
    epoch_rows: List[dict] = []
    clean_p99: Dict[str, float] = {}
    chaos_p99: Dict[str, float] = {}
    builds0 = fabric.program_builds
    tenant_of_group: Dict[int, str] = {}
    prog = None
    for e, (sc, tenant_of_group) in enumerate(scs):
        ecfg = (replace(cfg, faults=epoch_faults[e])
                if epoch_faults[e] is not None else cfg)
        prog = fabric.trace_program(topo, sc.messages, int(n_ticks),
                                    _fabric_cfg(sc, ecfg), dev, prog)
        _, metrics = fabric.run_program(prog)
        res = _fabric_summary(sc, ecfg, metrics)
        for k in _COUNTERS:
            totals[k] += int(res.get(k, 0))
        totals["unfinished"] += int(res["unfinished"])
        totals["messages"] += len(sc.messages)
        row = {"epoch": e, "max_fct_us": res["max_fct"],
               "unfinished": res["unfinished"], "chaos": chaos_flags[e],
               **{k: int(res.get(k, 0)) for k in _COUNTERS},
               "qdepth_max_pkts": res.get("qdepth_max_pkts", 0)}
        epoch_rows.append(row)
        for g, trow in (res.get("tenant_fct") or {}).items():
            name = tenant_of_group.get(g, str(g))
            agg = per_tenant.setdefault(
                name, {"count": 0, "unfinished": 0, "p99_worst": 0.0,
                       "max": 0.0, "p50_last": float("nan")})
            agg["count"] += trow["count"]
            agg["unfinished"] += trow["unfinished"]
            if trow["p99"] == trow["p99"]:          # not NaN
                agg["p99_worst"] = max(agg["p99_worst"], trow["p99"])
                agg["max"] = max(agg["max"], trow["max"])
                agg["p50_last"] = trow["p50"]
                bucket = chaos_p99 if chaos_flags[e] else clean_p99
                bucket[name] = max(bucket.get(name, 0.0), trow["p99"])
        if registry is not None:
            record_epoch(registry, res, tenant_of_group)
            if chaos is not None:
                registry.declare(
                    "strack_fct_degradation_ratio",
                    "per-tenant worst-p99 FCT, chaos epochs over clean "
                    "epochs (1.0 = no degradation)", "gauge")
                for name in sorted(set(chaos_p99) & set(clean_p99)):
                    base = clean_p99[name]
                    if base > 0:
                        registry.set("strack_fct_degradation_ratio",
                                     chaos_p99[name] / base, tenant=name)
            if out_path:
                from ..obs.metrics import render_prometheus
                with open(out_path, "w") as f:
                    f.write(render_prometheus(registry))
        if verbose:
            print(f"soak[{e + 1}/{epochs}]: max_fct {res['max_fct']:.1f}us"
                  f", drops {row['drops']}, pauses {row['pauses']}, ecn "
                  f"{row['ecn_marks']}, retx {row['retransmits']}, "
                  f"unfinished {res['unfinished']}")
    if chaos is not None:
        for name, agg in per_tenant.items():
            base = clean_p99.get(name, 0.0)
            ch = chaos_p99.get(name, 0.0)
            agg["degradation_p99"] = (ch / base if base > 0 and ch > 0
                                      else float("nan"))
    return {
        "epochs": epochs,
        "n_ticks": int(n_ticks),
        "totals": totals,
        "per_tenant": per_tenant,
        "tenant_of_group": tenant_of_group,
        "epoch_rows": epoch_rows,
        "program_builds": fabric.program_builds - builds0,
    }
