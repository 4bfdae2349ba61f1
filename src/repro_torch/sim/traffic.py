"""The multi-tenant traffic generator: open-loop inference load as a
message trace.

The port of the generator part of ``repro.sim.traffic``: the same
counter-based splitmix64 stream, the same tenant records and the same
:func:`mixed_scenario`, emitting the port's :class:`~.workloads.Message`
and :class:`~.workloads.Scenario` message for message as the reference
does.  It is pure Python with integer draws.

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
each step's message waiting for its counterpart of the step before.  The
soak runner stays with ROADMAP A10.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.params import NetworkSpec
from .topology import FatTree
from .workloads import Message, Scenario

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
