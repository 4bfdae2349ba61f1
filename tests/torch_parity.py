"""Shared helpers for the port's parity tests (JAX reference vs repro_torch).

Run as a script to regenerate the committed reference files (perm1024 and
incast1024 under STrack; perm1024 and incast1024 under RoCEv2 with PFC,
incast1024 under lossy RoCEv2 and under STrack with PFC; perm1024 under
the CHAOS1024 fault schedule with STrack and with RoCEv2, and linkdown1024
as t=0 uplink flaps; infer1024 under the active set at ``active_cap=512``
with STrack (its uncapped run and its cap-320 overflow count beside it)
and with RoCEv2; the collectives hd1024 under STrack and under RoCEv2 +
PFC striped over four sub-flows, a2a1024 under STrack, and allreduce8k's
spot trace at ``active_cap=48``; the batched sweeps of perm1024 seeds 0-7
under STrack and of perm1024 under RoCEv2 + PFC with entropy seeds 0-3,
and perm1024's per-tick trace every 4 ticks; the soak of the 64-host
default fleet over a clean and a ``CHAOS1024`` epoch and the event
oracle's runs of that fleet and of the spot fleet; the llama3-8b,
mamba2-2.7b and zamba2-2.7b SMOKE serve references) from the JAX package,
all of them or those whose file stems are given:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity.py [STEM ...]
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.convert import leaves
from repro_torch.sim.workloads import trace_digest
from repro_torch.profile import CHAOS1024 as _CHAOS1024
from repro_torch.profile import (ALLREDUCE8K_SPOT_CAP, COLLECTIVE1024,
                                 INFER1024_CAP, INFER1024_TENANTS)

# The port's CPU tests run many tiny tensor ops; intra-op threads only
# contend with the other test workers for the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REF_DIR = ROOT / "src" / "repro_torch" / "testdata"
REF_PATH = REF_DIR / "perm1024_strack_ref.json"
INCAST_REF_PATH = REF_DIR / "incast1024_strack_ref.json"
SERVE_REF_PATH = REF_DIR / "llama3_smoke_serve_ref.json"
SSM_SERVE_REF_PATHS = {"mamba2-2.7b": REF_DIR / "mamba2_smoke_serve_ref.json",
                       "zamba2-2.7b": REF_DIR / "zamba2_smoke_serve_ref.json"}

#: Summary keys the reference files pin (ints exact, floats to 1e-6).
REF_SUMMARY_KEYS = ("max_fct", "avg_fct", "unfinished", "drops", "pauses",
                    "ecn_marks", "retransmits", "rto_fires",
                    "sack_recoveries", "qdepth_max_pkts")
#: The RoCEv2/PFC reference files pin every summary key but the per-tenant
#: table (one tenant: the FCTs above).
PFC_SUMMARY_KEYS = REF_SUMMARY_KEYS + (
    "gbn_rewinds", "qdepth_p99_pkts", "blackholed_pkts", "corrupt_drops",
    "tx_rows_pkts")
#: The full-width RoCEv2/PFC runs: file stem -> (scenario, RunConfig
#: fields).  PFC is on by default under RoCEv2.
PFC_REFS = {
    "perm1024_rocev2": ("perm1024", dict(protocol="rocev2")),
    "incast1024_rocev2": ("incast1024", dict(protocol="rocev2")),
    "incast1024_rocev2_lossy": ("incast1024",
                                dict(protocol="rocev2", pfc=False)),
    "incast1024_strack_pfc": ("incast1024", dict(protocol="strack",
                                                 pfc=True)),
}
PFC_REF_PATHS = {name: REF_DIR / f"{name}_ref.json" for name in PFC_REFS}

#: The full-width chaos runs' fault schedule (``repro_torch.profile``'s
#: ``CHAOS1024``), as ``FaultSpec`` fields of either package: one entry of
#: each of the six classes, among them a permanent uplink flap.  The
#: corruption probability 0.2 makes the RoCEv2 run corrupt packets (at
#: 0.05 it corrupts none).
CHAOS1024 = dataclasses.asdict(_CHAOS1024)
#: The chaos reference files pin the PFC files' keys and the flap windows'
#: retransmit attribution.
CHAOS_SUMMARY_KEYS = PFC_SUMMARY_KEYS + ("win_retx",)
#: file stem -> (scenario, RunConfig fields but the faults, fault source):
#: ``CHAOS1024``, or ``"dead_links"``, the t=0 uplink-flap schedule of
#: linkdown1024's dead links run on the fabric with every link alive.
CHAOS_REFS = {
    "perm1024_chaos_strack": ("perm1024", {}, "chaos"),
    "perm1024_chaos_rocev2": ("perm1024", dict(protocol="rocev2"), "chaos"),
    "linkdown1024_strack": ("linkdown1024", {}, "dead_links"),
}
CHAOS_REF_PATHS = {name: REF_DIR / f"{name}_ref.json" for name in CHAOS_REFS}

#: The infer1024 files pin the PFC files' keys and the per-tenant and
#: per-group tables (four tenants, one group each).
INFER_SUMMARY_KEYS = PFC_SUMMARY_KEYS + (
    "tenant_fct", "group_fct", "max_collective_time", "finished_groups",
    "total_groups")
#: file stem -> RunConfig fields of the infer1024 run under the active set.
INFER_REFS = {
    "infer1024_strack_cap512": dict(active_cap=INFER1024_CAP),
    "infer1024_rocev2_cap512": dict(protocol="rocev2",
                                    active_cap=INFER1024_CAP),
}
INFER_REF_PATHS = {name: REF_DIR / f"{name}_ref.json" for name in INFER_REFS}
#: The cap below infer1024's peak live-flow count: the run raises.
INFER1024_SMALL_CAP = 320

#: The collective files pin every summary key (the per-group and
#: per-tenant tables among them) and each message's release and done tick.
COLLECTIVE_SUMMARY_KEYS = INFER_SUMMARY_KEYS
#: file stem -> (trace: a ``COLLECTIVE1024`` name of ``repro_torch.profile``
#: or "spot", allreduce8k's spot trace; RunConfig fields).
COLLECTIVE_REFS = {
    "hd1024_strack": ("hd1024", {}),
    "hd1024_roce4": ("hd1024", dict(protocol="rocev2", subflows=4)),
    "a2a1024_strack": ("a2a1024", {}),
    "allreduce8k_spot_cap48": ("spot", dict(active_cap=ALLREDUCE8K_SPOT_CAP)),
}
COLLECTIVE_REF_PATHS = {name: REF_DIR / f"{name}_ref.json"
                        for name in COLLECTIVE_REFS}


#: The batched sweeps (``run_fabric_trace_batch``, JAX's vmapped program):
#: file stem -> (RunConfig fields, the batch's axis: perm1024's seeds, or
#: ``roce_entropy_seed``s of perm1024 seed 0), and the summary keys each
#: entry pins.
SWEEP_REFS = {
    "perm1024_sweep8_strack": (dict(), ("seed", tuple(range(8)))),
    "perm1024_sweep4_rocev2": (dict(protocol="rocev2"),
                               ("roce_entropy_seed", tuple(range(4)))),
}
SWEEP_REF_PATHS = {name: REF_DIR / f"{name}_ref.json" for name in SWEEP_REFS}
#: perm1024 seed 0 under STrack with the queue trace every 4 ticks.
TRACE_REF = dict(n_ticks=512, trace_queues=True, trace_every=4)
TRACE_REF_PATH = REF_DIR / "perm1024_trace4_strack_ref.json"
#: Lower delay thresholds (us) at which the trace's settling time is kept
#: too: perm1024's queues stay under the default 8 us (98 packets).
TRACE_SETTLE_US = (0.5, 1.0)
#: The trace rows held exactly: each as the sha256 of its int32 (or
#: float32) bytes with its row count; ``cwnd_mean``, a mean of the flows'
#: windows whose summation order is XLA's on one side, is kept as floats.
TRACE_EXACT_KEYS = ("qsize", "drops_trace", "done", "delivered",
                    "pauses_trace", "paused_ports")


#: The soak of ``benchmarks/soak.py``'s default fleet (64 hosts, two
#: 16-rank training jobs and a 128-flow burst tenant), seed 0, a clean
#: epoch then a ``CHAOS1024`` epoch; the file holds the soak's return
#: dict, each epoch's ``run()`` summary and the rendered ``.prom`` text.
SOAK_REF = dict(seed=0, epochs=2, chaos=(None, "CHAOS1024"))
SOAK_REF_PATH = REF_DIR / "soak64_chaos2_strack_ref.json"
#: The event oracle's runs (``backend="events"``, epoch 0 of
#: ``mixed_scenario`` at seed 0, ``until`` as the soak benchmark's spot
#: check): name -> (fleet of ``benchmarks/soak.py``, RunConfig fields, with
#: "CHAOS1024" for that schedule).
EVENTS_REFS = {
    "default_clean": ("default", {}),
    "default_chaos": ("default", {"faults": "CHAOS1024"}),
    "spot_strack": ("spot", {}),
    "spot_rocev2": ("spot", {"protocol": "rocev2"}),
}
EVENTS_UNTIL_US = 2e7
EVENTS_REF_PATH = REF_DIR / "events64_ref.json"


def canon(obj) -> str:
    """``obj`` in JSON's own form (tuples as lists, keys as strings,
    sorted), for exact comparison of nested summaries with NaNs."""
    return json.dumps(json.loads(json.dumps(obj)), sort_keys=True)


def jax_fleet(name: str) -> tuple:
    """``(topo, net, jobs, tenants)`` of ``benchmarks/soak.py``'s
    ``default_fleet`` or ``spot_fleet`` (the JAX package's records)."""
    from benchmarks.soak import default_fleet, spot_fleet
    return {"default": default_fleet, "spot": spot_fleet}[name]()


def port_fleet(name: str) -> tuple:
    """The port's records of :func:`jax_fleet` ``(name)``, field for
    field."""
    from repro_torch.core.params import NetworkSpec
    from repro_torch.sim.topology import FatTree
    from repro_torch.sim.traffic import InferenceTenant, TrainingJob
    asdict = dataclasses.asdict
    topo, net, jobs, tenants = jax_fleet(name)
    return (FatTree(**asdict(topo)), NetworkSpec(**asdict(net)),
            [TrainingJob(**asdict(j)) for j in jobs],
            [InferenceTenant(**asdict(t)) for t in tenants])


@contextlib.contextmanager
def recording_runs(module):
    """``module.run`` replaced by a wrapper that appends each summary it
    returns to the list this yields."""
    runs, real = [], module.run

    def run(*a, **kw):
        runs.append(real(*a, **kw))
        return runs[-1]
    module.run = run
    try:
        yield runs
    finally:
        module.run = real


def soak_reference() -> dict:
    """The JAX package's soak of ``SOAK_REF`` (its program cache cleared
    first, so that it reports its one build): the return dict, each
    epoch's ``run()`` summary and the ``.prom`` text it wrote."""
    import tempfile
    from repro.obs.metrics import MetricsRegistry
    from repro.sim import fabric as F
    from repro.sim import traffic
    from repro.sim.faults import FaultSpec
    topo, net, jobs, tenants = jax_fleet("default")
    chaos = [None if c is None else FaultSpec(**CHAOS1024)
             for c in SOAK_REF["chaos"]]
    F.clear_program_cache()
    with tempfile.TemporaryDirectory() as d, \
            recording_runs(traffic) as runs:
        out = Path(d) / "soak.prom"
        res = traffic.soak(topo, jobs, tenants, epochs=SOAK_REF["epochs"],
                           net=net, seed=SOAK_REF["seed"],
                           registry=MetricsRegistry(), out_path=str(out),
                           chaos=chaos)
        prom = out.read_text()
    return json.loads(canon(dict(SOAK_REF, chaos=[
        None if c is None else CHAOS1024 for c in SOAK_REF["chaos"]],
        soak=res, epoch_runs=runs, prom=prom)))


def events_reference() -> dict:
    """The JAX package's oracle runs of ``EVENTS_REFS``: each summary,
    ``msg_fct`` and ``group_fct`` among its keys."""
    from repro.sim.faults import FaultSpec
    from repro.sim.traffic import mixed_scenario
    from repro.sim.workloads import RunConfig, run
    out = {}
    for name, (fleet, kw) in EVENTS_REFS.items():
        topo, net, jobs, tenants = jax_fleet(fleet)
        sc = mixed_scenario(topo, jobs, tenants, net=net, seed=0)[0]
        kw = dict(kw)
        if kw.get("faults") == "CHAOS1024":
            kw["faults"] = FaultSpec(**CHAOS1024)
        out[name] = run(sc, RunConfig(backend="events",
                                      until=EVENTS_UNTIL_US, **kw))
    return json.loads(canon(out))


def row_digest(rows) -> dict:
    """A trace key's rows as their count and the sha256 of their bytes
    (int32, or float32 bit patterns)."""
    import hashlib
    a = np.ascontiguousarray(np.asarray(rows))
    a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
    return {"rows": int(a.shape[0]), "sha256": hashlib.sha256(
        a.tobytes()).hexdigest()}


def _bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.view(np.int32 if a.dtype.itemsize == 4 else np.int64)
    return a


def diff_leaves(ref_tree, port_tree, ring_rows=None) -> list:
    """Leaves that differ between a reference pytree and the port's
    (floats compared bit for bit).  ``ring_rows`` trims the queue ring
    ``q.*`` leaves to their real rows: the trash row's contents are
    unspecified and never read."""
    ref, port = leaves(ref_tree), leaves(port_tree)
    if set(ref) != set(port):
        return [("<fields>", sorted(set(ref) ^ set(port)))]
    bad = []
    for name in ref:
        a, b = np.asarray(ref[name]), np.asarray(port[name])
        if ring_rows is not None and name.startswith("q."):
            a, b = a[:ring_rows], b[:ring_rows]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append((name, (a.shape, a.dtype), (b.shape, b.dtype)))
        elif not np.array_equal(_bits(a), _bits(b)):
            first = np.argwhere(_bits(a) != _bits(b))[0]
            bad.append((name, tuple(int(i) for i in first)))
    return bad


def small_scenario(pkg: str, kind: str, seed: int):
    """A small scenario of either package (``pkg`` "jax" or "port") on a
    4x4 fabric at 400 Gbps: a 64 KiB permutation (``kind`` "perm"), an
    8-to-1 incast of 64 KiB (``"incast"``) or a ring allreduce of 4 ranks
    and 128 KiB in 32 KiB chunks (``"ring"``), placed by ``seed``."""
    if pkg == "jax":
        from repro.core.params import NetworkSpec as Net
        from repro.sim import workloads as W
        from repro.sim.topology import full_bisection
    else:
        from repro_torch.core.params import NetworkSpec as Net
        from repro_torch.sim import workloads as W
        from repro_torch.sim.topology import full_bisection
    topo, net = full_bisection(4, 4), Net(link_gbps=400.0)
    if kind == "perm":
        return W.permutation_scenario(topo, 64 * 2 ** 10, net=net, seed=seed)
    if kind == "incast":
        return W.incast_scenario(topo, 8, 64 * 2 ** 10, net=net, seed=seed)
    return W.collective_scenario(topo, "ring", 1, 4, 128 * 2 ** 10, net=net,
                                 seed=seed, chunk=32 * 2 ** 10)


def state_leaves(tree, prefix="") -> dict:
    """The leaves of a tree of (named) tuples of either package as numpy
    arrays, keyed by their dotted path (``None`` leaves left out)."""
    if tree is None:
        return {}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for name, v in zip(names, tree):
            out.update(state_leaves(v, f"{prefix}{name}."))
        return out
    return {prefix.rstrip("."): np.asarray(tree)}


def entry_leaves(tree, i: int) -> dict:
    """:func:`state_leaves` of entry ``i`` of a batch's tree."""
    return {k: v[i] for k, v in state_leaves(tree).items()}


def differing_leaves(a: dict, b: dict, q_rows: int) -> dict:
    """Leaves of two flattened states that differ (floats by their bits),
    each with its largest difference in float32 ulps (None for
    non-floats); the ring's (``q.*``) trash row is left out."""
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    out = {}
    for k in a:
        x, y = a[k], b[k]
        if k.startswith("q."):
            x, y = x[:q_rows], y[:q_rows]
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape,
                                                            y.shape)
        if not np.array_equal(_bits(x), _bits(y)):
            out[k] = (int(np.abs(_bits(x).astype(np.int64)
                                 - _bits(y).astype(np.int64)).max())
                      if x.dtype.kind == "f" else None)
    return out


def _jax_scenario(name: str):
    """The JAX package's full-width scenarios: ``perm1024``
    (benchmarks/perf.py canonical scenario: full_bisection(32, 32), 64 KiB,
    400 Gbps, seed 0) and ``incast1024`` (256 hosts of that fabric send
    16 KiB each to host 0)."""
    from repro.core.params import NetworkSpec
    from repro.sim.topology import full_bisection
    from repro.sim.workloads import incast_scenario, permutation_scenario
    net = NetworkSpec(link_gbps=400.0)
    if name == "perm1024":
        return permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                                    net=net, seed=0)
    return incast_scenario(full_bisection(32, 32), 256, 16 * 2 ** 10, net=net)


def jax_linkdown1024():
    """The JAX package's linkdown1024: ``linkdown_scenario`` on
    ``full_bisection(32, 32)`` with 1/8 of the links dead (128 uplinks of
    16 ToRs), 64 KiB, 400 Gbps, seed 0."""
    from repro.core.params import NetworkSpec
    from repro.sim.workloads import linkdown_scenario
    return linkdown_scenario({"n_tor": 32, "hosts_per_tor": 32}, 0.125,
                             64 * 2 ** 10, net=NetworkSpec(link_gbps=400.0))


def jax_infer1024(shape=(32, 32)):
    """The JAX package's infer1024 trace: ``traffic.mixed_scenario`` with
    four ``InferenceTenant`` of ``INFER1024_TENANTS`` and no training job,
    seed 0, 400 Gbps, on ``full_bisection(*shape)`` (perm1024's fabric at
    full width)."""
    from repro.core.params import NetworkSpec
    from repro.sim.topology import full_bisection
    from repro.sim.traffic import InferenceTenant, mixed_scenario
    tenants = [InferenceTenant(f"inf{i}", **INFER1024_TENANTS)
               for i in range(4)]
    return mixed_scenario(full_bisection(*shape), (), tenants,
                          net=NetworkSpec(link_gbps=400.0), seed=0)[0]


#: The two inference tenants of the active-set state tests' open-loop 4x4
#: trace: 40 flows of 16-80 KiB arriving over ticks 3-154, at most 32 of
#: them live at once.
OPEN_LOOP_TENANTS = (
    dict(name="a", n_flows=24, mean_interarrival_ticks=5.0,
         size_bytes=32 * 2 ** 10, size_jitter=0.5, n_targets=2),
    dict(name="b", n_flows=16, mean_interarrival_ticks=8.0,
         size_bytes=64 * 2 ** 10, size_jitter=0.25, n_targets=3))


def jax_collective(name: str):
    """The JAX package's collective trace ``name``: a ``COLLECTIVE1024``
    entry on ``full_bisection(32, 32)`` at 400 Gbps, or "spot",
    allreduce8k's spot trace (two HD allreduces of 8 ranks, 128 KiB, on
    ``full_bisection(4, 4)`` at 100 Gbps), seed 0."""
    from repro.core.params import NetworkSpec
    from repro.sim.topology import full_bisection
    from repro.sim.workloads import collective_scenario
    if name == "spot":
        return collective_scenario(full_bisection(4, 4), "hd", 2, 8,
                                   128 * 2 ** 10,
                                   net=NetworkSpec(link_gbps=100.0), seed=0)
    algo, jobs, ranks, nbytes, kw = COLLECTIVE1024[name]
    return collective_scenario(full_bisection(32, 32), algo, jobs, ranks,
                               nbytes, net=NetworkSpec(link_gbps=400.0),
                               seed=0, **kw)


#: The golden collectives on ``full_bisection(2, 4)`` at 100 Gbps, seed 0
#: (``tests/test_golden.py``): name -> ``collective_scenario``'s arguments
#: and keywords after the topology.  ``ring8`` is a ring allreduce of 8
#: ranks, 512 KiB in 32 KiB chunks (224 messages, each chunk waiting for
#: its predecessor's); ``a2a_x2`` two windowed all-to-alls of 4 ranks
#: (window 2: a rank's third send waits for its first).
SMALL_COLLECTIVES = {
    "ring8": (("ring", 1, 8, 512 * 2 ** 10),
              dict(seed=0, chunk=32 * 2 ** 10)),
    "a2a_x2": (("a2a", 2, 4, 256 * 2 ** 10),
               dict(seed=0, chunk=128 * 2 ** 10, window=2))}


def jax_small_collective(name: str) -> tuple:
    """The JAX package's ``SMALL_COLLECTIVES`` trace ``name`` (its
    ``Message`` records feed both packages)."""
    from repro.core.params import NetworkSpec
    from repro.sim.topology import full_bisection
    from repro.sim.workloads import collective_scenario
    args, kw = SMALL_COLLECTIVES[name]
    return collective_scenario(full_bisection(2, 4), *args,
                               net=NetworkSpec(link_gbps=100.0),
                               **kw).messages


def collective_reference(name: str) -> dict:
    """The JAX package's run of one ``COLLECTIVE_REFS`` entry: every key of
    ``COLLECTIVE_SUMMARY_KEYS``, warp trips, end tick, done ticks, each
    message's release and done tick, and the trace's size (messages,
    edges, sub-flows) and digest."""
    trace, kw = COLLECTIVE_REFS[name]
    sc = jax_collective(trace)
    out = _reference(sc, kw, COLLECTIVE_SUMMARY_KEYS, msg_ticks=True)
    out.update(n_msgs=len(sc.messages),
               n_edges=sum(len(m.deps) for m in sc.messages),
               n_flows=len(sc.messages) * kw.get("subflows", 1),
               trace_sha256=trace_digest(sc.messages))
    return out


def committed_collective_file(name: str) -> dict:
    """One committed full-width ``COLLECTIVE_REFS`` file, after checking
    that it was made from the trace both packages generate: the digest of
    the JAX generator's message list, of the port's and the file's agree,
    as do the message and edge counts; the file's tick budget is the
    port's for its config, its run finished every message and group, and
    each message's release precedes its completion.  (Rebuilding these
    files from JAX takes two to three minutes each on a CPU, so it is done
    by hand: ``python tests/torch_parity.py <stem>``.)"""
    from repro_torch.profile import collective1024_scenario
    from repro_torch.sim.workloads import RunConfig, _scenario_ticks
    ref = json.loads(COLLECTIVE_REF_PATHS[name].read_text())
    trace, kw = COLLECTIVE_REFS[name]
    jmsgs = jax_collective(trace).messages
    sc = collective1024_scenario(trace)
    assert trace_digest(jmsgs) == trace_digest(sc.messages) \
        == ref["trace_sha256"]
    assert (len(sc.messages), sum(len(m.deps) for m in sc.messages)) == (
        ref["n_msgs"], ref["n_edges"])
    assert _scenario_ticks(sc, RunConfig(**kw)) == ref["n_ticks"]
    assert len(ref["done_tick"]) == ref["n_flows"] == \
        ref["n_msgs"] * kw.get("subflows", 1)
    assert ref["unfinished"] == 0
    assert ref["finished_groups"] == ref["total_groups"]
    assert all(0 <= r <= d for r, d in zip(ref["msg_release_tick"],
                                            ref["msg_done_tick"]))
    assert ref["end_tick"] == ref["n_ticks"]
    for k in COLLECTIVE_SUMMARY_KEYS + ("msg_release_tick",
                                        "msg_done_tick"):
        assert k in ref, k
    return ref


def open_loop_trace():
    """The JAX package's open-loop 4x4 trace (``mixed_scenario`` of the
    ``OPEN_LOOP_TENANTS``, seed 0, 400 Gbps); its ``Message`` records feed
    both packages."""
    from repro.core.params import NetworkSpec
    from repro.sim.topology import full_bisection
    from repro.sim.traffic import InferenceTenant, mixed_scenario
    tenants = [InferenceTenant(**t) for t in OPEN_LOOP_TENANTS]
    return mixed_scenario(full_bisection(4, 4), (), tenants,
                          net=NetworkSpec(link_gbps=400.0), seed=0)[0].messages


def arrival_trace(cls):
    """Four messages, then four more that arrive at ticks 120-141, built
    with either package's ``Message`` class ``cls``: the two-stage trace
    of ``tests/test_rank_active.py`` with its dependency edges replaced by
    arrival ticks (at most five flows live at once)."""
    msgs = [cls(mid=i, src=i, dst=(i + 4) % 8, size=float(12288 + 4096 * i),
                group=0) for i in range(4)]
    msgs += [cls(mid=4 + i, src=(i + 4) % 8, dst=i,
                 size=float(20480 + 4096 * i), group=1, arrival=120 + 7 * i)
             for i in range(4)]
    return msgs


def chain_trace(cls):
    """Four messages, then four that each wait for one of the first,
    built with either package's ``Message`` class ``cls``: the two-stage
    trace of ``tests/test_rank_active.py`` (at most five flows live at
    once on ``full_bisection(2, 4)``)."""
    msgs = [cls(mid=i, src=i, dst=(i + 4) % 8, size=float(12288 + 4096 * i),
                group=0) for i in range(4)]
    msgs += [cls(mid=4 + i, src=(i + 4) % 8, dst=i,
                 size=float(20480 + 4096 * i), deps=(i,), group=1)
             for i in range(4)]
    return msgs


def jax_final_state(topo, messages, n_ticks: int, cfg):
    """The JAX package's final ``FabricState`` of a trace, run as
    ``run_fabric_trace`` runs it but without the host metrics (which raise
    on an active-set overflow)."""
    import jax.numpy as jnp
    from repro.sim import fabric as F
    flows, dep = F.expand_messages(messages, cfg.subflows)
    fd = F.build_fault_data(cfg.faults, topo.n_tor, topo.n_spine,
                            topo.hosts_per_tor)
    src, dst, total, tails, ent0 = F._flow_arrays(flows, cfg)
    prog = F._get_program(topo, int(src.shape[0]), n_ticks, cfg, dep)
    return prog.jit_single(src, dst, total, tails, ent0,
                           jnp.int32(F.LB_MODES.index(cfg.lb_mode)),
                           F._arrival_array(messages), fd)[0]


def port_program(topo, messages, n_ticks: int, cfg):
    """The port's bound ``FabricProgram`` of a trace on the CPU, as
    ``run_fabric_trace`` builds it."""
    from repro_torch.sim import fabric as TF
    return TF.trace_program(topo, messages, n_ticks, cfg, "cpu")


def port_states(topo, messages, ticks, cfg) -> dict:
    """The port's state after each tick count of ``ticks`` (dense ticks on
    the CPU, one run): ``{k: FabricState}``."""
    from repro_torch.sim.fabric import _clone_tree
    prog = port_program(topo, messages, max(ticks), cfg)
    st, out = prog.init_state(), {}
    for t in range(max(ticks)):
        st, _, _ = prog.tick(st, t)
        if t + 1 in ticks:   # the ring is updated in place: keep a copy
            out[t + 1] = _clone_tree(st)
    return out


def overflow_ticks(err: Exception) -> int:
    """The tick count of either package's active-set overflow error."""
    import re
    return int(re.search(r"exceeded on (\d+) tick", str(err)).group(1))


def infer_reference(name: str) -> dict:
    """The JAX package's infer1024 run of one ``INFER_REFS`` entry: every
    key of ``INFER_SUMMARY_KEYS``, warp trips, end tick, done ticks; for
    STrack also the uncapped run (``uncapped``) and the overflow count of
    the run at ``INFER1024_SMALL_CAP`` (``small_cap``,
    ``small_cap_overflow_ticks``)."""
    from repro.sim.workloads import RunConfig, _fabric_cfg, _scenario_ticks
    from repro.sim.fabric import run_fabric_trace
    sc = jax_infer1024()
    kw = INFER_REFS[name]
    out = _reference(sc, kw, INFER_SUMMARY_KEYS)
    if kw.get("protocol", "strack") == "strack":
        out["uncapped"] = _reference(sc, {}, INFER_SUMMARY_KEYS)
        cfg = RunConfig(active_cap=INFER1024_SMALL_CAP)
        try:
            run_fabric_trace(sc.topo, sc.messages, _scenario_ticks(sc, cfg),
                             _fabric_cfg(sc, cfg))
        except RuntimeError as e:
            out["small_cap"] = INFER1024_SMALL_CAP
            out["small_cap_overflow_ticks"] = overflow_ticks(e)
        else:
            raise AssertionError("infer1024 at the small cap did not raise")
    return out


def perm1024_reference() -> dict:
    """The JAX package's perm1024 run under the default RunConfig: summary
    keys, warp trips, end tick, done ticks."""
    return _reference(_jax_scenario("perm1024"))


def incast1024_reference() -> dict:
    """The JAX package's incast1024 run under the default RunConfig.  Its
    standing queue drops at the data threshold, marks ECN on the dither
    and sends the senders into SACK recovery, which the permutation never
    does."""
    return _reference(_jax_scenario("incast1024"))


def pfc_reference(name: str) -> dict:
    """The JAX package's run of one ``PFC_REFS`` entry: every summary key
    of ``PFC_SUMMARY_KEYS``, warp trips, end tick, done ticks."""
    scenario, kw = PFC_REFS[name]
    return _reference(_jax_scenario(scenario), kw, PFC_SUMMARY_KEYS)


def chaos_reference(name: str) -> dict:
    """The JAX package's run of one ``CHAOS_REFS`` entry: every key of
    ``CHAOS_SUMMARY_KEYS``, warp trips, end tick, done ticks."""
    from repro.sim.faults import FaultSpec, faults_from_dead_links
    from repro.sim.topology import full_bisection
    scenario, kw, source = CHAOS_REFS[name]
    if source == "chaos":
        return _reference(_jax_scenario(scenario),
                          dict(kw, faults=FaultSpec(**CHAOS1024)),
                          CHAOS_SUMMARY_KEYS)
    dead = jax_linkdown1024()
    sc = dataclasses.replace(dead, topo=full_bisection(32, 32))
    return _reference(sc, dict(kw, faults=faults_from_dead_links(dead.topo)),
                      CHAOS_SUMMARY_KEYS)


def _reference(sc, kw=None, keys=REF_SUMMARY_KEYS, msg_ticks=False) -> dict:
    """One scenario through the JAX package under ``RunConfig(**kw)``:
    summary keys, warp trips, end tick, done ticks (with ``msg_ticks``,
    each message's release and done tick too)."""
    from repro.sim.fabric import run_fabric_trace, summarize
    from repro.sim.workloads import RunConfig, _fabric_cfg, _scenario_ticks
    cfg = RunConfig(**(kw or {}))
    n_ticks = _scenario_ticks(sc, cfg)
    final, m = run_fabric_trace(sc.topo, sc.messages, n_ticks,
                                _fabric_cfg(sc, cfg))
    s = summarize(m)
    # JSON's own form: tuples as lists, the tenant and group tables keyed
    # by strings
    out = json.loads(json.dumps({k: s[k] for k in keys}))
    out.update(n_ticks=int(n_ticks), warp_trips=int(m["warp_trips"]),
               end_tick=int(m["end_tick"]),
               done_tick=[int(v) for v in np.asarray(m["done_tick"])])
    if msg_ticks:
        for k in ("msg_release_tick", "msg_done_tick"):
            out[k] = [int(v) for v in np.asarray(getattr(final, k))]
    return out


def _entry_reference(m: dict, keys) -> dict:
    """One entry of a JAX batch as ``_reference`` records a run."""
    from repro.sim.fabric import summarize
    s = summarize(m)
    out = json.loads(json.dumps({k: s[k] for k in keys}))
    out.update(warp_trips=int(m["warp_trips"]), end_tick=int(m["end_tick"]),
               done_tick=[int(v) for v in np.asarray(m["done_tick"])])
    return out


def sweep_reference(name: str) -> dict:
    """The JAX package's batched run of one ``SWEEP_REFS`` entry (one
    vmapped program): each entry's summary keys, warp trips, end tick and
    done ticks, in batch order."""
    from repro.sim import fabric as F
    from repro.sim.workloads import (RunConfig, _fabric_cfg, _scenario_ticks,
                                     permutation_scenario)
    kw, (axis, values) = SWEEP_REFS[name]
    base = _jax_scenario("perm1024")
    cfg = RunConfig(**kw)
    if axis == "seed":
        scs = [permutation_scenario(base.topo, 64 * 2 ** 10, net=base.net,
                                    seed=s) for s in values]
        seeds = None
    else:
        scs, seeds = [base] * len(values), list(values)
    n_ticks = _scenario_ticks(scs[0], cfg)
    _, per = F.run_fabric_trace_batch(
        base.topo, [sc.messages for sc in scs], n_ticks,
        _fabric_cfg(scs[0], cfg), entropy_seeds=seeds)
    keys = PFC_SUMMARY_KEYS if cfg.protocol == "rocev2" else REF_SUMMARY_KEYS
    return {"axis": axis, "values": list(values), "n_ticks": int(n_ticks),
            "entries": [_entry_reference(m, keys) for m in per]}


def trace_reference() -> dict:
    """The JAX package's perm1024 seed 0 under STrack with ``TRACE_REF``:
    the summary keys, ``queue_settle_us`` (and at ``TRACE_SETTLE_US``),
    the done ticks and each trace
    key's rows (``TRACE_EXACT_KEYS`` as digests, ``cwnd_mean`` as
    floats)."""
    from repro.sim.fabric import run_fabric_trace
    from repro.sim.workloads import (RunConfig, _fabric_cfg, _fabric_summary,
                                     _queue_settle_us, _scenario_ticks)
    sc = _jax_scenario("perm1024")
    cfg = RunConfig(**TRACE_REF)
    _, m = run_fabric_trace(sc.topo, sc.messages, _scenario_ticks(sc, cfg),
                            _fabric_cfg(sc, cfg))
    s = _fabric_summary(sc, cfg, m)
    out = json.loads(json.dumps({k: s[k] for k in REF_SUMMARY_KEYS}))
    out.update(queue_settle_us=s["queue_settle_us"],
               queue_settle_us_at={str(th): _queue_settle_us(m, th)
                                   for th in TRACE_SETTLE_US},
               trace_every=int(m["trace_every"]),
               done_tick=[int(v) for v in np.asarray(m["done_tick"])],
               rows={k: row_digest(m[k]) for k in TRACE_EXACT_KEYS},
               cwnd_mean=[float(v) for v in np.asarray(m["cwnd_mean"])])
    return out


def jax_lm(arch: str, dtype: str, seed: int, **over):
    """(config, params) of the JAX package: the SMOKE config of ``arch``
    in ``dtype`` with ``over`` replaced, and ``torch_lm_weights`` from
    ``seed`` as jnp arrays."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from torch_lm_weights import lm_weights
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              **over)
    return cfg, jax.tree.map(jnp.asarray, lm_weights(cfg, seed))


def jax_teacher_forced(cfg, params, tokens, cache_dtype) -> np.ndarray:
    """The JAX package's decode logits (T, B, vocab) with the prompt fed
    one token at a time from an empty cache of ``cache_dtype``."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm
    from repro.runtime.serve import make_decode_step
    B, T = tokens.shape
    step = jax.jit(make_decode_step(cfg))
    cache = lm.init_cache(cfg, B, T, dtype=cache_dtype)
    out = []
    for t in range(T):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.asarray(t, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out)


def llama3_smoke_serve_reference() -> dict:
    """The JAX package serving llama3-8b SMOKE in f32, weights and prompt
    from ``torch_lm_weights`` (numpy seed ``SERVE_REF``): the prefill's
    last-position logits with ``attn_impl="pallas"`` (interpret mode), and
    the teacher-forced decode logits at every prompt step with
    ``attn_impl="naive"`` (the reference's pallas decode is ROADMAP C6),
    from a bf16 cache (``init_cache``'s default) and from an f32 one."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.runtime.serve import make_prefill_step
    from torch_lm_weights import SERVE_REF, prompt
    seed, B, T = SERVE_REF["seed"], SERVE_REF["batch"], SERVE_REF["steps"]
    cfg, params = jax_lm(SERVE_REF["arch"], "float32", seed,
                         attn_impl="pallas")
    tokens = prompt(cfg, seed, B, T)
    pre = jax.jit(make_prefill_step(cfg))(params,
                                          {"tokens": jnp.asarray(tokens)})
    naive = dataclasses.replace(cfg, attn_impl="naive")
    rnd = lambda a: [float(f"{x:.9g}") for x in np.asarray(a).ravel()]
    return dict(SERVE_REF, dtype="float32", prompt=tokens.tolist(),
                prefill_last_logits=rnd(pre),
                decode_logits_bf16_cache=rnd(jax_teacher_forced(
                    naive, params, tokens, jnp.bfloat16)),
                decode_logits_f32_cache=rnd(jax_teacher_forced(
                    naive, params, tokens, jnp.float32)))


def ssm_smoke_serve_reference(arch: str) -> dict:
    """The JAX package serving the SMOKE config of ``arch`` (mamba2-2.7b
    or zamba2-2.7b) in f32, weights and prompt from ``torch_lm_weights``
    (numpy seed ``SSM_SERVE_REF[arch]``): the prefill's last-position
    logits with ``attn_impl="pallas"`` (zamba2's shared attention through
    the Pallas kernel in interpret mode; the SSD through the model's
    ``ssd_chunked``), the teacher-forced decode logits at every prompt
    step from an f32 cache, and ``new`` greedy tokens after the prompt,
    both with ``attn_impl="chunked"`` (the reference's pallas decode is
    ROADMAP C6; at one query chunked attention is the naive one)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.runtime.serve import greedy_generate, make_prefill_step
    from torch_lm_weights import SSM_SERVE_REF, prompt
    ref = SSM_SERVE_REF[arch]
    seed, B, T = ref["seed"], ref["batch"], ref["steps"]
    cfg, params = jax_lm(arch, "float32", seed, attn_impl="pallas")
    tokens = prompt(cfg, seed, B, T)
    pre = jax.jit(make_prefill_step(cfg))(params,
                                          {"tokens": jnp.asarray(tokens)})
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    greedy = greedy_generate(params, chunked, jnp.asarray(tokens),
                             ref["new"], T + ref["new"])
    rnd = lambda a: [float(f"{x:.9g}") for x in np.asarray(a).ravel()]
    return dict(ref, dtype="float32", prompt=tokens.tolist(),
                prefill_last_logits=rnd(pre),
                decode_logits_f32_cache=rnd(jax_teacher_forced(
                    chunked, params, tokens, jnp.float32)),
                greedy_tokens=np.asarray(greedy).tolist())


def write_references() -> None:
    REF_DIR.mkdir(parents=True, exist_ok=True)
    makers = [(REF_PATH, perm1024_reference),
              (INCAST_REF_PATH, incast1024_reference),
              (SERVE_REF_PATH, llama3_smoke_serve_reference)]
    makers += [(path, lambda a=arch: ssm_smoke_serve_reference(a))
               for arch, path in SSM_SERVE_REF_PATHS.items()]
    makers += [(path, lambda n=name: pfc_reference(n))
               for name, path in PFC_REF_PATHS.items()]
    makers += [(path, lambda n=name: chaos_reference(n))
               for name, path in CHAOS_REF_PATHS.items()]
    makers += [(path, lambda n=name: infer_reference(n))
               for name, path in INFER_REF_PATHS.items()]
    makers += [(path, lambda n=name: collective_reference(n))
               for name, path in COLLECTIVE_REF_PATHS.items()]
    makers += [(path, lambda n=name: sweep_reference(n))
               for name, path in SWEEP_REF_PATHS.items()]
    makers += [(TRACE_REF_PATH, trace_reference),
               (SOAK_REF_PATH, soak_reference),
               (EVENTS_REF_PATH, events_reference)]
    only = set(sys.argv[1:])
    for path, make in makers:
        if only and path.name.removesuffix("_ref.json") not in only:
            continue
        path.write_text(json.dumps(make(), sort_keys=True) + "\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))   # benchmarks.soak's fleets
    write_references()
