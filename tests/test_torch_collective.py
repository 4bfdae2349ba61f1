"""Dependency scheduling and sub-flow striping in the port: the structure of
collective traces against the JAX reference.

* ``expand_messages`` and its ``DepSpec`` equal JAX's field for field on
  ring, DBT, HD and all-to-all traces with chunking, at 1 and 4 sub-flows;
  its errors (no message, a duplicate id, an unknown dependency) are
  JAX's.
* ``collective.algorithms``' generators and ``multi_job`` (shuffled and
  pinned placements) emit JAX's messages, message for message.
* ``collective_scenario`` and ``traffic.mixed_scenario`` with training
  jobs beside inference tenants emit JAX's traces; ``default_ticks`` on
  chained traces is JAX's.
* The goldens ``ring8_strack``, ``ring8_roce4`` and ``a2a_strack``
  through the port's ``run()``, every key.
* The port's ``DepSpec`` is what ``run_fabric_trace`` runs: each stripe
  keeps its message's arrival, RoCEv2 gives each stripe its own pinned
  entropy, and a run reports the collective keys exactly when the trace
  has edges or several groups.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.collective import algorithms as JA
from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import traffic as JT
from repro.sim import workloads as JW
from repro.sim.topology import full_bisection as j_full_bisection

from repro_torch.collective import algorithms as TA
from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim import traffic as TT
from repro_torch.sim import workloads as TW
from repro_torch.sim.topology import full_bisection

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

# The port's CPU runs are many tiny tensor ops; intra-op threads only
# contend with the other test workers for the cores.
torch.set_num_threads(1)

#: trace -> (algorithm, ranks, bytes, generator keywords): chunked so that
#: steps pipeline chunk to chunk (ring, HD) or fan in over all chunks
#: (DBT's root), and a windowed all-to-all whose later sends wait.
TRACES = {
    "ring": ("ring", 8, 512 * 2 ** 10, dict(chunk=32 * 2 ** 10)),
    "dbt": ("dbt", 8, 512 * 2 ** 10, dict(chunk=64 * 2 ** 10)),
    "hd": ("hd", 16, 1024 * 2 ** 10, dict(chunk=32 * 2 ** 10)),
    "a2a": ("a2a", 6, 768 * 2 ** 10, dict(chunk=48 * 2 ** 10, window=2)),
}


def _msgs(mod, trace, group=3):
    algo, n, nbytes, kw = TRACES[trace]
    return mod.ALGOS[algo](n, nbytes, group=group, **kw)


def _same_messages(jmsgs, tmsgs):
    assert len(jmsgs) == len(tmsgs)
    for jm, tm in zip(jmsgs, tmsgs):
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_generators_equal_jax(trace):
    jm, tm = _msgs(JA, trace), _msgs(TA, trace)
    _same_messages(jm, tm)
    assert sum(len(m.deps) for m in tm) > 0
    assert all(isinstance(m, TW.Message) for m in tm)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("algo", ["ring", "dbt", "hd", "a2a"])
def test_multi_job_equals_jax(algo, pinned):
    hosts = list(range(63, 63 - 3 * 8, -1)) if pinned else None
    kw = dict(chunk=64 * 2 ** 10, seed=5, hosts=hosts)
    jm, jp = JA.multi_job(algo, 3, 8, 64, 256 * 2 ** 10, **kw)
    tm, tp = TA.multi_job(algo, 3, 8, 64, 256 * 2 ** 10, **kw)
    _same_messages(jm, tm)
    assert jp == tp and len(tp) == 24


def _dep_fields(dep):
    return {f: (np.asarray(getattr(dep, f)) if f not in
                ("n_msgs", "n_groups", "msg_ids", "group_ids")
                else getattr(dep, f)) for f in dep._fields}


@pytest.mark.parametrize("subflows", [1, 4])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_expand_messages_equals_jax(trace, subflows):
    msgs = _msgs(TA, trace)
    # several groups, and mids that are not positions
    msgs += [dataclasses.replace(m, mid=m.mid + 1000, group=9,
                                 deps=tuple(d + 1000 for d in m.deps))
             for m in _msgs(TA, "a2a")]
    jflows, jdep = JF.expand_messages(msgs, subflows)
    tflows, tdep = TF.expand_messages(msgs, subflows)
    assert tflows == jflows
    assert len(tflows) == subflows * len(msgs)
    j, t = _dep_fields(jdep), _dep_fields(tdep)
    assert j.keys() == t.keys()
    for f in j:
        if isinstance(j[f], np.ndarray):
            assert t[f].dtype == np.int32 and np.array_equal(j[f], t[f]), f
        else:
            assert j[f] == t[f], f
    assert tdep.n_groups == 2 and int(tdep.edge_parent.shape[0]) > 0


@pytest.mark.parametrize("case", ["empty", "duplicate", "unknown"])
def test_expand_messages_errors_equal_jax(case):
    m0 = TW.Message(mid=0, src=0, dst=1, size=8192.0)
    msgs = {"empty": [],
            "duplicate": [m0, dataclasses.replace(m0, dst=2)],
            "unknown": [m0, TW.Message(mid=1, src=1, dst=2, size=1.0,
                                       deps=(0, 7))]}[case]
    with pytest.raises(ValueError) as j:
        JF.expand_messages(msgs, 2)
    with pytest.raises(ValueError) as t:
        TF.expand_messages(msgs, 2)
    assert str(t.value) == str(j.value)
    if case != "empty":   # and the run raises it
        sc = TW.Scenario(name=case, topo=full_bisection(2, 2),
                         net=NetworkSpec(), messages=tuple(msgs))
        with pytest.raises(ValueError, match=str(j.value)):
            TW.run(sc, TW.RunConfig(), device="cpu")


#: collective_scenario's arguments after the topology shape.
SCENARIOS = {
    "ring8": ((2, 4), ("ring", 1, 8, 512 * 2 ** 10),
              dict(seed=0, chunk=32 * 2 ** 10)),
    "a2a_x2": ((2, 4), ("a2a", 2, 4, 256 * 2 ** 10),
               dict(seed=0, chunk=128 * 2 ** 10, window=2)),
    "dbt_x3": ((4, 4), ("dbt", 3, 5, 300 * 2 ** 10), dict(seed=11)),
    "allreduce8k_spot": ((4, 4), ("hd", 2, 8, 128 * 2 ** 10), dict(seed=0)),
    "hd1024": ((32, 32), ("hd", 8, 128, 128 * 2 ** 10), dict(seed=0)),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_collective_scenario_equals_jax(case):
    shape, args, kw = SCENARIOS[case]
    jsc = JW.collective_scenario(j_full_bisection(*shape), *args,
                                 net=JNet(link_gbps=100.0), **kw)
    tsc = TW.collective_scenario(full_bisection(*shape), *args,
                                 net=NetworkSpec(link_gbps=100.0), **kw)
    assert tsc.name == jsc.name
    _same_messages(jsc.messages, tsc.messages)
    assert tsc.default_ticks() == jsc.default_ticks()
    if case == "hd1024":
        assert len(tsc.messages) == 14336
        assert sum(len(m.deps) for m in tsc.messages) == 13312


def test_default_ticks_on_chained_traces():
    """The critical path of a long chain outgrows the destinations'
    serialisation, with arrivals on the chain."""
    topo, jtopo = full_bisection(2, 4), j_full_bisection(2, 4)
    for n, arr in ((2, 0), (40, 0), (40, 500)):
        msgs = [TW.Message(mid=i, src=i % 8, dst=(i + 1) % 8,
                           size=float(4096 * (1 + i % 3)),
                           deps=(i - 1,) if i else (), arrival=arr * (i % 2))
                for i in range(n)]
        tsc = TW.Scenario(name="chain", topo=topo, net=NetworkSpec(),
                          messages=tuple(msgs))
        jsc = JW.Scenario(name="chain", topo=jtopo, net=JNet(),
                          messages=tuple(JW.Message(**dataclasses.asdict(m))
                                         for m in msgs))
        assert tsc.default_ticks() == jsc.default_ticks()


def _jobs(mod):
    return [mod.TrainingJob("ring", algo="ring", ranks=8,
                            collective_bytes=256 * 2 ** 10, steps=2,
                            algo_kw=(("chunk", 64 * 2 ** 10),)),
            mod.TrainingJob("hd", algo="hd", ranks=4, steps=3,
                            start_tick=40),
            mod.TrainingJob("pinned", algo="a2a", ranks=4,
                            collective_bytes=96 * 2 ** 10,
                            algo_kw=(("window", 2),),
                            hosts=(60, 61, 62, 63))]


def _tenants(mod):
    return [mod.InferenceTenant("inf0", n_flows=24, n_targets=3,
                                size_jitter=0.5),
            mod.InferenceTenant("inf1", n_flows=8, targets=(5, 9),
                                start_tick=100)]


@pytest.mark.parametrize("seed,epoch,n_jobs", [(0, 0, 3), (7, 2, 3),
                                               (3, 0, 1)])
def test_mixed_scenario_with_training_jobs_equals_jax(seed, epoch, n_jobs):
    jsc, jg = JT.mixed_scenario(j_full_bisection(8, 8), _jobs(JT)[:n_jobs],
                                _tenants(JT), net=JNet(link_gbps=400.0),
                                seed=seed, epoch=epoch)
    tsc, tg = TT.mixed_scenario(full_bisection(8, 8), _jobs(TT)[:n_jobs],
                                _tenants(TT), net=NetworkSpec(link_gbps=400.0),
                                seed=seed, epoch=epoch)
    assert tg == jg and tsc.name == jsc.name
    _same_messages(jsc.messages, tsc.messages)
    job_msgs = [m for m in tsc.messages if m.group < n_jobs]
    assert sum(len(m.deps) for m in job_msgs) > 0
    assert tsc.default_ticks() == jsc.default_ticks()


def test_mixed_scenario_job_placement_errors_equal_jax():
    for mod, topo in ((JT, j_full_bisection(2, 4)),
                      (TT, full_bisection(2, 4))):
        with pytest.raises(ValueError, match="not enough hosts"):
            mod.mixed_scenario(topo, [mod.TrainingJob("a", ranks=8),
                                      mod.TrainingJob("b", ranks=2)], ())


def test_stripes_keep_arrival_and_get_their_own_entropy():
    """Each of a message's stripes keeps its arrival and its message's
    release gate; under RoCEv2 each stripe pins its own entropy (drawn per
    flow index), so a message's four stripes spread over several paths, as
    ``test_striping_covers_multiple_entropies_per_message`` asks of the
    reference."""
    msgs = [TW.Message(mid=10 + i, src=i, dst=(i + 3) % 8,
                       size=float(64 * 2 ** 10), arrival=5 * i,
                       deps=(10,) if i == 3 else ())
            for i in range(4)]
    cfg = TF.FabricConfig(protocol="rocev2", subflows=4, trace_every=0)
    prog = TF.trace_program(full_bisection(2, 4), msgs, 50, cfg, "cpu")
    assert prog.N == 16 and prog.dep.msg_of_flow.tolist() == \
        [i // 4 for i in range(16)]
    assert prog.arrival.tolist() == [0, 5, 10, 15]
    assert prog.has_edges and prog.dep.init_pending.tolist() == [0, 0, 0, 1]
    ent = prog.ent0.view(4, 4)
    spines = prog.at.ecmp_spine(prog.src, prog.dst, prog.ent0).view(4, 4)
    assert all(len(set(r.tolist())) == 4 for r in ent)
    assert any(len(set(r.tolist())) > 1 for r in spines)
    _, jdep = JF.expand_messages(msgs, 4)
    jent = np.asarray(JF._flow_arrays(JF.expand_messages(msgs, 4)[0],
                                      JF.FabricConfig(protocol="rocev2"))[4])
    assert np.array_equal(jent, prog.ent0.numpy())
    assert np.array_equal(np.asarray(jdep.msg_of_flow),
                          prog.dep.msg_of_flow.numpy())


#: The collective goldens (``tests/test_golden.py``): SCENARIOS entry and
#: RunConfig fields.
GOLDENS = {"ring8_strack": ("ring8", {}),
           "ring8_roce4": ("ring8", dict(protocol="rocev2", subflows=4)),
           "a2a_strack": ("a2a_x2", {})}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_collective_goldens_through_the_port(name):
    """Every key of the golden file, ints exact and floats to 1e-6, as
    ``tests/test_golden.py`` holds the JAX package."""
    case, kw = GOLDENS[name]
    shape, args, gkw = SCENARIOS[case]
    sc = TW.collective_scenario(full_bisection(*shape), *args,
                                net=NetworkSpec(link_gbps=100.0), **gkw)
    got = TW.run(sc, TW.RunConfig(**kw), device="cpu")
    want = json.loads((Path(__file__).parent / "golden" / f"{name}.json")
                      .read_text())
    assert "max_collective_time" in want
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("kind", ["edges", "groups", "neither"])
def test_collective_keys_follow_the_reference(kind):
    """The per-group keys come out when the trace has edges or several
    groups (a one-job ring has one group), keyed by the caller's group
    ids, in both packages."""
    def msgs(cls):
        return [cls(mid=0, src=0, dst=5, size=8192.0, group=7),
                cls(mid=1, src=5, dst=2, size=8192.0,
                    deps=(0,) if kind == "edges" else (),
                    group=4 if kind == "groups" else 7)]
    cfg = dict(trace_every=0, time_warp=True)
    jm = JF.run_fabric_trace(j_full_bisection(2, 4), msgs(JW.Message), 300,
                             JF.FabricConfig(**cfg))[1]
    tm = TF.run_fabric_trace(full_bisection(2, 4), msgs(TW.Message), 300,
                             TF.FabricConfig(**cfg), device="cpu")[1]
    js, ts = JF.summarize(jm), TF.summarize(tm)
    assert ts == js
    assert ("max_collective_time" in ts) == (kind != "neither")
    if kind != "neither":
        assert set(ts["group_fct"]) == ({4, 7} if kind == "groups" else {7})
        assert ts["finished_groups"] == ts["total_groups"]
    if kind == "edges":
        rel = [r for r in tm["msg_release_us"]]
        assert rel[1] > rel[0] == 0.0
        assert tm["fct_us"][1] < ts["max_collective_time"]
