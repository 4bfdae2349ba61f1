"""The active set (``active_cap``) of the port against the JAX reference:
the traffic generator, capped runs and the overflow.

* ``traffic.mixed_scenario`` emits the reference's trace message for
  message: infer1024's four inference tenants, other seeds, given targets,
  no size jitter; training jobs are generated (ROADMAP A6).
* An arrival-gated trace on ``full_bisection(2, 4)``: four messages, then
  four more arriving at ticks 120-141 (at most five flows live at once).
  Under STrack, RoCEv2 + PFC and STrack under time warp the port at caps
  5 and 4 equals the port uncapped and JAX at the same cap, on every
  summary key (the per-group tables among them) and every done tick; cap
  2 raises with JAX's tick count; a cap of 8 or more is the dense
  program; a cap with the per-tick trace, with shards or below zero
  raises.
* The lane slate has ``nonzero(size=A, fill_value=N)``'s semantics.

(The plain active transition against the reference's Pallas path, and
infer1024's generator at 8x8: ``tests/test_torch_active_kernels.py``.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import traffic as JT
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import Message as JMessage

from repro_torch.core.params import NetworkSpec
from repro_torch.profile import INFER1024_TENANTS, infer1024_scenario
from repro_torch.sim import fabric as TF
from repro_torch.sim import traffic as TT
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import Message, RunConfig

from torch_parity import (arrival_trace, diff_leaves, jax_infer1024,
                          overflow_ticks)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: dense runs end here: the arrival-gated trace is done by tick 246
DENSE_TICKS = 400


def _tenants(mod, **over):
    return [mod.InferenceTenant(f"inf{i}", **{**INFER1024_TENANTS, **over})
            for i in range(4)]


#: case -> (mixed_scenario's keyword arguments but the tenants and the
#: topology, tenant fields over INFER1024_TENANTS, tenant count, fabric)
TRACES = {
    "infer1024": (dict(seed=0), {}, 4, (32, 32)),
    "seed1": (dict(seed=1), {}, 4, (32, 32)),
    "seed7_epoch3": (dict(seed=7, epoch=3), {}, 4, (32, 32)),
    "targets": (dict(seed=0), dict(n_flows=300, targets=(3, 77, 1000)), 1,
                (32, 32)),
    "no_jitter": (dict(seed=2), dict(size_jitter=0.0, start_tick=50), 2,
                  (8, 8)),
}


@pytest.mark.parametrize("case", sorted(TRACES))
def test_mixed_scenario_equals_jax(case):
    kw, over, n_ten, shape = TRACES[case]
    jt = _tenants(JT, **over)[:n_ten]
    tt = _tenants(TT, **over)[:n_ten]
    jsc, jgroups = JT.mixed_scenario(j_full_bisection(*shape), (), jt,
                                     net=JNet(link_gbps=400.0), **kw)
    tsc, tgroups = TT.mixed_scenario(full_bisection(*shape), (), tt,
                                     net=NetworkSpec(link_gbps=400.0), **kw)
    assert tgroups == jgroups and tsc.name == jsc.name
    assert len(tsc.messages) == len(jsc.messages) == n_ten * (
        over.get("n_flows", INFER1024_TENANTS["n_flows"]))
    for jm, tm in zip(jsc.messages, tsc.messages):
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    if case == "infer1024":
        assert tsc.messages == infer1024_scenario().messages
        assert max(m.arrival for m in tsc.messages) == 1462


def test_splitmix_stream_equals_jax():
    for seed in (0, 1, 2 ** 63 + 5, -3):
        for ctr in ((), (0,), (1, 2, 3, 4, 5), (-1, 2 ** 70)):
            assert TT._u64(seed, *ctr) == JT._u64(seed, *ctr)
            assert TT._u01(seed, *ctr) == JT._u01(seed, *ctr)
    assert TT._shuffled(1024, 0, 0) == JT._shuffled(1024, 0, 0)


def test_training_job_raises_naming_a6():
    """Training jobs are generated since A6 (message for message against
    JAX: ``tests/test_torch_collective.py``); a job that does not fit the
    fabric raises as the reference does, and so do duplicate names."""
    job = TT.TrainingJob("train", ranks=4)
    sc, groups = TT.mixed_scenario(full_bisection(4, 4), (job,), ())
    assert groups == {0: "train"} and len(sc.messages) == 4 * 6
    with pytest.raises(ValueError, match="not enough hosts"):
        TT.mixed_scenario(full_bisection(2, 2),
                          (job, dataclasses.replace(job, name="b")), ())
    with pytest.raises(ValueError, match="duplicate"):
        TT.mixed_scenario(full_bisection(4, 4), (),
                          (TT.InferenceTenant("a"), TT.InferenceTenant("a")))


#: proto -> FabricConfig fields of both packages
PROTOS = {"strack": dict(), "rocev2_pfc": dict(protocol="rocev2", pfc=True),
          "strack_warp": dict(time_warp=True)}


def _jax_run(kw, cap):
    ticks = 9000 if kw.get("time_warp") else DENSE_TICKS
    cfg = JF.FabricConfig(active_cap=cap, trace_every=0, **kw)
    return JF.run_fabric_trace(j_full_bisection(2, 4),
                               arrival_trace(JMessage), ticks, cfg)[1]


def _port_run(kw, cap):
    ticks = 9000 if kw.get("time_warp") else DENSE_TICKS
    cfg = TF.FabricConfig(active_cap=cap, trace_every=0, **kw)
    return TF.run_fabric_trace(full_bisection(2, 4), arrival_trace(Message),
                               ticks, cfg, device="cpu")[1]


def _same_run(a, b):
    sa, sb = JF.summarize(a), TF.summarize(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k] == sb[k], k
    assert np.array_equal(np.asarray(a["done_tick"]), b["done_tick"])
    assert a["fct_us"] == b["fct_us"]
    assert a["group_done_us"] == b["group_done_us"]
    assert a.get("warp_trips") == b.get("warp_trips")


@pytest.mark.parametrize("proto", sorted(PROTOS))
def test_capped_runs_equal_uncapped_and_jax(proto):
    kw = PROTOS[proto]
    base = _port_run(kw, None)
    assert TF.summarize(base)["total_groups"] == 2
    for cap in (5, 4):
        capped = _port_run(kw, cap)
        _same_run(base, capped)
        _same_run(_jax_run(kw, cap), capped)


@pytest.mark.parametrize("proto", sorted(PROTOS))
def test_small_cap_raises_with_jax_tick_count(proto):
    kw = PROTOS[proto]
    with pytest.raises(RuntimeError, match="active_cap=2 exceeded") as j:
        _jax_run(kw, 2)
    with pytest.raises(RuntimeError, match="active_cap=2 exceeded") as t:
        _port_run(kw, 2)
    assert overflow_ticks(t.value) == overflow_ticks(j.value) > 0
    assert str(t.value) == str(j.value)


def _program(cfg, msgs=None):
    msgs = msgs if msgs is not None else arrival_trace(Message)
    prog = TF.FabricProgram(full_bisection(2, 4), len(msgs), 300, cfg, "cpu")
    src, dst, total, tails, ent0 = TF._flow_arrays(
        [(m.src, m.dst, m.size) for m in msgs], cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(msgs), cfg.lb_mode,
              ent0)
    return prog


@pytest.mark.parametrize("cap", [8, 9, 64])
def test_cap_at_or_above_n_is_the_dense_program(cap):
    """As in the reference (``A >= N`` -> ``A = 0``): the program runs
    dense, and its run is the uncapped one, state leaf for leaf."""
    cfg = TF.FabricConfig(active_cap=cap, trace_every=0)
    assert _program(cfg).A == 0
    final, m = TF.run_fabric_trace(full_bisection(2, 4),
                                   arrival_trace(Message), 300, cfg,
                                   device="cpu")
    base, mb = TF.run_fabric_trace(full_bisection(2, 4),
                                   arrival_trace(Message), 300,
                                   TF.FabricConfig(trace_every=0),
                                   device="cpu")
    assert not diff_leaves(base, final)
    assert TF.summarize(m) == TF.summarize(mb)


def test_cap_checks_follow_the_reference():
    for kw, err in ((dict(active_cap=4, time_warp=False, trace_every=1),
                     "trace_every=0"),
                    (dict(active_cap=4, shard=2, trace_every=0),
                     "mutually exclusive"),
                    (dict(active_cap=-1), "positive")):
        with pytest.raises(ValueError, match=err):
            TF.check_slice(TF.FabricConfig(**kw))
        with pytest.raises(ValueError, match=err):
            JF._make_program(j_full_bisection(2, 4), 8, 10,
                             JF.FabricConfig(**kw))
    # the trace is dropped under time warp, as in the reference
    TF.check_slice(TF.FabricConfig(active_cap=4, time_warp=True,
                                   trace_every=1))
    with pytest.raises(ValueError, match="positive"):
        RunConfig(active_cap=0)
    with pytest.raises(ValueError, match="no-trace"):
        RunConfig(active_cap=4, trace_every=2)


def test_lane_slate_is_nonzero_with_fill():
    """The slate is ``nonzero(mask, size=A, fill_value=N)``: the first A
    set flows in ascending order, padded with N; overflow when more than
    A are set."""
    cfg = TF.FabricConfig(active_cap=5, trace_every=0)
    prog = _program(cfg)
    rng = np.random.default_rng(0)
    for density in (0.0, 0.3, 0.6, 1.0):
        for _ in range(4):
            mask = rng.random(8) < density
            lanes, over = prog.lane_slate(torch.from_numpy(mask))
            want = np.flatnonzero(mask)[:5]
            want = np.concatenate([want, np.full(5 - len(want), 8)])
            assert lanes.idx.tolist() == want.tolist()
            assert lanes.flow.tolist() == np.minimum(want, 7).tolist()
            assert int(over) == int(mask.sum() > 5)
            assert lanes.src.tolist() == prog.src[lanes.flow.long()].tolist()
    assert lanes.idx.dtype == torch.int32 and lanes.idx.is_contiguous()


def test_infer1024_trace_matches_the_jax_trace():
    """``profile.infer1024_scenario`` and the reference files' JAX trace
    (``torch_parity.jax_infer1024``) are one trace."""
    jsc, tsc = jax_infer1024(), infer1024_scenario()
    assert [dataclasses.astuple(m) for m in jsc.messages] == \
        [dataclasses.astuple(m) for m in tsc.messages]
    assert len(tsc.messages) == 4096
