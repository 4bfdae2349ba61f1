"""The active set on dependency-scheduled traces in the port.

* The reference's dependency-chained active-set cases
  (``tests/test_rank_active.py``): four messages, then four that each wait
  for one of the first, on ``full_bisection(2, 4)``.  Under STrack,
  RoCEv2 + PFC and STrack under time warp the port at caps 5 and 4
  equals the port uncapped and JAX at the same cap on every summary key
  (the per-group table among them), every done tick and the warp trips;
  cap 2 raises with JAX's tick count.  The slate of a capped tick is
  built from the tick's input mask: a child joins it the tick after its
  parent completes.
* allreduce8k's spot cell (``benchmarks/perf.py``: two HD allreduces of 8
  ranks on ``full_bisection(4, 4)`` at 100 Gbps) at ``active_cap=48``:
  the JAX-made file ``allreduce8k_spot_cap48_ref.json`` is rebuilt from
  JAX and must equal the committed one, and the port's run on the CPU
  equals it on every key, done tick and message tick.
"""
import json

import numpy as np
import pytest

from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import Message as JMessage

from repro_torch.profile import (ALLREDUCE8K_SPOT_CAP,
                                 allreduce8k_spot_scenario)
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import (Message, RunConfig, _fabric_cfg,
                                       _scenario_ticks)

from torch_parity import (COLLECTIVE_REF_PATHS, COLLECTIVE_SUMMARY_KEYS,
                          chain_trace, collective_reference, overflow_ticks,
                          port_program)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: dense runs end here: the chained trace is done by tick 215
DENSE_TICKS = 300
#: proto -> FabricConfig fields of both packages
PROTOS = {"strack": dict(), "rocev2_pfc": dict(protocol="rocev2", pfc=True),
          "strack_warp": dict(time_warp=True)}


def _ticks(kw):
    return 9000 if kw.get("time_warp") else DENSE_TICKS


def _jax_run(kw, cap):
    cfg = JF.FabricConfig(active_cap=cap, trace_every=0, **kw)
    return JF.run_fabric_trace(j_full_bisection(2, 4), chain_trace(JMessage),
                               _ticks(kw), cfg)[1]


def _port_run(kw, cap):
    cfg = TF.FabricConfig(active_cap=cap, trace_every=0, **kw)
    return TF.run_fabric_trace(full_bisection(2, 4), chain_trace(Message),
                               _ticks(kw), cfg, device="cpu")[1]


def _same_run(a, b):
    sa, sb = JF.summarize(a), TF.summarize(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k] == sb[k], k
    assert np.array_equal(np.asarray(a["done_tick"]), b["done_tick"])
    assert a["fct_us"] == b["fct_us"]
    assert a["msg_release_us"] == b["msg_release_us"]
    assert a["group_done_us"] == b["group_done_us"]
    assert a.get("warp_trips") == b.get("warp_trips")


@pytest.mark.parametrize("proto", sorted(PROTOS))
def test_chained_capped_runs_equal_uncapped_and_jax(proto):
    kw = PROTOS[proto]
    base = _port_run(kw, None)
    s = TF.summarize(base)
    assert s["total_groups"] == s["finished_groups"] == 2
    assert min(base["msg_release_us"][4:]) > 0.0
    for cap in (5, 4):
        capped = _port_run(kw, cap)
        _same_run(base, capped)
        _same_run(_jax_run(kw, cap), capped)


@pytest.mark.parametrize("proto", sorted(PROTOS))
def test_chained_small_cap_raises_with_jax_tick_count(proto):
    kw = PROTOS[proto]
    with pytest.raises(RuntimeError, match="active_cap=2 exceeded") as j:
        _jax_run(kw, 2)
    with pytest.raises(RuntimeError, match="active_cap=2 exceeded") as t:
        _port_run(kw, 2)
    assert overflow_ticks(t.value) == overflow_ticks(j.value) > 0


def test_a_child_joins_the_slate_the_tick_after_its_parent_completes():
    cfg = TF.FabricConfig(active_cap=5, trace_every=0)
    prog = port_program(full_bisection(2, 4), chain_trace(Message),
                        DENSE_TICKS, cfg)
    st, joined = prog.init_state(), 0
    for t in range(DENSE_TICKS):
        mask = (prog.sendable_msg(st, t)[prog.dep.msg_of_flow.long()]
                & ~prog.proto.done(st.flows))
        lanes, _ = prog.lane_slate(mask)
        new, _, _ = prog.tick(st, t)
        for child in range(4, 8):   # released by this tick's completions
            if int(new.pending[child]) == 0 < int(st.pending[child]):
                assert child not in lanes.idx.tolist()
                nxt = prog.lane_slate(
                    prog.sendable_msg(new, t + 1)[prog.dep.msg_of_flow.long()]
                    & ~prog.proto.done(new.flows))[0]
                assert child in nxt.idx.tolist()
                joined += 1
        st = new
    assert joined == 4


def test_allreduce8k_spot_cell_equals_its_jax_file():
    path = COLLECTIVE_REF_PATHS["allreduce8k_spot_cap48"]
    ref = json.loads(path.read_text())
    assert ref == collective_reference("allreduce8k_spot_cap48")
    sc, cfg = (allreduce8k_spot_scenario(),
               RunConfig(active_cap=ALLREDUCE8K_SPOT_CAP))
    n_ticks = _scenario_ticks(sc, cfg)
    assert n_ticks == ref["n_ticks"] and len(sc.messages) == ref["n_msgs"]
    final, m = TF.run_fabric_trace(sc.topo, sc.messages, n_ticks,
                                   _fabric_cfg(sc, cfg), device="cpu")
    s = json.loads(json.dumps(TF.summarize(m)))
    for k in COLLECTIVE_SUMMARY_KEYS:
        assert s[k] == ref[k], k
    assert (m["warp_trips"], m["end_tick"]) == (ref["warp_trips"],
                                                ref["end_tick"])
    assert [int(v) for v in m["done_tick"]] == ref["done_tick"]
    for k in ("msg_release_tick", "msg_done_tick"):
        assert getattr(final, k).tolist() == ref[k], k
    assert ref["unfinished"] == 0 and ref["total_groups"] == 2
    assert ref["n_flows"] > ALLREDUCE8K_SPOT_CAP
