"""The port's fabric main path (repro_torch.sim) end to end on the CPU.

Goldens ``perm16_strack`` / ``incast8_strack`` through the port's
``run()``; the event-horizon loop against dense ticking inside the port
(the reference's tests/test_timewarp.py contract); the committed perm1024
reference file rebuilt from the JAX package and matched by the port; the
committed incast1024 reference file rebuilt from the JAX package (the
port is held against it on the card by ``chip_smoke.py``: 1824 warp trips
at 1024 hosts are too many for this suite); and the loud refusal of
everything outside this slice.  (Whole-state parity
under other fabric options and the ECN dither grid:
``tests/test_torch_fabric_state.py``.)
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim.faults import link_flap
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import (Message, RunConfig, Scenario,
                                       _fabric_cfg, _scenario_ticks,
                                       incast_scenario, permutation_scenario,
                                       run, sweep)

from torch_parity import (INCAST_REF_PATH, REF_PATH, incast1024_reference,
                          perm1024_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

NET400 = NetworkSpec(link_gbps=400.0)
TOPO44 = full_bisection(4, 4)
GOLDEN = {
    "perm16_strack": lambda: permutation_scenario(TOPO44, 256 * 2 ** 10,
                                                  net=NET400, seed=0),
    "incast8_strack": lambda: incast_scenario(TOPO44, 8, 512 * 2 ** 10,
                                              net=NET400),
}


def _perm1024():
    return permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                                net=NET400, seed=0)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_through_the_port(case, golden_dir):
    got = run(GOLDEN[case](), RunConfig(), device="cpu")
    want = json.loads((golden_dir / f"{case}.json").read_text())
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-6), (case, k)
        else:
            assert got[k] == v, (case, k, got[k], v)


def test_warp_equals_dense_in_the_port():
    sc = GOLDEN["perm16_strack"]()
    ticks = 800
    out = []
    for warp in (False, True):
        cfg = TF.FabricConfig(net=sc.net, time_warp=warp, trace_every=0)
        final, m = TF.run_fabric_trace(sc.topo, sc.messages, ticks, cfg,
                                       device="cpu")
        out.append((final, m))
    (fd, md), (fw, mw) = out
    np.testing.assert_array_equal(md["done_tick"], mw["done_tick"])
    assert md["fct_us"] == mw["fct_us"]
    assert md["drops"] == mw["drops"] and md["ecn_marks"] == mw["ecn_marks"]
    assert mw["warp_trips"] < ticks // 2
    assert torch.equal(fd.flows.cc.cwnd, fw.flows.cc.cwnd)


def test_perm1024_reference_file_is_what_jax_computes():
    assert json.loads(REF_PATH.read_text()) == perm1024_reference()


def test_incast1024_reference_file_is_what_jax_computes():
    ref = json.loads(INCAST_REF_PATH.read_text())
    assert ref == incast1024_reference()
    assert ref["drops"] > 0 and ref["ecn_marks"] > 0
    assert ref["sack_recoveries"] > 0 and ref["unfinished"] == 0


def test_port_matches_perm1024_reference_on_cpu():
    ref = json.loads(REF_PATH.read_text())
    sc = _perm1024()
    cfg = RunConfig()
    n_ticks = _scenario_ticks(sc, cfg)
    _, m = TF.run_fabric_trace(sc.topo, sc.messages, n_ticks,
                               _fabric_cfg(sc, cfg), device="cpu")
    s = TF.summarize(m)
    assert n_ticks == ref["n_ticks"]
    assert m["warp_trips"] == ref["warp_trips"]
    assert m["end_tick"] == ref["end_tick"]
    assert [int(v) for v in m["done_tick"]] == ref["done_tick"]
    for k in ("unfinished", "drops", "ecn_marks", "pauses", "retransmits",
              "rto_fires", "sack_recoveries", "qdepth_max_pkts"):
        assert s[k] == ref[k], k
    for k in ("max_fct", "avg_fct"):
        assert s[k] == pytest.approx(ref[k], rel=1e-6), k


@pytest.mark.parametrize("kw,item", [
    # sub-flow striping (A6) and the trace (A5) run; what they are
    # combined with still raises
    (dict(protocol="rocev2", subflows=2, shard=2), "A11"),
    (dict(pfc=True, subflows=4, trace_every=1, backend="events"), "A10"),
    (dict(active_cap=8, backend="events"), "A10"),
    (dict(shard=2), "A11"),
    (dict(subflows=4, backend="events"), "A10"),
    (dict(faults=link_flap(0, 0, 10, 60), trace_queues=True, shard=1,
          backend="events"), "A10"),
    (dict(lb_mode="oblivious", subflows=2, shard=4), "A11"),
    (dict(backend="events"), "A10"),
])
def test_unported_settings_raise_naming_their_roadmap_item(kw, item):
    sc = permutation_scenario(full_bisection(2, 2), 8192, net=NET400)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run(sc, RunConfig(**kw), device="cpu")


def test_dependency_edges_and_sweep_raise():
    """Dependency edges run (A6): the child starts after its parent is
    done, and the run reports the collective keys; ``sweep`` runs too
    (A5): a batch of one, whose row is ``run``'s."""
    topo = full_bisection(2, 2)
    sc = Scenario(name="chain", topo=topo, net=NET400, messages=(
        Message(mid=0, src=0, dst=1, size=8192.0),
        Message(mid=1, src=1, dst=2, size=8192.0, deps=(0,))))
    _, m = TF.run_fabric_trace(topo, sc.messages, 400,
                               TF.FabricConfig(net=NET400, time_warp=True),
                               device="cpu")
    release, fct = m["msg_release_us"], m["fct_us"]
    assert release[0] == 0.0 and release[1] >= fct[0]
    s = TF.summarize(m)
    assert s["unfinished"] == 0 and s["finished_groups"] == 1
    assert s["max_collective_time"] == release[1] + fct[1]
    rows = sweep([sc], RunConfig(n_ticks=400), device="cpu")
    assert rows == [run(sc, RunConfig(n_ticks=400), device="cpu")]
    assert rows[0]["finished_groups"] == 1
