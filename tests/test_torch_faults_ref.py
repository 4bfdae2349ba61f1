"""The full-width chaos runs: the committed JAX-made reference files and
the port on the CPU against them.

``perm1024`` (``full_bisection(32, 32)``, 64 KiB, 400 Gbps, seed 0) under
the ``CHAOS1024`` schedule (one entry of each of the six fault classes,
``tests/torch_parity.py``) with STrack over lossy queues and with RoCEv2
over PFC, and ``linkdown1024`` (128 dead uplinks of 16 ToRs) as t=0 uplink
flaps on the fabric with every link alive.  Each file is rebuilt from the
JAX package and must equal the committed one; the port, run through
``run_fabric_trace`` on the CPU, must equal it on every key: FCTs,
recovery and chaos counters, the flap windows' retransmits, the per-row
injections, warp trips, end tick and every done tick.  (``chip_smoke.py``
holds the port on the card against the same files.)
"""
import dataclasses
import json

import pytest

from repro_torch.core.params import NetworkSpec
from repro_torch.sim.fabric import run_fabric_trace, summarize
from repro_torch.sim.faults import FaultSpec, faults_from_dead_links
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import (RunConfig, _fabric_cfg,
                                       _scenario_ticks, linkdown_scenario,
                                       permutation_scenario)

from torch_parity import (CHAOS1024, CHAOS_REF_PATHS, CHAOS_REFS,
                          CHAOS_SUMMARY_KEYS, chaos_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

NET400 = NetworkSpec(link_gbps=400.0)


def chaos_run(name):
    """(scenario, RunConfig) of one ``CHAOS_REFS`` entry in the port."""
    _, kw, source = CHAOS_REFS[name]
    t32 = full_bisection(32, 32)
    if source == "chaos":
        sc = permutation_scenario(t32, 64 * 2 ** 10, net=NET400, seed=0)
        return sc, RunConfig(faults=FaultSpec(**CHAOS1024), **kw)
    dead = linkdown_scenario({"n_tor": 32, "hosts_per_tor": 32}, 0.125,
                             64 * 2 ** 10, net=NET400)
    return (dataclasses.replace(dead, topo=t32),
            RunConfig(faults=faults_from_dead_links(dead.topo), **kw))


@pytest.mark.parametrize("name", sorted(CHAOS_REFS))
def test_chaos_reference_file_is_what_jax_computes(name):
    ref = json.loads(CHAOS_REF_PATHS[name].read_text())
    assert ref == chaos_reference(name)
    assert ref["unfinished"] == 0
    want = {"perm1024_chaos_strack": (31, 9, 240),
            "perm1024_chaos_rocev2": (36, 30, 377),
            "linkdown1024_strack": (0, 0, 105)}[name]
    assert (ref["blackholed_pkts"], ref["corrupt_drops"],
            ref["warp_trips"]) == want


@pytest.mark.parametrize("name", sorted(CHAOS_REFS))
def test_port_matches_chaos_reference_on_cpu(name):
    ref = json.loads(CHAOS_REF_PATHS[name].read_text())
    sc, cfg = chaos_run(name)
    n_ticks = _scenario_ticks(sc, cfg)
    assert n_ticks == ref["n_ticks"]
    _, m = run_fabric_trace(sc.topo, sc.messages, n_ticks,
                            _fabric_cfg(sc, cfg), device="cpu")
    s = summarize(m)
    assert m["warp_trips"] == ref["warp_trips"]
    assert m["end_tick"] == ref["end_tick"]
    assert [int(v) for v in m["done_tick"]] == ref["done_tick"]
    for k in CHAOS_SUMMARY_KEYS:
        got = list(s[k]) if isinstance(s[k], tuple) else s[k]
        if isinstance(ref[k], float):
            assert got == pytest.approx(ref[k], rel=1e-6), k
        else:
            assert got == ref[k], k


def test_linkdown1024_t0_schedule_equals_the_native_dead_links():
    """As t=0 uplink flaps linkdown1024 equals the natively dead-linked
    run on every summary key (the JAX package's run; the port's equals the
    reference file above)."""
    from repro.sim.workloads import RunConfig as JRunConfig
    from repro.sim.workloads import _fabric_cfg as j_fabric_cfg
    from repro.sim.workloads import _scenario_ticks as j_scenario_ticks
    from repro.sim.fabric import run_fabric_trace as j_run_fabric_trace
    from repro.sim.fabric import summarize as j_summarize
    from torch_parity import jax_linkdown1024
    ref = json.loads(CHAOS_REF_PATHS["linkdown1024_strack"].read_text())
    sc, cfg = jax_linkdown1024(), JRunConfig()
    n_ticks = j_scenario_ticks(sc, cfg)
    _, m = j_run_fabric_trace(sc.topo, sc.messages, n_ticks,
                              j_fabric_cfg(sc, cfg))
    s = j_summarize(m)
    assert len(sc.topo.dead_links) == 128
    assert n_ticks == ref["n_ticks"]
    assert int(m["warp_trips"]) == ref["warp_trips"]
    for k in CHAOS_SUMMARY_KEYS:
        if k == "win_retx":   # no flap windows natively
            continue
        got = list(s[k]) if isinstance(s[k], tuple) else s[k]
        assert got == ref[k], k
