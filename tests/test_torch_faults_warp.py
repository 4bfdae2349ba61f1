"""Warp against dense ticking in the port under a fault schedule.

The reference's ``MIXED`` schedule (a link flap, a host flap, a degraded
link, a corrupting link) on a 4x4 permutation (128 KiB, 400 Gbps): warp
trips must wake at every fault edge, so the event-horizon loop equals
dense ticking on every summary key, the flap windows' retransmits and the
per-row injections included, and equals JAX's warp run.  STrack finishes
by tick ~340: port dense, port warp and JAX warp over 1000 ticks.  RoCEv2
finishes after an RTO at tick ~5200: port dense against port warp over
the first 3000 ticks (losses, go-back-N), and the port's warp over 6000
ticks against JAX's dense and warp runs (the RTO and the drain).
"""
import pytest

from repro.core.params import NetworkSpec as JNet
from repro.sim import faults as JFa
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import RunConfig as JRunConfig
from repro.sim.workloads import permutation_scenario as j_permutation
from repro.sim.workloads import run as j_run

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import RunConfig, permutation_scenario, run

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
#: The reference's mixed schedule (tests/test_faults.py).
MIXED = dict(link_flaps=((0, 0, 10, 60),), host_flaps=((5, 30, 80),),
             link_degrade=((1, 1, 0, 200, 0.5),),
             link_corrupt=((2, 2, 0, 300, 0.05),), seed=3)
#: Summary keys every execution must agree on.
EXACT_KEYS = ("max_fct", "avg_fct", "unfinished", "drops", "pauses",
              "retransmits", "rto_fires", "sack_recoveries", "gbn_rewinds",
              "blackholed_pkts", "corrupt_drops", "ecn_marks",
              "tx_rows_pkts", "win_retx")


def _port(protocol, n_ticks, warp):
    sc = permutation_scenario(full_bisection(4, 4), 128 * 2 ** 10, net=TNET,
                              seed=0)
    return run(sc, RunConfig(protocol=protocol, n_ticks=n_ticks,
                             time_warp=warp, faults=TFa.FaultSpec(**MIXED)),
               device="cpu")


def _jax(protocol, n_ticks, warp):
    sc = j_permutation(j_full_bisection(4, 4), 128 * 2 ** 10, net=JNET,
                       seed=0)
    return j_run(sc, JRunConfig(protocol=protocol, n_ticks=n_ticks,
                                time_warp=warp,
                                faults=JFa.FaultSpec(**MIXED)))


@pytest.mark.parametrize("protocol,n_ticks,dense", [
    ("strack", 1000, "port"), ("rocev2", 3000, "port"),
    ("rocev2", 6000, "jax")])
def test_warp_equals_dense_under_mixed_faults(protocol, n_ticks, dense):
    base = (_port if dense == "port" else _jax)(protocol, n_ticks, False)
    warp = _port(protocol, n_ticks, True)
    jwarp = _jax(protocol, n_ticks, True)
    for k in EXACT_KEYS:
        assert base[k] == warp[k] == jwarp[k], (protocol, n_ticks, k)
    assert warp["warp_trips"] == jwarp["warp_trips"] < n_ticks // 2
    assert warp["end_tick"] == jwarp["end_tick"] == n_ticks
    assert base["blackholed_pkts"] > 0 and sum(base["win_retx"]) > 0
    if protocol == "strack":   # RoCEv2's one path misses the 5% draws
        assert base["corrupt_drops"] > 0
    if n_ticks == 3000:
        assert base["gbn_rewinds"] > 0
    else:
        assert base["unfinished"] == 0
