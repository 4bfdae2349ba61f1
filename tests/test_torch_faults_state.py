"""The port's fabric state under a fault schedule against the JAX
reference.

Every ``FabricState`` leaf after 1, 2, 8, 40 and 200 dense ticks, bit for
bit (the queue rings to their real rows), on a 4x4 permutation (128 KiB,
400 Gbps) under the reference's ``MIXED`` schedule (a link flap, a host
flap, a degraded link, a corrupting link) plus an uplink flap and a
corrupting host link, so that every fault class is live at once: STrack
with adaptive and with oblivious spray over lossy queues, and RoCEv2 over
PFC.  And a faulted JAX state carried into the port (``convert``) ticks
on to JAX's state.  (Warp against dense ticking under faults:
``tests/test_torch_faults_warp.py``.)
"""
import pytest

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import faults as JFa
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import permutation_scenario as j_permutation

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection

from torch_parity import diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
#: ``MIXED`` of tests/test_faults.py, an uplink flap and a host_corrupt.
SCHEDULE = dict(link_flaps=((0, 0, 10, 60),), uplink_flaps=((1, 2, 5, 120),),
                host_flaps=((5, 30, 80),),
                link_degrade=((1, 1, 0, 200, 0.5),),
                link_corrupt=((2, 2, 0, 300, 0.05),),
                host_corrupt=((7, 0, 300, 0.2),), seed=3)
CASES = {"strack": dict(), "strack_oblivious": dict(lb_mode="oblivious"),
         "rocev2_pfc": dict(protocol="rocev2")}
Q_ROWS = 3 * 16


def _jax(kw, k):
    jsc = j_permutation(j_full_bisection(4, 4), 128 * 2 ** 10, net=JNET,
                        seed=0)
    cfg = JF.FabricConfig(net=JNET, time_warp=False, trace_every=0,
                          faults=JFa.FaultSpec(**SCHEDULE), **kw)
    return jsc, JF.run_fabric_trace(jsc.topo, jsc.messages, k, cfg)[0]


def _port_cfg(kw):
    return TF.FabricConfig(net=TNET, time_warp=False, trace_every=0,
                           faults=TFa.FaultSpec(**SCHEDULE), **kw)


@pytest.mark.parametrize("k", [1, 2, 8, 40, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fabric_state_under_faults_equals_jax(case, k):
    jsc, jfin = _jax(CASES[case], k)
    tfin, _ = TF.run_fabric_trace(full_bisection(4, 4), jsc.messages, k,
                                  _port_cfg(CASES[case]), device="cpu")
    bad = diff_leaves(jfin, tfin, ring_rows=Q_ROWS)
    assert not bad, f"{case}: first diverging leaves after {k} ticks: " \
                    f"{bad[:5]}"
    if k == 200:   # the branches the schedule is there for
        assert int(tfin.blackholed) > 0 and int(tfin.corrupt_drops) > 0
        assert tuple(tfin.win_retx.shape) == (3,)
        if case == "rocev2_pfc":
            assert int(tfin.win_retx.sum()) > 0


def test_port_resumes_a_faulted_jax_state():
    """The JAX state after 40 ticks under the schedule (RoCEv2 over PFC),
    carried into the port (``convert.to_torch``, ``win_retx`` of the three
    flap windows included), ticked 40 more times by the port: every leaf
    equals the JAX state after 80 ticks."""
    from repro_torch.convert import to_torch
    kw = CASES["rocev2_pfc"]
    jsc, j40 = _jax(kw, 40)
    _, j80 = _jax(kw, 80)
    cfg = _port_cfg(kw)
    topo = full_bisection(4, 4)
    prog = TF.FabricProgram(topo, len(jsc.messages), 80, cfg, "cpu")
    flows = [(m.src, m.dst, m.size) for m in jsc.messages]
    src, dst, total, tails, ent0 = TF._flow_arrays(flows, cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(jsc.messages),
              cfg.lb_mode, ent0)
    st = to_torch(j40, TF.FabricState)
    assert tuple(st.win_retx.shape) == (3,) and int(st.blackholed) > 0
    for t in range(40, 80):
        st, _, _ = prog.tick(st, t)
    bad = diff_leaves(j80, st, ring_rows=prog.Q)
    assert not bad, bad[:5]
    assert int(st.corrupt_drops) > int(j40.corrupt_drops)
