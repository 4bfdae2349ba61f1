"""The port's fabric state under RoCEv2 and PFC against the JAX reference.

Every ``FabricState`` leaf after 1, 2, 8, 40 and 200 dense ticks, bit for
bit (the queue rings to their real rows):

* 4x4 and 8x16 permutations under RoCEv2 (PFC on, the default);
* incast8 under RoCEv2 + PFC with a 200 KB switch buffer, so that pauses
  are frequent: from tick 21 paused NICs hold back offers;
* incast8 under lossy RoCEv2 with a 4.1 us RTO (``RoCEParams.rto_us``),
  so that drops, RTO rewinds and resends all happen inside 200 ticks;
* incast8 under STrack + PFC with the same small buffer;
* an incast of 15 senders under STrack + PFC with the same small buffer
  on a network of 2 us base RTT (so that probes are due after 6 us of
  ACK silence): probes of paused NICs are withheld with their timer state
  from tick 80 on.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.params import NetworkSpec as JNet
from repro.core.params import make_roce_params as j_roce_params
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import incast_scenario as j_incast
from repro.sim.workloads import permutation_scenario as j_permutation

from repro_torch.core.params import NetworkSpec, make_roce_params
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection

from torch_parity import diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
JNET2 = JNet(link_gbps=400.0, base_rtt_us=2.0)
TNET2 = NetworkSpec(link_gbps=400.0, base_rtt_us=2.0)
SMALL_BUFFER = 2e5
#: The lossy case's RTO (us): the first RTO fires on the timer tick 56,
#: where fmaf(56, tick_us, 4.1) and the twice-rounded sum differ.
RTO_US = 4.1


def _roce_rto(make, net):
    return dataclasses.replace(make(net), rto_us=RTO_US)


#: case -> (scenario builder on the JAX package, topology shape, config
#: fields for the JAX FabricConfig, for the port's FabricConfig); the
#: networks are JNET / TNET unless the fields say otherwise
CASES = {
    "perm16_roce": (lambda: j_permutation(j_full_bisection(4, 4),
                                          256 * 2 ** 10, net=JNET, seed=0),
                    (4, 4), dict(protocol="rocev2"), dict(protocol="rocev2")),
    "perm_8x16_roce": (lambda: j_permutation(j_full_bisection(8, 16),
                                             64 * 2 ** 10, net=JNET, seed=0),
                       (8, 16), dict(protocol="rocev2"),
                       dict(protocol="rocev2")),
    "incast8_roce_pfc": (
        lambda: j_incast(j_full_bisection(4, 4), 8, 512 * 2 ** 10, net=JNET),
        (4, 4), dict(protocol="rocev2", switch_buffer_bytes=SMALL_BUFFER),
        dict(protocol="rocev2", switch_buffer_bytes=SMALL_BUFFER)),
    "incast8_roce_lossy": (
        lambda: j_incast(j_full_bisection(4, 4), 8, 512 * 2 ** 10, net=JNET),
        (4, 4),
        dict(protocol="rocev2", pfc=False,
             roce=_roce_rto(j_roce_params, JNET)),
        dict(protocol="rocev2", pfc=False,
             roce=_roce_rto(make_roce_params, TNET))),
    "incast8_strack_pfc": (
        lambda: j_incast(j_full_bisection(4, 4), 8, 512 * 2 ** 10, net=JNET),
        (4, 4), dict(pfc=True, switch_buffer_bytes=SMALL_BUFFER),
        dict(pfc=True, switch_buffer_bytes=SMALL_BUFFER)),
    "incast15_strack_pfc_rtt2": (
        lambda: j_incast(j_full_bisection(4, 4), 15, 512 * 2 ** 10,
                         net=JNET2),
        (4, 4), dict(net=JNET2, pfc=True, switch_buffer_bytes=SMALL_BUFFER),
        dict(net=TNET2, pfc=True, switch_buffer_bytes=SMALL_BUFFER)),
}


def _run_both(case, k):
    make, (tors, hpt), jkw, tkw = CASES[case]
    jsc = make()
    jfin, _ = JF.run_fabric_trace(
        jsc.topo, jsc.messages, k,
        JF.FabricConfig(time_warp=False, trace_every=0, **{"net": JNET, **jkw}))
    topo = full_bisection(tors, hpt)
    tfin, _ = TF.run_fabric_trace(
        topo, jsc.messages, k,
        TF.FabricConfig(time_warp=False, trace_every=0, **{"net": TNET, **tkw}),
        device="cpu")
    q_rows = 2 * topo.n_tor * topo.n_spine + topo.n_hosts
    return jfin, tfin, q_rows


@pytest.mark.parametrize("k", [1, 2, 8, 40, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fabric_state_equals_jax(case, k):
    jfin, tfin, q_rows = _run_both(case, k)
    bad = diff_leaves(jfin, tfin, ring_rows=q_rows)
    assert not bad, f"{case}: first diverging leaves after {k} ticks: " \
                    f"{bad[:5]}"
    if k < 200:
        return
    # the branches each case is there for
    if case == "incast8_roce_pfc":
        assert int(tfin.pauses) > 0 and bool(tfin.paused_nic.any())
        assert int(tfin.flows.rto_fires.sum()) == 0
    elif case == "incast8_roce_lossy":
        assert int(tfin.drops) > 0 and int(tfin.pauses) == 0
        assert int(tfin.flows.rto_fires.sum()) > 0
        assert int(tfin.flows.retransmits.sum()) > 0
    elif "strack" in case:
        assert int(tfin.pauses) > 0
    elif case.startswith("perm"):
        assert int(tfin.drops) == 0 and int(tfin.delivered.sum()) > 0


def test_rto_rearm_is_a_plain_add_in_the_fabric_program():
    """The lossy incast's RTOs fire at tick 56, where ``fmaf(t, tick_us,
    rto_us)`` and the twice-rounded sum differ: inside the fabric program
    the reference adds (as ``roce_on_timer`` jitted on its own does,
    ``test_torch_roce.py``), and the port matches it."""
    from repro_torch.numerics import Now, now_plus
    jfin, tfin, q_rows = _run_both("incast8_roce_lossy", 60)
    assert not diff_leaves(jfin, tfin, ring_rows=q_rows)
    fired = np.asarray(jfin.flows.rto_fires) > 0
    assert fired.sum() >= 4
    tick = TNET.mtu_serialize_us
    fused = np.float32(now_plus(Now(56, tick), RTO_US))
    plain = np.float32(np.float32(56) * np.float32(tick)) + np.float32(RTO_US)
    assert fused != plain
    assert (np.asarray(jfin.flows.rto_deadline)[fired] == plain).all()


def test_strack_pfc_case_withholds_probes_of_paused_nics():
    """The 15-sender STrack + PFC case reaches the transition's PFC probe
    gate: at timer ticks before 200, flows of paused NICs have probes due
    (withheld, with their timer state) and other NICs' winners are held
    back."""
    from repro_torch.kernels.fabric_kernels import flow_transition_plain
    from repro_torch.sim.workloads import Scenario
    make, (tors, hpt), _, tkw = CASES["incast15_strack_pfc_rtt2"]
    jsc = make()
    sc = Scenario(name="incast15", topo=full_bisection(tors, hpt), net=TNET2,
                  messages=jsc.messages)
    cfg = TF.FabricConfig(time_warp=False, trace_every=0, **tkw)
    prog = TF.FabricProgram(sc.topo, len(sc.messages), 200, cfg, "cpu")
    src, dst, total, tails, ent0 = TF._flow_arrays(sc.flows, cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(sc.messages),
              cfg.lb_mode, ent0)
    st = prog.init_state()
    blocked = withheld = 0
    for t in range(200):
        eff_nic, _ = prog.eff_pause(st, t)
        args = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic)
        _, _, ptx, pv, sel, can = flow_transition_plain(*args)
        paused = eff_nic[prog.src.long()]
        blocked += int((ptx.valid & paused).sum())
        withheld += int((can & paused & ~sel).sum())
        assert not (pv & paused).any()
        st, _, _ = prog.tick(st, t)
    assert blocked > 0 and withheld > 0
