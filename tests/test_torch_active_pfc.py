"""The active set's PFC branches, a fault schedule under the cap, and a
capped JAX state resumed by the port, against the JAX reference.

Every ``FabricState`` leaf after 1, 2, 8, 40 and 200 dense ticks, bit for
bit (the queue rings to their real rows):

* the 15-sender STrack + PFC incast of ``tests/test_torch_pfc.py`` (2 us
  network, 200 KB buffer) with its senders staggered by three ticks of
  arrival, and a 16th message that arrives after the horizon, at a cap of
  15 of 16: probes of paused NICs are withheld with their timer state and
  the host ingress counters sum the lanes' injections;
* ``tests/test_torch_active_state.py``'s open-loop trace at a cap of 32
  under a link flap (ToR 2 - spine 0, ticks 10-60) and a host flap (host
  8, ticks 30-80), STrack and RoCEv2 + PFC.

And the PFC stage's ingress sums do not depend on the order of the lanes:
wire sizes are whole numbers, so every partial sum below 2^24 is exact.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import faults as JFa
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import Message as JMessage
from repro.sim.workloads import incast_scenario as j_incast

from repro_torch.core.params import NetworkSpec
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.sim import fabric as TF
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection

from torch_parity import (diff_leaves, jax_final_state, open_loop_trace,
                          port_program)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
JNET2 = JNet(link_gbps=400.0, base_rtt_us=2.0)
TNET2 = NetworkSpec(link_gbps=400.0, base_rtt_us=2.0)
Q_ROWS = 3 * 16
SCHEDULE = dict(link_flaps=((2, 0, 10, 60),), host_flaps=((8, 30, 80),),
                seed=3)


def incast15_staggered():
    """15 senders of 512 KiB into host 0 on ``full_bisection(4, 4)``,
    sender i arriving at tick 3 i, and a 4 KiB message 1 -> 2 arriving at
    tick 1000: N = 16, at most 15 live before tick 1000."""
    msgs = j_incast(j_full_bisection(4, 4), 15, 512 * 2 ** 10,
                    net=JNET2).messages
    return tuple(dataclasses.replace(m, arrival=3 * i)
                 for i, m in enumerate(msgs)) + (
        JMessage(mid=15, src=1, dst=2, size=4096.0, arrival=1000),)


#: case -> (trace, FabricConfig fields of JAX, of the port, active_cap)
CASES = {
    "incast15_strack_pfc": (
        incast15_staggered,
        dict(net=JNET2, pfc=True, switch_buffer_bytes=2e5),
        dict(net=TNET2, pfc=True, switch_buffer_bytes=2e5), 15),
    "faults_strack": (
        open_loop_trace, dict(net=JNET, faults=JFa.FaultSpec(**SCHEDULE)),
        dict(net=TNET, faults=TFa.FaultSpec(**SCHEDULE)), 32),
    "faults_rocev2_pfc": (
        open_loop_trace,
        dict(net=JNET, protocol="rocev2", faults=JFa.FaultSpec(**SCHEDULE)),
        dict(net=TNET, protocol="rocev2", faults=TFa.FaultSpec(**SCHEDULE)),
        32),
}


def _cfgs(case):
    _, jkw, tkw, cap = CASES[case]
    common = dict(time_warp=False, trace_every=0, active_cap=cap)
    return JF.FabricConfig(**common, **jkw), TF.FabricConfig(**common, **tkw)


def _jax(case, k):
    return jax_final_state(j_full_bisection(4, 4), CASES[case][0](), k,
                           _cfgs(case)[0])


def _program(case, n_ticks):
    return port_program(full_bisection(4, 4), CASES[case][0](), n_ticks,
                        _cfgs(case)[1])


@functools.lru_cache(maxsize=None)
def _port(case, k):
    return _program(case, k).run()[0]


@pytest.mark.parametrize("k", [1, 2, 8, 40, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_capped_state_equals_jax(case, k):
    jfin, tfin = _jax(case, k), _port(case, k)
    bad = diff_leaves(jfin, tfin, ring_rows=Q_ROWS)
    assert not bad, f"{case}: first diverging leaves after {k} ticks: " \
                    f"{bad[:5]}"
    if k < 200:
        return
    assert int(tfin.act_overflow) == 0
    if case == "incast15_strack_pfc":
        assert int(tfin.pauses) > 0 and bool(tfin.paused_nic.any())
    else:
        assert int(tfin.blackholed) > 0


def test_probes_of_paused_nics_are_withheld_under_the_cap():
    """The capped incast reaches the active transition's PFC probe gate:
    at timer ticks before 200 lanes of paused NICs have probes due
    (withheld, with their timer state) and other NICs' winners are held
    back; and the PFC stage's host ingress, summed over the lanes, does
    not depend on the lanes' order."""
    prog = _program("incast15_strack_pfc", 200)
    st = prog.init_state()
    blocked = withheld = orders = 0
    for t in range(200):
        eff_nic, prow = prog.eff_pause(st, t)
        mask = (prog.sendable_msg(st, t)[prog.dep.msg_of_flow.long()]
                & ~prog.proto.done(st.flows))
        lanes, _ = prog.lane_slate(mask)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic,
                                    lanes)
        flows = TF._clone_tree(targs[0])
        _, tx, ptx, pv, sel, can, _ = fk.flow_transition_active_plain(
            flows, *targs[1:])
        paused = eff_nic[lanes.src.long()] & (lanes.idx < prog.N)
        blocked += int((ptx.valid & paused).sum())
        withheld += int((can & paused & ~sel).sum())
        assert not (pv & paused).any()
        if t % 20 == 7:
            orders += _ingress_order_free(prog, st, t, lanes, tx, ptx, pv,
                                          sel, prow)
        st, _, _ = prog.tick(st, t)
    assert blocked > 0 and withheld > 0 and orders > 0


def _ingress_order_free(prog, st, t, lanes, tx, ptx, pv, sel, prow) -> int:
    """The PFC stage's host ingress counters at tick ``t`` equal the same
    sums taken over the lanes in reverse order, bit for bit, and are whole
    numbers below 2^24.  Returns the injections summed."""
    sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow, None, lanes)
    ring = TF._clone_tree(st.q)
    res = fk.serve_enqueue_plain(ring, *sargs[1:])
    qid, accept, cand_bytes = res[6], res[7], res[9]
    out = fk.pfc_account_plain(prog.pfc_state(st), res[3], res[2], res[5],
                               qid, cand_bytes, accept, ring, res[0],
                               st.qsize, res[1], t, prog.pfc_flows,
                               prog.pfc_dims, lanes.idx)
    TS, L = prog.TS, lanes.idx.shape[0]
    inj = torch.cat([accept[2 * TS:2 * TS + L], accept[2 * TS + L:]])
    src = torch.cat([lanes.src, lanes.src])
    b = torch.cat([cand_bytes[2 * TS:2 * TS + L], cand_bytes[2 * TS + L:]])
    # the same counters with the injections added in reverse lane order
    base = fk.pfc_account_plain(
        prog.pfc_state(st), res[3], res[2], res[5], qid,
        torch.where(torch.arange(qid.shape[0]) >= 2 * TS, 0.0, cand_bytes),
        accept, ring, res[0], st.qsize, res[1], t, prog.pfc_flows,
        prog.pfc_dims, lanes.idx).ing_host
    rev = base.clone()
    for i in reversed(range(inj.shape[0])):
        if inj[i]:
            rev[src[i].long()] += b[i]
    assert torch.equal(out.ing_host.view(torch.int32),
                       rev.view(torch.int32))
    v = out.ing_host.numpy()
    assert np.all(v == np.round(v)) and np.all(np.abs(v) < 2 ** 24)
    return int(inj.sum())


def test_port_resumes_a_capped_jax_state():
    """The JAX state after 40 capped ticks under the schedule (RoCEv2 over
    PFC), carried into the port (``convert.to_torch``: ``act_overflow``
    and the flap windows' counters included), ticked 40 more times by the
    port: every leaf equals the JAX state after 80 ticks."""
    from repro_torch.convert import to_torch
    j40, j80 = _jax("faults_rocev2_pfc", 40), _jax("faults_rocev2_pfc", 80)
    prog = _program("faults_rocev2_pfc", 80)
    st = to_torch(j40, TF.FabricState)
    assert tuple(st.act_overflow.shape) == () and prog.A == 32
    for t in range(40, 80):
        st, _, _ = prog.tick(st, t)
    bad = diff_leaves(j80, st, ring_rows=prog.Q)
    assert not bad, bad[:5]
    assert int(st.blackholed) > int(j40.blackholed)
