"""The port's fabric state under the active set against the JAX
reference's capped program.

Every ``FabricState`` leaf (``act_overflow`` among them) after 1, 2, 8,
40 and 200 dense ticks, bit for bit (the queue rings to their real rows),
on an open-loop 4x4 trace: ``traffic.mixed_scenario`` of two inference
tenants, 40 flows of 16-80 KiB arriving over ticks 3-154, at most 32 of
them live at once:

* STrack with adaptive and with oblivious spray, and RoCEv2 over PFC, at
  a cap of 32, where the slate is full to its last lane at the peak and
  holds flow N-1 beside padded lanes from tick 154;
* STrack at a cap of 24, below the peak: the overflow ticks count up and
  the flows past the cap stall, as in the reference.

(PFC pauses and a fault schedule under the cap, and a capped JAX state
resumed by the port: ``tests/test_torch_active_pfc.py``.)
"""
import functools

import pytest
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection

from torch_parity import (diff_leaves, jax_final_state, open_loop_trace,
                          port_program)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
Q_ROWS = 3 * 16
#: case -> (FabricConfig fields of both packages, active_cap)
CASES = {"strack_cap32": (dict(), 32),
         "strack_oblivious_cap32": (dict(lb_mode="oblivious"), 32),
         "rocev2_pfc_cap32": (dict(protocol="rocev2"), 32),
         "strack_cap24": (dict(), 24)}


def _cfgs(kw, cap):
    common = dict(time_warp=False, trace_every=0, active_cap=cap)
    return (JF.FabricConfig(net=JNET, **common, **kw),
            TF.FabricConfig(net=TNET, **common, **kw))


@functools.lru_cache(maxsize=None)
def _port(case, k):
    """The port's final state after ``k`` dense ticks (``run``, whose
    state an overflow does not stop)."""
    kw, cap = CASES[case]
    return port_program(full_bisection(4, 4), open_loop_trace(), k,
                        _cfgs(kw, cap)[1]).run()[0]


@pytest.mark.parametrize("k", [1, 2, 8, 40, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_capped_state_equals_jax(case, k):
    kw, cap = CASES[case]
    jcfg, _ = _cfgs(kw, cap)
    jfin = jax_final_state(j_full_bisection(4, 4), open_loop_trace(), k,
                           jcfg)
    tfin = _port(case, k)
    bad = diff_leaves(jfin, tfin, ring_rows=Q_ROWS)
    assert not bad, f"{case}: first diverging leaves after {k} ticks: " \
                    f"{bad[:5]}"
    if k < 200:
        return
    # the branches each case is there for
    if case == "strack_cap24":
        assert int(tfin.act_overflow) > 0
    else:
        assert int(tfin.act_overflow) == 0
        assert int((tfin.done_tick >= 0).sum()) >= 20
    if case == "rocev2_pfc_cap32":
        assert int(tfin.flows.snd_una.sum()) > 0
    if case == "strack_cap32":
        assert int(tfin.ecn_marks) > 0


def test_the_slate_fills_and_holds_flow_n_minus_1_with_padding():
    """The strack_cap32 case's slates, stepped by the port: full to the
    last lane at the peak, and holding flow N-1 beside padded lanes (a
    padded lane that read flow N-1's row would show there)."""
    kw, cap = CASES["strack_cap32"]
    prog = port_program(full_bisection(4, 4), open_loop_trace(), 200,
                        _cfgs(kw, cap)[1])
    n, st = prog.N, prog.init_state()
    full = last_with_pad = 0
    for t in range(200):
        mask = (prog.sendable_msg(st, t)[prog.dep.msg_of_flow.long()]
                & ~prog.proto.done(st.flows))
        lanes, over = prog.lane_slate(mask)
        assert int(over) == 0
        ok = lanes.idx < n
        full += int(ok.all())
        last_with_pad += int(bool((lanes.idx == n - 1).any())
                             and not bool(ok.all()))
        st, _, _ = prog.tick(st, t)
    assert full > 0 and last_with_pad > 0
    assert torch.equal(st.done_tick, _port("strack_cap32", 200).done_tick)
