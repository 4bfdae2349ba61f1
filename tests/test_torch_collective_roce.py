"""The port's fabric state on collectives striped over four sub-flows under
RoCEv2 + PFC (the paper's 4-QP RoCEv2) against the JAX reference.

Every ``FabricState`` leaf after 1, 2, 8, 40 and 200 dense ticks, bit for
bit, on the traces of ``tests/test_torch_collective_state.py`` at
``subflows=4``: each message's four stripes share its release gate and
complete it together, each pins its own entropy.  A JAX state taken
after 40 ticks of the striped ring, mid-collective, carried into the port
(``convert.to_torch``) and ticked to 200 by the port equals JAX's state
after 200 ticks.
"""
import functools

import pytest

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection

from repro_torch.convert import to_torch
from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection

from torch_parity import (SMALL_COLLECTIVES, diff_leaves, jax_final_state,
                          jax_small_collective, port_program, port_states)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=100.0), NetworkSpec(link_gbps=100.0)
Q_ROWS = 2 * 2 * 4 + 8
STEPS = (1, 2, 8, 40, 200)
ROCE4 = dict(protocol="rocev2", subflows=4, time_warp=False, trace_every=0)


@functools.lru_cache(maxsize=None)
def _port(trace):
    return port_states(full_bisection(2, 4), jax_small_collective(trace),
                       STEPS, TF.FabricConfig(net=TNET, **ROCE4))


def _jax(trace, k):
    return jax_final_state(j_full_bisection(2, 4),
                           jax_small_collective(trace), k,
                           JF.FabricConfig(net=JNET, **ROCE4))


@pytest.mark.parametrize("k", STEPS)
@pytest.mark.parametrize("trace", sorted(SMALL_COLLECTIVES))
def test_striped_collective_state_equals_jax(trace, k):
    tfin = _port(trace)[k]
    bad = diff_leaves(_jax(trace, k), tfin, ring_rows=Q_ROWS)
    assert not bad, f"{trace} rocev2 x4: first diverging leaves after {k} " \
                    f"ticks: {bad[:5]}"
    n_msgs = len(jax_small_collective(trace))
    assert tfin.done_tick.shape[0] == 4 * n_msgs
    if k == STEPS[-1]:
        assert int(tfin.msg_done.sum()) > 0
        assert int((tfin.msg_release_tick > 0).sum()) > 0
        assert int(tfin.flows.snd_una.sum()) > 0


def test_port_resumes_a_jax_state_mid_collective():
    j40, j200 = _jax("ring8", 40), _jax("ring8", 200)
    prog = port_program(full_bisection(2, 4), jax_small_collective("ring8"),
                        200, TF.FabricConfig(net=TNET, **ROCE4))
    st = to_torch(j40, TF.FabricState)
    assert int(st.msg_done.sum()) < int(j200.msg_done.sum())
    for t in range(40, 200):
        st, _, _ = prog.tick(st, t)
    bad = diff_leaves(j200, st, ring_rows=prog.Q)
    assert not bad, bad[:5]
