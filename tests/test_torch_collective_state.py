"""The port's fabric state on dependency-scheduled collectives against the
JAX reference, under STrack.

Every ``FabricState`` leaf (the dependency counters ``pending``,
``msg_done``, ``msg_release_tick``, ``msg_done_tick`` and
``group_done_tick`` among them) after 1, 2, 8, 40 and 200 dense ticks,
bit for bit (the queue rings to their real rows), under adaptive and
oblivious spray, on the golden ring allreduce ``ring8`` and pair of
windowed all-to-alls ``a2a_x2`` (``torch_parity.SMALL_COLLECTIVES``, on
``full_bisection(2, 4)`` at 100 Gbps).

By tick 200 messages have completed and released their children.
(The same under RoCEv2 + PFC at four sub-flows:
``tests/test_torch_collective_roce.py``.)
"""
import functools

import pytest

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection

from torch_parity import (SMALL_COLLECTIVES, diff_leaves, jax_final_state,
                          jax_small_collective, port_states)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=100.0), NetworkSpec(link_gbps=100.0)
Q_ROWS = 2 * 2 * 4 + 8
STEPS = (1, 2, 8, 40, 200)
LB_MODES = ("adaptive", "oblivious")


def _cfg(mod, net, **kw):
    return mod.FabricConfig(net=net, time_warp=False, trace_every=0, **kw)


@functools.lru_cache(maxsize=None)
def _port(trace, lb_mode):
    return port_states(full_bisection(2, 4), jax_small_collective(trace),
                       STEPS, _cfg(TF, TNET, lb_mode=lb_mode))


@pytest.mark.parametrize("k", STEPS)
@pytest.mark.parametrize("lb_mode", LB_MODES)
@pytest.mark.parametrize("trace", sorted(SMALL_COLLECTIVES))
def test_collective_state_equals_jax(trace, lb_mode, k):
    jfin = jax_final_state(j_full_bisection(2, 4),
                           jax_small_collective(trace), k,
                           _cfg(JF, JNET, lb_mode=lb_mode))
    tfin = _port(trace, lb_mode)[k]
    bad = diff_leaves(jfin, tfin, ring_rows=Q_ROWS)
    assert not bad, f"{trace} {lb_mode}: first diverging leaves after {k} " \
                    f"ticks: {bad[:5]}"
    if k == STEPS[-1]:  # messages completed and released their children
        released = tfin.msg_release_tick >= 0
        assert int(tfin.msg_done.sum()) > 0
        assert int((released & (tfin.msg_release_tick > 0)).sum()) > 0
        assert int((tfin.pending < 0).sum()) == 0
