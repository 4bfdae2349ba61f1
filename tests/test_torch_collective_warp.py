"""The event-horizon loop on dependency-scheduled traces in the port.

A tick's completions release children inside the tick.  The reference's
warp loop reads its idle test and ``warp_target``'s sendable mask from
the tick's output state; the port's reads the input state's mask, and
``warp_target``'s open-loop arrival term, which reads the output state's
``pending``, wakes the loop on the next tick after a release.  On chained
traces (the golden ring and all-to-all under STrack, the ring striped
over four sub-flows under RoCEv2 + PFC, and a two-stage chain on a 2 us
network) the reference's loop, run on the port's ticks, equals the
port's dense run on every ``FabricState`` leaf at the horizon, and the
port's ``run`` and JAX's warp run on every summary key and trip count.
Each chain but the all-to-all has trips on which a message is released
while the idle test on the input mask reads the trip as idle, and on
each ``warp_target`` of the input mask is the next tick.  The sub-flow
fault case of the reference (``tests/test_faults.py``): RoCEv2
at four sub-flows under the ``MIXED`` schedule, warp against dense and
against JAX.
"""
import pytest

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import faults as JFa
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import Message as JMessage
from repro.sim.workloads import RunConfig as JRunConfig
from repro.sim.workloads import permutation_scenario as j_permutation
from repro.sim.workloads import run as j_run

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import RunConfig, permutation_scenario, run

from torch_parity import (chain_trace, diff_leaves, jax_small_collective,
                          port_program)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]


#: case -> (trace, FabricConfig fields of both packages but the network,
#: link Gbps, base RTT in us (None: the default), horizon in ticks)
CASES = {
    "ring8_strack": ("ring8", {}, 100.0, None, 700),
    "a2a_x2_strack": ("a2a_x2", {}, 100.0, None, 400),
    "ring8_roce4": ("ring8", dict(protocol="rocev2", subflows=4), 100.0,
                    None, 400),
    "chain_rtt2": ("chain", {}, 400.0, 2.0, 300),
}


def _trace(name):
    return (chain_trace(JMessage) if name == "chain"
            else jax_small_collective(name))


def _cfgs(case, warp):
    trace, kw, gbps, rtt, _ = CASES[case]
    extra = {} if rtt is None else dict(base_rtt_us=rtt)
    common = dict(time_warp=warp, trace_every=0, **kw)
    return (JF.FabricConfig(net=JNet(link_gbps=gbps, **extra), **common),
            TF.FabricConfig(net=NetworkSpec(link_gbps=gbps, **extra),
                            **common))


def _warp_trips(prog):
    """The reference's warp loop (idle test and ``warp_target`` on the
    output state's mask) over the port's ticks, trip by trip -> (final
    state, trips, release trips): trips whose tick released a message
    (its dependencies met by the tick's completions) while the idle test
    on the tick's input mask, as ``FabricProgram.run`` reads it, reads
    the trip as idle.  On each such trip ``warp_target`` of the input mask
    is the next tick, as the output mask's busy trip is."""
    st, t, trips, released = prog.init_state(), 0, 0, 0
    while t < prog.n_ticks:
        st, can_any, sendable_in = prog.tick(st, t)

        def idle(sendable):
            out = (~can_any) & ~(sendable & (st.msg_release_tick < 0)).any()
            if prog.pfc and prog.PD > 0:
                dec = TF.torch.cat([st.paused_nic, st.paused_sd.reshape(-1),
                                    st.paused_up.reshape(-1)])
                out = out & (st.pfc_line == dec[None, :]).all()
            return bool(out)

        sendable = prog.sendable_msg(st, t)
        if idle(sendable):
            t_next = int(prog.warp_target(st, t, sendable))
        else:
            t_next = t + 1
            if idle(sendable_in):
                released += 1
                assert int(prog.warp_target(st, t, sendable_in)) == t_next
        trips += 1
        t = t_next
    return st, trips, released


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_equals_dense_on_chained_traces(case):
    trace, _, _, _, n_ticks = CASES[case]
    topo = full_bisection(2, 4)
    dense = port_program(topo, _trace(trace), n_ticks,
                         _cfgs(case, False)[1]).run()[0]
    warp_prog = port_program(topo, _trace(trace), n_ticks,
                             _cfgs(case, True)[1])
    final, trips, released = _warp_trips(warp_prog)
    # the injection counts' trash row counts the lanes of every tick run
    real = lambda s: s._replace(tx_rows=s.tx_rows[:warp_prog.Q])
    bad = diff_leaves(real(dense), real(final), ring_rows=warp_prog.Q)
    assert not bad, f"{case}: warp vs dense at tick {n_ticks}: {bad[:5]}"
    # (the all-to-all's releases fall on ticks busy with other sends)
    assert released > 0 or trace == "a2a_x2", \
        "no release on a trip the input mask reads as idle"
    assert trips < n_ticks
    # and the loop as run() runs it, against JAX's warp run
    tm = TF.run_fabric_trace(topo, _trace(trace), n_ticks,
                             _cfgs(case, True)[1], device="cpu")[1]
    jm = JF.run_fabric_trace(j_full_bisection(2, 4), _trace(trace), n_ticks,
                             _cfgs(case, True)[0])[1]
    assert tm["warp_trips"] == int(jm["warp_trips"]) == trips
    assert TF.summarize(tm) == JF.summarize(jm)
    assert int((final.msg_release_tick > 0).sum()) > 0


#: The reference's MIXED schedule (tests/test_faults.py).
MIXED = dict(link_flaps=((0, 0, 10, 60),), host_flaps=((5, 30, 80),),
             link_degrade=((1, 1, 0, 200, 0.5),),
             link_corrupt=((2, 2, 0, 300, 0.05),), seed=3)
#: Summary keys every execution must agree on.
EXACT_KEYS = ("max_fct", "avg_fct", "unfinished", "drops", "pauses",
              "retransmits", "rto_fires", "sack_recoveries", "gbn_rewinds",
              "blackholed_pkts", "corrupt_drops", "ecn_marks",
              "tx_rows_pkts", "win_retx")


@pytest.mark.parametrize("n_ticks,dense", [(1000, "port"), (6000, "jax")])
def test_striped_roce_warp_equals_dense_under_mixed_faults(n_ticks, dense):
    """``subflows=4`` RoCEv2 under ``MIXED`` on a 4x4 permutation (128
    KiB, 400 Gbps): the port's warp run against the port's dense run over
    the first 1000 ticks, and over 6000 ticks against JAX's dense run;
    both against JAX's warp run."""
    def cfg(mod, faults, warp):
        return mod(protocol="rocev2", subflows=4, n_ticks=n_ticks,
                   time_warp=warp, faults=faults)

    tsc = permutation_scenario(full_bisection(4, 4), 128 * 2 ** 10,
                               net=NetworkSpec(link_gbps=400.0), seed=0)
    jsc = j_permutation(j_full_bisection(4, 4), 128 * 2 ** 10,
                        net=JNet(link_gbps=400.0), seed=0)
    tfs, jfs = TFa.FaultSpec(**MIXED), JFa.FaultSpec(**MIXED)
    base = (run(tsc, cfg(RunConfig, tfs, False), device="cpu")
            if dense == "port" else j_run(jsc, cfg(JRunConfig, jfs, False)))
    warp = run(tsc, cfg(RunConfig, tfs, True), device="cpu")
    jwarp = j_run(jsc, cfg(JRunConfig, jfs, True))
    for k in EXACT_KEYS:
        assert base[k] == warp[k] == jwarp[k], (n_ticks, k)
    assert warp["warp_trips"] == jwarp["warp_trips"] < n_ticks // 2
    assert base["blackholed_pkts"] > 0 and sum(base["win_retx"]) > 0
    if dense == "jax":
        assert base["unfinished"] == 0
