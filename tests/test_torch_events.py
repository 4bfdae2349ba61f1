"""The port's event oracle against the JAX package's, on the CPU.

``repro_torch.core.ref`` (the f64 STrack and RoCEv2 engines),
``repro_torch.sim.events`` (the discrete-event ``NetSim``) and the events
backend of ``repro_torch.sim.workloads`` (``run``, ``sweep``,
``TraceRunner``, ``run_scenario_on_sim``) are copies of the reference's
pure-Python modules on the port's own ``params``, ``topology`` and fault
draw: on the same inputs they give the same output, dict for dict and bit
for bit (no tolerance).  The golden scenarios run under STrack (adaptive
and oblivious spray), RoCEv2 with 4 QPs, the ``MIXED`` fault schedule and
propagation and buffer overrides; the engines run fixed op sequences in
the ranges of ``tests/test_core_vs_ref.py``'s strategies.  The port's
fabric is held against the port's oracle inside the fuzz band on an
open-loop arrival trace; ``events64_ref.json`` is rebuilt from JAX.  The
port's ``sim.jaxsim.run_incast`` (the fabric's 1-queue incast) equals
JAX's too.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.core.params as JP
import repro.sim.faults as JF
import repro.sim.topology as JT
import repro.sim.workloads as JW
import repro_torch.core.params as TP
import repro_torch.sim.faults as TF
import repro_torch.sim.topology as TT
import repro_torch.sim.workloads as TW
from repro.core import ref as jref
from repro_torch.core import ref as tref

from torch_parity import (CHAOS1024, EVENTS_REF_PATH, EVENTS_REFS,
                          EVENTS_UNTIL_US, canon, chain_trace,
                          events_reference, port_fleet)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

PKGS = {"jax": (JW, JT, JP, JF), "port": (TW, TT, TP, TF)}

#: tests/test_torch_faults_warp.py's schedule for 4x4 fabrics: a link flap,
#: a host flap, a degraded link and a corrupting link.
MIXED = dict(link_flaps=((0, 0, 10, 60),), host_flaps=((5, 30, 80),),
             link_degrade=((1, 1, 0, 200, 0.5),),
             link_corrupt=((2, 2, 0, 300, 0.05),), seed=3)

#: The goldens' scenarios (tests/test_golden.py), built by either package.
SCENARIOS = {
    "perm16": lambda W, T, P: W.permutation_scenario(
        T.full_bisection(4, 4), 256 * 2 ** 10,
        net=P.NetworkSpec(link_gbps=400.0), seed=0),
    "incast8": lambda W, T, P: W.incast_scenario(
        T.full_bisection(4, 4), 8, 512 * 2 ** 10,
        net=P.NetworkSpec(link_gbps=400.0)),
    "ring8": lambda W, T, P: W.collective_scenario(
        T.full_bisection(2, 4), "ring", 1, 8, 512 * 2 ** 10,
        net=P.NetworkSpec(link_gbps=100.0), seed=0, chunk=32 * 2 ** 10),
    "a2a": lambda W, T, P: W.collective_scenario(
        T.full_bisection(2, 4), "a2a", 2, 4, 256 * 2 ** 10,
        net=P.NetworkSpec(link_gbps=100.0), seed=0, chunk=128 * 2 ** 10,
        window=2),
}
#: RunConfig fields of the events runs ("MIXED" the schedule above, which
#: fits the 4x4 fabrics only).
CONFIGS = {
    "strack": {},
    "oblivious": dict(lb_mode="oblivious"),
    "roce4": dict(protocol="rocev2", subflows=4),
    "mixed": dict(faults="MIXED"),
    "hop_prop": dict(hop_prop_us=1.0),
    "buffer_roce": dict(protocol="rocev2", switch_buffer_bytes=1e6),
}
CASES = [(s, c) for s in SCENARIOS for c in CONFIGS
         if not (c == "mixed" and s in ("ring8", "a2a"))]


def _scenario(pkg, name):
    W, T, P, _ = PKGS[pkg]
    return SCENARIOS[name](W, T, P)


def _cfg(pkg, kw):
    W, _, _, F = PKGS[pkg]
    kw = dict(kw)
    if kw.get("faults") == "MIXED":
        kw["faults"] = F.FaultSpec(**MIXED)
    return W.RunConfig(backend="events", **kw)


def _both(scenario, kw):
    return {pkg: PKGS[pkg][0].run(_scenario(pkg, scenario), _cfg(pkg, kw))
            for pkg in PKGS}


@pytest.mark.parametrize("scenario,config", CASES)
def test_events_run_equals_jax(scenario, config):
    got = _both(scenario, CONFIGS[config])
    assert canon(got["port"]) == canon(got["jax"])
    assert got["port"]["backend"] == "events"
    assert got["port"]["unfinished"] == 0
    if SCENARIOS[scenario] in (SCENARIOS["ring8"], SCENARIOS["a2a"]):
        assert got["port"]["finished_groups"] == got["port"]["total_groups"]
    if config == "mixed":
        assert got["port"]["blackholed_pkts"] > 0
    if (scenario, config) == ("incast8", "buffer_roce"):
        assert got["port"]["pauses"] > 0


def test_events_sweep_equals_jax():
    """``sweep()`` loops ``run()`` for events entries: any mix of
    scenarios and configs, a fabric-free sweep included."""
    names = ["perm16", "ring8", "incast8"]
    kws = [{}, dict(protocol="rocev2", subflows=4), dict(lb_mode="oblivious")]
    got = {pkg: PKGS[pkg][0].sweep([_scenario(pkg, n) for n in names],
                                   [_cfg(pkg, kw) for kw in kws])
           for pkg in PKGS}
    assert canon(got["port"]) == canon(got["jax"])
    assert [r["name"] for r in got["port"]] == [
        _scenario("port", n).name for n in names]


def test_trace_runner_with_placement_equals_jax():
    """A dependency trace through :class:`TraceRunner` directly, its ranks
    placed on hosts of another fabric, with the per-message FCTs."""
    out = {}
    for pkg, (W, T, P, _) in PKGS.items():
        net = P.NetworkSpec(link_gbps=100.0)
        topo = T.full_bisection(4, 4)
        sim = W._events_sim(W.Scenario("chain", topo, net, ()),
                            W.RunConfig(backend="events", seed=7))
        placement = {r: (5 * r + 3) % 16 for r in range(8)}
        runner = W.TraceRunner(sim, chain_trace(W.Message), placement)
        res = runner.run(until=1e7)
        out[pkg] = dict(res, summary=W._summarize_sim(sim),
                        done=sorted(runner.done))
    assert canon(out["port"]) == canon(out["jax"])
    assert len(out["port"]["msg_fct"]) == 8
    assert out["port"]["finished_groups"] == 2


def test_run_scenario_on_sim_with_logs_equals_jax():
    """A prebuilt NetSim with queue-delay, ACK and delivery logs on: the
    summary and every log equal JAX's."""
    out = {}
    for pkg, (W, T, P, E) in PKGS.items():
        sc = _scenario(pkg, "incast8")
        sim = W._events_sim(sc, W.RunConfig(backend="events"),
                            log_queues=True, qdelay_log_threshold=1.0)
        sim.ack_log, sim.rx_bytes_log = [], []
        res = W.run_scenario_on_sim(sim, sc, until=1e7)
        logs = {f"host_down{h}": q.delay_log
                for h, q in enumerate(sim.host_down) if q.delay_log}
        out[pkg] = dict(res, logs=logs, acks=sim.ack_log,
                        rx=sim.rx_bytes_log, pauses=sim.pause_log)
    assert canon(out["port"]) == canon(out["jax"])
    assert out["port"]["logs"] and out["port"]["acks"]


def test_events_errors_equal_jax():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="fixed"):
            PKGS[pkg][0].run(_scenario(pkg, "perm16"),
                             _cfg(pkg, dict(lb_mode="fixed")))


def test_oversub_scenario_equals_jax():
    scs = {pkg: W.oversub_scenario(4, 4, 2, 64 * 2 ** 10,
                                   net=P.NetworkSpec(link_gbps=400.0), seed=1)
           for pkg, (W, _, P, _) in PKGS.items()}
    assert scs["port"].name == scs["jax"].name == "oversub_2:1"
    assert scs["port"].topo.n_spine == scs["jax"].topo.n_spine == 2
    assert [dataclasses.astuple(m) for m in scs["port"].messages] == \
        [dataclasses.astuple(m) for m in scs["jax"].messages]
    got = {pkg: W.run(scs[pkg], W.RunConfig(backend="events"))
           for pkg, (W, *_) in PKGS.items()}
    assert canon(got["port"]) == canon(got["jax"])


# --------------------------------------------------------------------------- #
# the f64 engines of core/ref.py on fixed op sequences
# --------------------------------------------------------------------------- #

R = {"jax": jref, "port": tref}
P = {"jax": JP, "port": TP}
NET_KW = dict(link_gbps=400.0)


def _state(obj) -> str:
    """Every field of an engine object (its slots; nested engines and sets
    included; the parameter records left out) in JSON's exact form."""
    out = {}
    for k in getattr(type(obj), "__slots__", ()):
        if k == "p" or k.startswith("_"):
            continue
        v = getattr(obj, k, None)
        if isinstance(v, set):
            v = sorted(v)
        elif getattr(type(v), "__slots__", None):
            v = _state(v)
        out[k] = v
    return canon(out)


def _same(objs: dict):
    assert _state(objs["port"]) == _state(objs["jax"])


@pytest.mark.parametrize("seed", range(4))
def test_ref_spray_and_cc_equal_jax(seed):
    """test_core_vs_ref.py's ``lb_ops`` and ``cc_ops`` ranges, drawn from
    a fixed seed: the pick and every field after every op are the same."""
    rng = np.random.default_rng(seed)
    small = {k: P[k].make_strack_params(P[k].NetworkSpec(**NET_KW),
                                        max_paths=16) for k in P}
    full = {k: P[k].make_strack_params(P[k].NetworkSpec(**NET_KW))
            for k in P}
    spray = {k: R[k].SprayState(small[k]) for k in R}
    cc = {k: R[k].CCState(full[k]) for k in R}
    now = 0.0
    for _ in range(60):
        if rng.random() < 0.5:
            ecn, path = bool(rng.random() < 0.5), int(rng.integers(0, 16))
            for st in spray.values():
                st.update_ecn_bitmap(ecn, path)
        else:
            cwnd = float(rng.uniform(0.5, 120.0))
            now += float(rng.uniform(0.0, 100.0))
            picks = {k: st.choose_path(cwnd, now) for k, st in spray.items()}
            assert picks["port"] == picks["jax"]
        _same(spray)
    now = 0.0
    for _ in range(80):
        ecn, delay = bool(rng.random() < 0.5), float(rng.uniform(0, 120))
        acked = float(rng.uniform(0, 4096.0 * 4))
        probe = bool(rng.random() < 0.5)
        now += float(rng.uniform(0.05, 30.0))
        for c in cc.values():
            c.adjust_cwnd(ecn, delay,
                          c.update_achieved_bdp(acked, probe, now), now)
        _same(cc)


def _wire(rng, n_inflight: int):
    """One random delivery decision: (index, dropped, ecn)."""
    return (int(rng.integers(0, n_inflight)), bool(rng.random() < 0.15),
            bool(rng.random() < 0.3))


@pytest.mark.parametrize("seed", range(4))
def test_ref_strack_sender_and_receiver_equal_jax(seed):
    """An STrack sender and receiver on a lossy, reordering wire (fixed
    random sends, deliveries, drops, ECN marks and timer firings): every
    packet, SACK and engine field equals JAX's after every step."""
    rng = np.random.default_rng(seed)
    prm = {k: P[k].make_strack_params(P[k].NetworkSpec(**NET_KW)) for k in P}
    snd = {k: R[k].STrackSender(prm[k], 7, 40 * 4096.0 - 100.0) for k in R}
    rcv = {k: R[k].STrackReceiver(prm[k], snd[k].total_pkts) for k in R}
    wire = {k: [] for k in R}
    now, seen = 0.0, dict(sacks=0, probes=0, recovery=0)
    for _ in range(600):
        now += float(rng.uniform(0.05, 2.0))
        op = int(rng.integers(0, 4))
        if op <= 1:
            pkts = {k: s.next_packet(now) for k, s in snd.items()}
            assert (pkts["port"] is None) == (pkts["jax"] is None)
            if pkts["port"] is not None:
                _same(pkts)
                for k in R:
                    wire[k].append(pkts[k])
        elif op == 2 and wire["port"]:
            i, dropped, ecn = _wire(rng, len(wire["port"]))
            sacks = {}
            for k in R:
                pkt = wire[k].pop(i)
                pkt.ecn = ecn
                sacks[k] = None if dropped else rcv[k].on_data(pkt, now)
            assert (sacks["port"] is None) == (sacks["jax"] is None)
            if sacks["port"] is not None:
                _same(sacks)
                seen["sacks"] += 1
                for k in R:
                    snd[k].on_sack(sacks[k], now + 1.0)
        elif op == 3:
            probes = {k: s.on_timer(now) for k, s in snd.items()}
            assert (probes["port"] is None) == (probes["jax"] is None)
            if probes["port"] is not None:
                seen["probes"] += 1
                for k in R:
                    wire[k].append(probes[k])
        _same(snd)
        _same(rcv)
        seen["recovery"] += int(snd["port"].in_recovery)
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("seed", range(3))
def test_ref_roce_sender_and_receiver_equal_jax(seed):
    """A RoCEv2 sender (DCQCN pacing, go-back-N) and receiver on the same
    kind of wire: NACKs, CNPs and every DCQCN stage; every packet and
    field equals JAX's after every step."""
    rng = np.random.default_rng(seed)
    net = {k: P[k].NetworkSpec(**NET_KW) for k in P}
    dq = {k: P[k].make_dcqcn_params(net[k]) for k in P}
    snd = {k: R[k].RoCESender(dq[k], 3, 60 * 4096.0 - 10.0, 4096,
                              net[k].rate_Bpus, 11, 40.0, 16.0) for k in R}
    rcv = {k: R[k].RoCEReceiver(snd[k].total_pkts, 2, 4.0) for k in R}
    wire = {k: [] for k in R}
    now, kinds = 0.0, set()
    for _ in range(800):
        now += float(rng.uniform(0.01, 1.5))
        op = int(rng.integers(0, 4))
        if op <= 1:
            pkts = {k: s.next_packet(now) for k, s in snd.items()}
            assert (pkts["port"] is None) == (pkts["jax"] is None)
            if pkts["port"] is not None:
                _same(pkts)
                for k in R:
                    wire[k].append(pkts[k])
        elif op == 2 and wire["port"]:
            i, dropped, ecn = _wire(rng, len(wire["port"]))
            outs = {}
            for k in R:
                pkt = wire[k].pop(i)
                pkt.ecn = ecn
                outs[k] = [] if dropped else rcv[k].on_data(pkt, now)
            assert len(outs["port"]) == len(outs["jax"])
            for a, b in zip(outs["port"], outs["jax"]):
                _same({"port": a, "jax": b})
                kinds.add(a.kind)
                snd["port"].on_ack(a, now + 1.0)
                snd["jax"].on_ack(b, now + 1.0)
        elif op == 3:
            for s in snd.values():
                s.on_timer(now)
        _same(snd)
        _same(rcv)
    assert kinds == {tref.SACK, tref.NACK, tref.CNP}, kinds


# --------------------------------------------------------------------------- #
# the fabric against the oracle; the reference file
# --------------------------------------------------------------------------- #

def test_port_fabric_within_band_of_port_oracle():
    """tests/test_traffic.py's open-loop burst trace: the port's fabric
    (CPU) and the port's oracle agree inside the fuzz band."""
    from repro_torch.sim.traffic import InferenceTenant, mixed_scenario
    ten = [InferenceTenant("burst", n_flows=16, mean_interarrival_ticks=4.0,
                           size_bytes=8 * 2 ** 10, size_jitter=0.5,
                           n_targets=2)]
    sc, _ = mixed_scenario(TT.full_bisection(4, 4), [], ten,
                           net=TP.NetworkSpec(link_gbps=400.0), seed=2)
    fb = TW.run(sc, TW.RunConfig(), device="cpu")
    ev = TW.run(sc, TW.RunConfig(backend="events", until=1e7))
    assert fb["unfinished"] == 0 and ev["unfinished"] == 0
    r = fb["max_fct"] / ev["max_fct"]
    assert 0.7 < r < 1.4, (fb["max_fct"], ev["max_fct"])


def test_events64_reference_file_is_what_jax_computes_and_the_port_gives():
    """``events64_ref.json`` (the soak's 64-host fleet, epoch 0 clean and
    under CHAOS1024; the spot fleet under STrack and RoCEv2) rebuilt from
    JAX, and the port's oracle equal to it, ``msg_fct`` and ``group_fct``
    included."""
    want = json.loads(EVENTS_REF_PATH.read_text())
    assert canon(events_reference()) == canon(want)
    from repro_torch.sim.traffic import mixed_scenario
    for name, (fleet, kw) in EVENTS_REFS.items():
        topo, net, jobs, tenants = port_fleet(fleet)
        sc = mixed_scenario(topo, jobs, tenants, net=net, seed=0)[0]
        kw = dict(kw)
        if kw.get("faults") == "CHAOS1024":
            kw["faults"] = TF.FaultSpec(**CHAOS1024)
        got = TW.run(sc, TW.RunConfig(backend="events",
                                      until=EVENTS_UNTIL_US, **kw))
        assert canon(got) == canon(want[name]), name
        assert got["unfinished"] == 0 and len(got["msg_fct"]) == len(
            sc.messages)
    assert want["default_chaos"]["blackholed_pkts"] > 0


def test_run_incast_equals_jax():
    """``sim.jaxsim.run_incast`` (the 1-queue incast on the fabric, per-tick
    trace) on ``IncastConfig(n_flows=8)``: every metric equals JAX's."""
    from repro.sim.jaxsim import IncastConfig as JCfg
    from repro.sim.jaxsim import run_incast as j_run_incast
    from repro_torch.sim.jaxsim import IncastConfig, run_incast
    _, got = run_incast(IncastConfig(n_flows=8), 600, device="cpu")
    _, want = j_run_incast(JCfg(n_flows=8), 600)
    assert set(got) == set(want)
    for k, v in want.items():
        if callable(v) or isinstance(v, dict):
            continue
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
    assert np.asarray(got["queue_pkts"]).shape == (600,)
    assert int(np.asarray(got["drops"])[-1]) > 0
