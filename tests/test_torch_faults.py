"""The port's chaos subsystem (``repro_torch.sim.faults`` and the fabric's
fault stages) against the JAX reference.

* the corruption draw ``fault_u01`` bit for bit against JAX's on 10^4
  random keys (negative counters included, which both cast to uint32) and
  against the host mirror ``fault_u01_py``; ``duty_open``,
  ``build_fault_data``'s arrays, the spec's static shape;
* ``validate_faults`` with the reference's rejection cases;
* native dead links against their t=0 uplink-flap schedule, in the port
  and against JAX;
* the goldens ``perm16_flap_strack`` / ``perm16_flap_roce``;
* the default horizon past the schedule's last edge;
* the front door's gaps closed by this slice: ``RunConfig`` validates as
  the reference's does (ROADMAP C13) and carries ``pfc_delay_ticks``
  (C12).

Whole-state parity under faults and warp against dense ticking:
``tests/test_torch_faults_state.py``; the full-width reference files:
``tests/test_torch_faults_ref.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import faults as JFa
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.topology import with_link_failures as j_with_link_failures
from repro.sim.workloads import RunConfig as JRunConfig
from repro.sim.workloads import incast_scenario as j_incast
from repro.sim.workloads import permutation_scenario as j_permutation
from repro.sim.workloads import run as j_run

from repro_torch.core.params import NetworkSpec
from repro_torch.sim import fabric as TF
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection, with_link_failures
from repro_torch.sim.workloads import (RunConfig, Scenario, _fabric_cfg,
                                       _scenario_ticks, incast_scenario,
                                       permutation_scenario, run)

from torch_parity import diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
TOPO = full_bisection(4, 4)
PERM = permutation_scenario(TOPO, 128 * 2 ** 10, net=TNET, seed=0)

#: The reference's mixed schedule (tests/test_faults.py), as fields.
MIXED = dict(link_flaps=((0, 0, 10, 60),), host_flaps=((5, 30, 80),),
             link_degrade=((1, 1, 0, 200, 0.5),),
             link_corrupt=((2, 2, 0, 300, 0.05),), seed=3)
#: Summary keys that must agree between the port and JAX, and between the
#: port's execution variants.
EXACT_KEYS = ("max_fct", "avg_fct", "unfinished", "drops", "pauses",
              "retransmits", "rto_fires", "sack_recoveries", "gbn_rewinds",
              "blackholed_pkts", "corrupt_drops", "ecn_marks",
              "tx_rows_pkts", "win_retx")


# --------------------------------------------------------------------------- #
# The draw, the duty cycle and the schedule's arrays
# --------------------------------------------------------------------------- #

def _keys(n, seed):
    rng = np.random.default_rng(seed)
    i32 = lambda lo, hi: rng.integers(lo, hi, n).astype(np.int32)
    return (i32(-2 ** 31, 2 ** 31), i32(-2 ** 31, 2 ** 31),
            i32(-2 ** 31, 2 ** 31))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_fault_u01_matches_jax_on_random_keys(seed):
    """10^4 keys over the whole int32 range of row, tick and psn (half of
    them negative, which both packages cast to uint32)."""
    row, t, psn = _keys(10 ** 4, seed)
    want = np.asarray(jax.jit(JFa.fault_u01)(jnp.int32(seed), row, t, psn))
    got = TFa.fault_u01(seed, torch.from_numpy(row), torch.from_numpy(t),
                        torch.from_numpy(psn)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    assert ((got >= 0) & (got < 1)).all()


def test_fault_u01_matches_the_host_mirror_and_known_answers():
    """Non-negative keys (the fabric's rows, ticks and psns): the tensor
    draw equals the copied host mirror and JAX's, key by key; a negative
    counter is where the two mirrors part (32 against 64 bits)."""
    keys = [(0, 0, 0, 0), (1, 7, 123, 45), (2 ** 31 - 1, 95, 10 ** 6, 4095),
            (12345, 3, 999999, 1), (7, 0, 1, 0), (3, 3071, 2 ** 30 - 1, 47)]
    for (seed, row, tick, psn) in keys:
        c = [torch.tensor(v, dtype=torch.int32) for v in (row, tick, psn)]
        got = float(TFa.fault_u01(seed, *c))
        assert got == TFa.fault_u01_py(seed, row, tick, psn) \
            == JFa.fault_u01_py(seed, row, tick, psn)
        assert got == float(JFa.fault_u01(jnp.int32(seed), jnp.int32(row),
                                          jnp.int32(tick), jnp.int32(psn)))
    neg = float(TFa.fault_u01(5, torch.tensor(-1, dtype=torch.int32)))
    assert neg == TFa.fault_u01_py(5, 2 ** 32 - 1)
    assert neg == float(JFa.fault_u01(jnp.int32(5), jnp.int32(-1)))


def test_duty_open_matches_jax():
    t = np.arange(0, 3000, dtype=np.int32)
    for num in (1, 64, 77, 128, 200, 255, 256):
        want = np.asarray(JFa.duty_open(jnp.asarray(t), jnp.int32(num)))
        got = TFa.duty_open(torch.from_numpy(t),
                            torch.tensor(num, dtype=torch.int32)).numpy()
        assert np.array_equal(want, got), num
        assert [TFa.duty_open_py(int(x), num) for x in t[:300]] \
            == want[:300].tolist()


def _both_specs(**kw):
    return JFa.FaultSpec(**kw), TFa.FaultSpec(**kw)


def test_fault_data_and_spec_shape_match_jax():
    fields = dict(MIXED, uplink_flaps=((1, 2, 5, TFa.NEVER),),
                  host_corrupt=((7, 0, 300, 0.2),), seed=2 ** 31 + 5)
    js, ts = _both_specs(**fields)
    assert ts.shape_key == js.shape_key == (1, 1, 1, 1, 1, 1)
    for k in ("seed32", "total_entries", "n_flap_windows", "last_edge"):
        assert getattr(ts, k) == getattr(js, k), k
    jd = JFa.build_fault_data(js, 4, 4, 4)
    td = TFa.build_fault_data(ts, 4, 4, 4)
    assert td.seed == int(jd.seed) == 5
    for name in JFa.FaultData._fields[1:]:
        a, b = np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    empty = TFa.build_fault_data(None, 4, 4, 4)
    assert all(getattr(empty, n).numel() == 0
               for n in TFa.FaultData._fields[1:])
    assert TFa.link_flap(0, 0, 50, TFa.NEVER).last_edge == 50
    assert TFa.FaultSpec().last_edge == 0


@pytest.mark.parametrize("kind", ["link_flap", "uplink_flap", "host_flap",
                                  "link_degrade", "link_corrupt",
                                  "host_corrupt"])
def test_builders_match_jax(kind):
    args = {"link_flap": (1, 2, 3, 40), "uplink_flap": (1, 2, 3, 40),
            "host_flap": (9, 3, 40), "link_degrade": (1, 2, 3, 40, 0.3),
            "link_corrupt": (1, 2, 3, 40, 0.1),
            "host_corrupt": (9, 3, 40, 0.1)}[kind]
    a, b = getattr(JFa, kind)(*args), getattr(TFa, kind)(*args)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# --------------------------------------------------------------------------- #
# Validation
# --------------------------------------------------------------------------- #

def _rejections(m):
    """(spec, topology, message) of the reference's rejection cases."""
    dead = m.with_link_failures(m.TOPO, 1, 1, seed=0)
    dt, ds = sorted(dead.dead_links)[0]
    return [
        (m.link_flap(0, 0, 5, 3), m.TOPO, "negative"),
        (m.link_flap(7, 0, 0, 10), m.TOPO, "out of range"),
        (m.host_flap(99, 0, 10), m.TOPO, "out of range"),
        (m.FaultSpec(link_degrade=((0, 0, 0, 10, 0.0),)), m.TOPO, "credit"),
        (m.link_corrupt(0, 0, 0, 10, 1.5), m.TOPO, "prob"),
        (m.host_corrupt(0, 0, 10, -0.5), m.TOPO, "prob"),
        (m.uplink_flap(dt, ds, 0, 10), dead, "dead_links"),
        (m.link_flap(dt, ds, 0, 10), dead, "dead_links"),
        (m.FaultSpec(link_flaps=tuple((0, s, 10, 50) for s in range(4))),
         m.TOPO, "disconnect"),
    ]


class _Pkg:
    def __init__(self, faults, with_link_failures, topo):
        self.__dict__.update({k: getattr(faults, k) for k in (
            "link_flap", "uplink_flap", "host_flap", "host_corrupt",
            "link_corrupt", "FaultSpec")})
        self.with_link_failures, self.TOPO = with_link_failures, topo


@pytest.mark.parametrize("case", range(9))
def test_validate_faults_rejects_what_the_reference_rejects(case):
    jspec, jtopo, msg = _rejections(
        _Pkg(JFa, j_with_link_failures, j_full_bisection(4, 4)))[case]
    tspec, ttopo, _ = _rejections(
        _Pkg(TFa, with_link_failures, TOPO))[case]
    with pytest.raises(ValueError, match=msg):
        JFa.validate_faults(jspec, jtopo)
    with pytest.raises(ValueError, match=msg):
        TFa.validate_faults(tspec, ttopo)
    with pytest.raises(ValueError, match=msg):
        run(Scenario(name="v", topo=ttopo, net=TNET,
                     messages=PERM.messages), RunConfig(faults=tspec),
            device="cpu")


def test_validate_faults_accepts_inert_and_staggered_windows():
    TFa.validate_faults(TFa.link_flap(0, 0, 0, 0), TOPO)
    TFa.validate_faults(TFa.FaultSpec(link_flaps=tuple(
        (0, s, 10 + 50 * s, 40 + 50 * s) for s in range(4))), TOPO)
    with pytest.raises(TypeError, match="FaultSpec"):
        RunConfig(faults=object())
    with pytest.raises(TypeError, match="FaultSpec"):
        TF.run_fabric_trace(TOPO, PERM.messages, 10,
                            TF.FabricConfig(faults=object()), device="cpu")


# --------------------------------------------------------------------------- #
# Dead links, goldens, warp
# --------------------------------------------------------------------------- #

def _dead():
    return (with_link_failures(TOPO, 2, 2, seed=0),
            j_with_link_failures(j_full_bisection(4, 4), 2, 2, seed=0))


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_dead_links_native_equal_their_t0_schedule(protocol):
    """``faults_from_dead_links`` on the fabric with every link alive
    reproduces the natively dead-linked run (ECMP steers off the flapped
    uplinks from tick 0, nothing is blackholed), in the port and in JAX,
    and the two packages agree."""
    dead, jdead = _dead()
    nat = run(permutation_scenario(dead, 64 * 2 ** 10, net=TNET, seed=0),
              RunConfig(protocol=protocol), device="cpu")
    cha = run(permutation_scenario(TOPO, 64 * 2 ** 10, net=TNET, seed=0),
              RunConfig(protocol=protocol,
                        faults=TFa.faults_from_dead_links(dead)),
              device="cpu")
    jcha = j_run(j_permutation(j_full_bisection(4, 4), 64 * 2 ** 10,
                               net=JNET, seed=0),
                 JRunConfig(protocol=protocol,
                            faults=JFa.faults_from_dead_links(jdead)))
    for k in EXACT_KEYS[:12] + ("warp_trips", "end_tick"):
        assert nat[k] == cha[k] == jcha[k], (protocol, k, nat[k], cha[k],
                                             jcha[k])
    assert cha["tx_rows_pkts"] == jcha["tx_rows_pkts"]
    assert cha["win_retx"] == jcha["win_retx"]
    assert cha["blackholed_pkts"] == 0 and cha["unfinished"] == 0


@pytest.mark.parametrize("case", ["perm16_flap_strack", "perm16_flap_roce"])
def test_flap_golden_through_the_port(case, golden_dir):
    """The reference's canonical chaos golden: one ToR-0 uplink flaps in
    [50, 400) ticks while the permutation is in flight."""
    proto = "rocev2" if case.endswith("roce") else "strack"
    sc = permutation_scenario(TOPO, 256 * 2 ** 10, net=TNET, seed=0)
    got = run(sc, RunConfig(protocol=proto,
                            faults=TFa.link_flap(0, 0, 50, 400)),
              device="cpu")
    want = json.loads((golden_dir / f"{case}.json").read_text())
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-6), (case, k)
        else:
            assert got[k] == v, (case, k, got[k], v)
    if proto == "strack":   # spray crosses the flapped uplink
        assert got["blackholed_pkts"] > 0


def test_default_horizon_reaches_past_the_schedule():
    """Without ``n_ticks`` the horizon is the clean one extended past the
    last fault edge by four RTOs, as in the reference."""
    from repro.sim.workloads import _scenario_ticks as j_ticks
    jperm = j_permutation(j_full_bisection(4, 4), 128 * 2 ** 10, net=JNET,
                          seed=0)
    for proto in ("strack", "rocev2"):
        for fields in (MIXED, dict(link_flaps=((0, 0, 10, 50000),)),
                       dict(uplink_flaps=((0, 0, 100, TFa.NEVER),)), {}):
            got = _scenario_ticks(PERM, RunConfig(
                protocol=proto, faults=TFa.FaultSpec(**fields)))
            want = j_ticks(jperm, JRunConfig(
                protocol=proto, faults=JFa.FaultSpec(**fields)))
            assert got == want, (proto, fields)
    assert _scenario_ticks(PERM, RunConfig(faults=TFa.FaultSpec(
        link_flaps=((0, 0, 10, 50000),)))) > 50000
    sc = dataclasses.replace(PERM, faults=TFa.FaultSpec(**MIXED))
    assert _fabric_cfg(sc, RunConfig()).faults == sc.faults


# --------------------------------------------------------------------------- #
# The front door: C12 and C13
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw,match", [
    (dict(active_cap=0), "active_cap must be positive"),
    (dict(active_cap=-3), "active_cap must be positive"),
    (dict(shard=-1), "shard must be >= 0"),
    (dict(trace_every=-1), "trace_every"),
    (dict(active_cap=8, trace_every=1), "no-trace"),
    (dict(shard=2, trace_every=4), "no-trace"),
    (dict(backend="oracle"), "backend"),
    (dict(protocol="tcp"), "protocol"),
    (dict(lb_mode="random"), "lb_mode"),
    (dict(ack_path="direct"), "ack_path"),
])
def test_runconfig_validates_as_the_reference(kw, match):
    """ROADMAP C13: the reference's ``RunConfig.__post_init__`` checks
    (``tests/test_rank_active.py:165-169`` and the others), raised when
    the config is made, in both packages."""
    with pytest.raises(ValueError, match=match):
        JRunConfig(**kw)
    with pytest.raises(ValueError, match=match):
        RunConfig(**kw)


def test_runconfig_accepts_what_the_reference_accepts():
    for kw in (dict(active_cap=1), dict(shard=0), dict(shard=1),
               dict(trace_every=3), dict(backend="events"),
               dict(protocol="rocev2", lb_mode="fixed", ack_path="folded")):
        JRunConfig(**kw)
        RunConfig(**kw)


def test_pfc_delay_ticks_reaches_the_fabric_and_equals_jax():
    """ROADMAP C12: ``RunConfig(pfc_delay_ticks=3)`` on the 200 KB-buffer
    RoCEv2 incast: the delay line is 3 deep (one hop of propagation is 1
    tick here), and every ``FabricState`` leaf after 200 dense ticks
    equals JAX's under the same ``RunConfig``."""
    from repro.sim.workloads import _fabric_cfg as j_fabric_cfg
    jsc = j_incast(j_full_bisection(4, 4), 8, 512 * 2 ** 10, net=JNET)
    sc = incast_scenario(TOPO, 8, 512 * 2 ** 10, net=TNET)
    kw = dict(protocol="rocev2", switch_buffer_bytes=2e5, pfc_delay_ticks=3,
              time_warp=False)
    fcfg = _fabric_cfg(sc, RunConfig(**kw))
    assert fcfg.pfc_delay_ticks == 3
    assert TF._hop_delays(fcfg)["PD"] == 3 != TF._hop_delays(
        dataclasses.replace(fcfg, pfc_delay_ticks=None))["PD"]
    jfin, _ = JF.run_fabric_trace(jsc.topo, jsc.messages, 200,
                                  j_fabric_cfg(jsc, JRunConfig(**kw)))
    tfin, _ = TF.run_fabric_trace(sc.topo, sc.messages, 200, fcfg,
                                  device="cpu")
    assert tuple(tfin.pfc_line.shape) == (3, 16 + 2 * 16)
    bad = diff_leaves(jfin, tfin, ring_rows=48)
    assert not bad, bad[:5]
    assert int(tfin.pauses) > 0
