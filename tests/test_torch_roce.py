"""The port's RoCEv2 transport (``repro_torch.sim.dcqcn_fab``) and PFC gate
against the JAX reference.

Every DCQCN / go-back-N function is fed the same random batch of flows,
receivers and return-pipe messages, made with numpy from a seed
(``tests/torch_states.py``): the reference through ``jax.jit(jax.vmap)``
of its per-flow function with ``now = t * tick_us`` computed inside the
jitted program, as the fabric computes it; the port through its batched
version on the CPU.  Results must match bit for bit.  The batches put the
timer stamps, pacing gates and RTO deadlines on and next to their
thresholds; the tests below also pin how XLA evaluates the float32
expressions that decide them (the pacing tolerance and the ACK/NACK's RTO
deadline are fused multiply-adds of the tick, the CNP's alpha update is
one fused multiply-add; the RTO's own re-arm and ``now + size / rate``
are plain adds, in the fabric program too: ``test_torch_pfc.py``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.params import NetworkSpec as JNet
from repro.core.params import make_roce_params as j_roce_params
from repro.sim import dcqcn_fab as JD
from repro.sim import fabric as JF

from repro_torch.core.params import NetworkSpec, make_roce_params
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.numerics import Now, f32, now_plus
from repro_torch.sim import dcqcn_fab as TD
from repro_torch.sim import fabric as TF

from torch_parity import diff_leaves
from torch_states import random_roce_flow, random_roce_msg, random_roce_rcv

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

N = 4096
JNET, TNET = JNet(link_gbps=400.0), NetworkSpec(link_gbps=400.0)
JP = JD.make_roce_fab_params(JNET, j_roce_params(JNET))
TP = TD.make_roce_fab_params(TNET, make_roce_params(TNET))
TICK = TNET.mtu_serialize_us
TICKS = (2400, 2403, 7777)   # now = t * tick_us; 2400 is a timer tick


def _jax(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _port(cls, d):
    return cls(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _batch(seed, t):
    rng = np.random.default_rng(seed)
    now = float(Now(t, TICK))
    flow = random_roce_flow(rng, N, TP, now)
    msg = random_roce_msg(rng, N, flow)
    rcv = random_roce_rcv(rng, N, now)
    return flow, msg, rcv, rng


def _same(ref, port):
    bad = diff_leaves(ref, port)
    assert not bad, bad


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _eq(a, b):
    return np.array_equal(_bits(a), _bits(b.numpy() if isinstance(
        b, torch.Tensor) else b))


@jax.jit
def _j_next(f, t):
    now = t.astype(jnp.float32) * TICK
    return jax.vmap(lambda x: JD.roce_next_packet(x, JP, now))(f)


@jax.jit
def _j_ack(f, m, t):
    now = t.astype(jnp.float32) * TICK
    return jax.vmap(lambda x, y: JD.roce_on_ack(x, JP, y, now))(f, m)


@jax.jit
def _j_timer(f, t):
    now = t.astype(jnp.float32) * TICK
    return jax.vmap(lambda x: JD.roce_on_timer(x, JP, now))(f)


@jax.jit
def _j_data(r, psn, size, ecn, t):
    now = t.astype(jnp.float32) * TICK
    return jax.vmap(lambda a, b, c, d: JD.roce_on_data(a, JP, b, c, d, now))(
        r, psn, size, ecn)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("t", TICKS)
def test_next_packet_matches_jax(seed, t):
    flow, _, _, _ = _batch(seed, t)
    jf, (jv, jpsn, jent, jrtx) = _j_next(_jax(JD.RoceFlow, flow), jnp.int32(t))
    tf, (tv, tpsn, tent, trtx) = TD.roce_next_packet(
        _port(TD.RoceFlow, flow), TP, Now(t, TICK))
    _same(jf, tf)
    for a, b in ((jv, tv), (jpsn, tpsn), (jent, tent), (jrtx, trtx)):
        assert _eq(a, b)
    v = tv.numpy()
    assert 0 < v.sum() < N                     # both outcomes drawn
    assert (tf.b_stage > _port(TD.RoceFlow, flow).b_stage).any()  # b_hit


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("t", TICKS)
def test_on_ack_matches_jax(seed, t):
    flow, msg, _, _ = _batch(seed, t)
    jf = _j_ack(_jax(JD.RoceFlow, flow), _jax(JD.RoceMsg, msg), jnp.int32(t))
    tf0 = _port(TD.RoceFlow, flow)
    tf = TD.roce_on_ack(tf0, TP, _port(TD.RoceMsg, msg), Now(t, TICK))
    _same(jf, tf)
    assert (tf.gbn_rewinds > tf0.gbn_rewinds).any()     # NACKs rewind
    assert (tf.alpha != tf0.alpha).any()                # CNPs applied
    # the fabric's record gates the whole update on msg.valid
    rec = TF.make_rocev2_protocol(TP)
    _same(jf, rec.on_ack(tf0, _port(TD.RoceMsg, msg), Now(t, TICK)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("t", TICKS)
def test_on_timer_matches_jax(seed, t):
    flow, _, _, _ = _batch(seed, t)
    jf, jprobe = _j_timer(_jax(JD.RoceFlow, flow), jnp.int32(t))
    tf0 = _port(TD.RoceFlow, flow)
    tf, tprobe = TD.roce_on_timer(tf0, TP, Now(t, TICK))
    _same(jf, tf)
    assert _eq(jprobe, tprobe) and not tprobe.any()
    assert (tf.rto_fires > tf0.rto_fires).any()
    assert (tf.last_alpha_ts != tf0.last_alpha_ts).any()
    assert (tf.t_stage > tf0.t_stage).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_next_event_and_done_match_jax(seed):
    flow, _, _, _ = _batch(seed, 2400)
    jt, js = jax.jit(jax.vmap(lambda f: JD.roce_next_event(f, JP)))(
        _jax(JD.RoceFlow, flow))
    tt, ts = TD.roce_next_event(_port(TD.RoceFlow, flow), TP)
    assert _eq(jt, tt) and _eq(js, ts)
    assert np.isinf(ts.numpy()).any() and np.isfinite(ts.numpy()).any()
    assert _eq(jax.vmap(JD.roce_done)(_jax(JD.RoceFlow, flow)),
               TD.roce_done(_port(TD.RoceFlow, flow)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("t", TICKS)
def test_on_data_matches_jax(seed, t):
    _, _, rcv, rng = _batch(seed, t)
    psn = (rcv["epsn"] + rng.integers(-2, 3, N)).astype(np.int32)
    size = np.where(rng.random(N) < 0.5, 4096.0,
                    rng.integers(1, 4097, N)).astype(np.float32)
    ecn = rng.random(N) < 0.5
    jr, jm = _j_data(_jax(JD.RoceRcv, rcv), jnp.asarray(psn),
                     jnp.asarray(size), jnp.asarray(ecn), jnp.int32(t))
    tr, tm = TD.roce_on_data(_port(TD.RoceRcv, rcv), TP, torch.from_numpy(psn),
                             torch.from_numpy(size), torch.from_numpy(ecn),
                             Now(t, TICK))
    _same(jr, tr)
    _same(jm, tm)
    assert tm.cnp.any() and (ecn & ~tm.cnp.numpy()).any()   # paced CNPs
    assert tm.nack.any() and tm.ack.any()


def test_init_and_protocol_record_match_jax():
    rng = np.random.default_rng(3)
    total = rng.integers(0, 50, 64).astype(np.int32)
    ent = rng.integers(0, 1 << 16, 64).astype(np.int32)
    tail = rng.integers(1, 4097, 64).astype(np.float32)
    jproto = JF.make_rocev2_protocol(JP)
    tproto = TF.make_rocev2_protocol(TP)
    jfl, jrc = jproto.init(jnp.asarray(total), jnp.asarray(tail),
                           jnp.asarray(ent))
    tfl, trc = tproto.init(torch.from_numpy(total), torch.from_numpy(tail),
                           torch.from_numpy(ent))
    _same(jfl, tfl)
    _same(jrc, trc)
    _same(JD.empty_roce_msgs(3, 64), TD.empty_roce_msgs(3, 64))
    flow, _, _, _ = _batch(5, 2400)
    jf, tf = _jax(JD.RoceFlow, flow), _port(TD.RoceFlow, flow)
    assert _eq(jax.vmap(jproto.cong_pkts)(jf), tproto.cong_pkts(tf))
    assert _eq(jproto.stat_retx(jf), tproto.stat_retx(tf))
    for k, v in jproto.stat_recovery(jf).items():
        assert _eq(v, tproto.stat_recovery(tf)[k]), k
    assert tproto.name == "rocev2" and not tproto.uses_spray


def test_pacing_tolerance_is_a_fused_multiply_add_of_the_tick():
    """``now + 0.5 * tick_us >= next_send_ts``: XLA fuses ``t * tick_us +
    tick_us / 2`` into one FMA.  At every tick where that differs from the
    twice-rounded sum, a gate placed exactly at the FMA value opens in
    both packages and one ulp above it stays shut; a plain add would have
    shut it on some of those ticks."""
    ts = np.arange(1, 6000, dtype=np.int32)
    half = 0.5 * TICK
    fma = np.array([now_plus(Now(int(t), TICK), half) for t in ts],
                   dtype=np.float32)
    plain = (ts.astype(np.float32) * np.float32(TICK)) + np.float32(half)
    differ = fma != plain
    assert differ.sum() > 100
    ts, fma, plain = ts[differ], fma[differ], plain[differ]

    def one(t, nst):
        f = JD.init_roce_flow(JP, 10, 0)._replace(next_send_ts=nst)
        return JD.roce_next_packet(f, JP, t.astype(jnp.float32) * TICK)[1][0]

    gate = jax.jit(jax.vmap(one))
    above = np.nextafter(fma, np.float32(np.inf))
    for nst, want in ((fma, True), (above, False)):
        got_j = np.asarray(gate(jnp.asarray(ts), jnp.asarray(nst)))
        assert (got_j == want).all()
        n = len(ts)
        f = TD.init_roce_flow(TP, torch.full((n,), 10, dtype=torch.int32),
                              torch.zeros(n, dtype=torch.int32),
                              torch.full((n,), 4096.0))
        got_t = np.array([bool(TD.roce_next_packet(
            f._replace(next_send_ts=torch.full((n,), float(v))), TP,
            Now(int(t), TICK))[1][0][0]) for t, v in zip(ts[:64], nst[:64])])
        assert (got_t == want).all()
    assert (plain < fma).any()   # where a plain add would shut the gate


def test_cnp_alpha_update_is_one_fused_multiply_add():
    """``(1 - g) * alpha + g`` on a CNP: bit-equal to JAX, and JAX's value
    is the single-rounding FMA (a product rounded before the add differs
    on some lanes)."""
    rng = np.random.default_rng(7)
    n = 20000
    flow = random_roce_flow(rng, n, TP, 100.0)
    msg = dict(valid=np.ones(n, bool), ack=np.zeros(n, bool),
               nack=np.zeros(n, bool), cnp=np.ones(n, bool),
               epsn=np.zeros(n, np.int32), bytes_recvd=np.zeros(n, np.float32))
    jf = _j_ack(_jax(JD.RoceFlow, flow), _jax(JD.RoceMsg, msg),
                jnp.int32(1221))
    tf = TD.roce_on_ack(_port(TD.RoceFlow, flow), TP, _port(TD.RoceMsg, msg),
                        Now(1221, TICK))
    assert _eq(jf.alpha, tf.alpha)
    a = flow["alpha"]
    keep, g = np.float32(f32(1 - JP.dcqcn.g)), np.float32(JP.dcqcn.g)
    two_roundings = (a * keep) + g
    assert (two_roundings.view(np.int32)
            != np.asarray(jf.alpha).view(np.int32)).sum() > 0


def test_rto_deadlines_ack_fused_timer_plain():
    """``now + rto_us`` is ``fmaf(t, tick_us, rto_us)`` where an ACK or NACK
    re-arms the RTO, and a twice-rounded sum where the RTO re-arms itself,
    in JAX and in the port; 2400 is a tick where the two differ."""
    flow, msg, _, _ = _batch(11, 2400)
    msg["valid"][:] = True
    msg["nack"][:] = True
    flow["rto_deadline"][:] = 0.0   # every active flow's RTO fires
    for t in (2400, 2401, 4095, 7777):
        now = Now(t, TICK)
        fused = np.float32(now_plus(now, JP.rto_us))
        plain = np.float32(now) + np.float32(JP.rto_us)
        jf = _j_ack(_jax(JD.RoceFlow, flow), _jax(JD.RoceMsg, msg),
                    jnp.int32(t))
        tf = TD.roce_on_ack(_port(TD.RoceFlow, flow), TP,
                            _port(TD.RoceMsg, msg), now)
        assert (np.asarray(jf.rto_deadline) == fused).all()
        assert (tf.rto_deadline.numpy() == fused).all()
        jf, _ = _j_timer(_jax(JD.RoceFlow, flow), jnp.int32(t))
        tf, _ = TD.roce_on_timer(_port(TD.RoceFlow, flow), TP, now)
        fired = np.asarray(jf.rto_fires) > flow["rto_fires"]
        assert fired.any()
        assert (np.asarray(jf.rto_deadline)[fired] == plain).all()
        assert (tf.rto_deadline.numpy()[fired] == plain).all()
        if t == 2400:
            assert fused != plain


def test_pfc_gate_matches_jax():
    rng = np.random.default_rng(0)
    n = 5000
    xoff = rng.integers(0, 600, n).astype(np.float32) * 4096
    ing = np.where(rng.random(n) < 0.5, xoff,
                   np.where(rng.random(n) < 0.5, 0.5 * xoff,
                            rng.uniform(0, 3e6, n))).astype(np.float32)
    # one ulp above (XLA on the CPU flushes subnormals, so not above 0:
    # byte counts are whole numbers and never subnormal)
    ing = np.where((rng.random(n) < 0.2) & (ing > 0),
                   np.nextafter(ing, np.float32(np.inf)), ing
                   ).astype(np.float32)
    paused = rng.random(n) < 0.5
    for xon in (0.5, 0.25):
        want = JF.pfc_gate(jnp.asarray(paused), jnp.asarray(ing),
                           jnp.asarray(xoff), xon)
        got = fk.pfc_gate(torch.from_numpy(paused), torch.from_numpy(ing),
                          torch.from_numpy(xoff), xon)
        assert _eq(want, got)
        assert got.any() and (~got).any()


# --------------------------------------------------------------------------- #
# The fabric under RoCEv2 and PFC end to end (whole-state parity per tick:
# tests/test_torch_pfc.py)
# --------------------------------------------------------------------------- #

def _golden_scenarios():
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import incast_scenario, permutation_scenario
    topo = full_bisection(4, 4)
    return {"perm16_roce": permutation_scenario(topo, 256 * 2 ** 10,
                                                net=TNET, seed=0),
            "incast8_roce": incast_scenario(topo, 8, 512 * 2 ** 10, net=TNET)}


@pytest.mark.parametrize("case", ["incast8_roce", "perm16_roce"])
def test_roce_golden_through_the_port(case, golden_dir):
    import json
    from repro_torch.sim.workloads import RunConfig, run
    got = run(_golden_scenarios()[case], RunConfig(protocol="rocev2"),
              device="cpu")
    want = json.loads((golden_dir / f"{case}.json").read_text())
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-6), (case, k)
        else:
            assert got[k] == v, (case, k, got[k], v)
    assert got["protocol"] == "rocev2"
    for k in ("gbn_rewinds", "rto_fires", "pauses"):
        assert k in got


def test_warp_equals_dense_under_rocev2_and_pfc():
    """The event-horizon loop against dense ticking while pause frames are
    in flight (a 200 KB buffer: pauses, paused NICs and rows)."""
    sc = _golden_scenarios()["incast8_roce"]
    out = []
    for warp in (False, True):
        cfg = TF.FabricConfig(net=TNET, protocol="rocev2", time_warp=warp,
                              trace_every=0, switch_buffer_bytes=2e5)
        out.append(TF.run_fabric_trace(sc.topo, sc.messages, 2500, cfg,
                                       device="cpu"))
    (fd, md), (fw, mw) = out
    np.testing.assert_array_equal(md["done_tick"], mw["done_tick"])
    assert md["fct_us"] == mw["fct_us"]
    for k in ("drops", "pauses", "ecn_marks", "gbn_rewinds", "rto_fires"):
        assert md[k] == mw[k], k
    assert md["pauses"] > 0
    assert all(v is not None for v in md["fct_us"])
    assert mw["warp_trips"] < 2000
    for a, b in zip(fd.flows, fw.flows):
        assert torch.equal(a, b)
    for k in ("qbytes", "ing_host", "ing_sd", "ing_up", "paused_nic",
              "paused_sd", "paused_up", "pfc_line"):
        assert torch.equal(getattr(fd, k), getattr(fw, k)), k


def test_port_resumes_a_jax_state_under_pfc():
    """The JAX state after 40 ticks of the small-buffer RoCEv2 incast,
    carried into the port (``convert.to_torch``), ticked 40 more times by
    the port: every leaf equals the JAX state after 80 ticks."""
    from repro_torch.convert import to_torch
    from repro.sim.topology import full_bisection as j_fb
    from repro.sim.workloads import incast_scenario as j_incast
    jsc = j_incast(j_fb(4, 4), 8, 512 * 2 ** 10, net=JNET)
    kw = dict(protocol="rocev2", switch_buffer_bytes=2e5, time_warp=False,
              trace_every=0)
    j40, _ = JF.run_fabric_trace(jsc.topo, jsc.messages, 40,
                                 JF.FabricConfig(net=JNET, **kw))
    j80, _ = JF.run_fabric_trace(jsc.topo, jsc.messages, 80,
                                 JF.FabricConfig(net=JNET, **kw))
    sc = _golden_scenarios()["incast8_roce"]
    cfg = TF.FabricConfig(net=TNET, **kw)
    prog = TF.FabricProgram(sc.topo, len(sc.messages), 80, cfg, "cpu")
    src, dst, total, tails, ent0 = TF._flow_arrays(sc.flows, cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(sc.messages),
              cfg.lb_mode, ent0)
    st = to_torch(j40, TF.FabricState)
    assert isinstance(st.flows, TD.RoceFlow) and isinstance(st.pipe,
                                                            TD.RoceMsg)
    for t in range(40, 80):
        st, _, _ = prog.tick(st, t)
    assert int(j80.pauses) > 0
    _same_q = diff_leaves(j80, st, ring_rows=prog.Q)
    assert not _same_q, _same_q


@pytest.mark.parametrize("name", ["incast1024_rocev2",
                                  "incast1024_rocev2_lossy",
                                  "incast1024_strack_pfc",
                                  "perm1024_rocev2"])
def test_pfc_reference_file_is_what_jax_computes(name):
    import json
    from torch_parity import PFC_REF_PATHS, pfc_reference
    ref = json.loads(PFC_REF_PATHS[name].read_text())
    assert ref == pfc_reference(name)
    assert ref["unfinished"] == 0
    if name == "incast1024_rocev2":
        assert (ref["pauses"], ref["ecn_marks"], ref["warp_trips"]) == \
            (31, 910, 1072)
    elif name == "incast1024_rocev2_lossy":
        assert ref["drops"] > 0 and ref["rto_fires"] > 0
    elif name == "incast1024_strack_pfc":
        assert ref["pauses"] > 0 and ref["drops"] == 0


def test_port_matches_perm1024_rocev2_reference_on_cpu():
    import json
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, _fabric_cfg,
                                           _scenario_ticks,
                                           permutation_scenario)
    from torch_parity import PFC_REF_PATHS, PFC_SUMMARY_KEYS
    ref = json.loads(PFC_REF_PATHS["perm1024_rocev2"].read_text())
    sc = permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10, net=TNET,
                              seed=0)
    cfg = RunConfig(protocol="rocev2")
    n_ticks = _scenario_ticks(sc, cfg)
    _, m = TF.run_fabric_trace(sc.topo, sc.messages, n_ticks,
                               _fabric_cfg(sc, cfg), device="cpu")
    s = TF.summarize(m)
    assert (n_ticks, m["warp_trips"], m["end_tick"]) == \
        (ref["n_ticks"], ref["warp_trips"], ref["end_tick"]) == \
        (n_ticks, 175, 4452)
    assert [int(v) for v in m["done_tick"]] == ref["done_tick"]
    for k in PFC_SUMMARY_KEYS:
        got = list(s[k]) if isinstance(s[k], tuple) else s[k]
        if isinstance(ref[k], float):
            assert got == pytest.approx(ref[k], rel=1e-6), k
        else:
            assert got == ref[k], k


@pytest.mark.parametrize("seed", [None, 7])
def test_pinned_entropy_matches_jax(seed):
    """Each RoCEv2 flow's one-QP entropy: the (src, dst, index) hash by
    default, ``random.Random(seed)`` draws in flow order with
    ``roce_entropy_seed``; equal to the reference's program inputs."""
    rng = np.random.default_rng(1)
    flows = [(int(s), int(d), float(b)) for s, d, b in zip(
        rng.integers(0, 64, 300), rng.integers(64, 128, 300),
        rng.integers(1, 1 << 20, 300))]
    jarrs = JF._flow_arrays(flows, JF.FabricConfig(
        net=JNET, protocol="rocev2", roce_entropy_seed=seed))
    tarrs = TF._flow_arrays(flows, TF.FabricConfig(
        net=TNET, protocol="rocev2", roce_entropy_seed=seed))
    for a, b in zip(jarrs, tarrs):
        assert _eq(a, b)
