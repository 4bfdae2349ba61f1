"""The port's STrack core (repro_torch.core) against the JAX reference.

Every function is fed the same random batch of flow states, made with
numpy from a seed: the reference through ``jax.vmap`` of its per-flow
function, the port through its batched version on the CPU.  Results must
match bit for bit (float32 compared as bit patterns): a flipped discrete
decision is a fault, not a tolerance.  Also: ECMP hash, the f32 helpers
(glibc ``sinf``, FMA), the package's import boundary and device rule.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.core.cc as jcc
import repro.core.lb as jlb
import repro.core.reliability as jrel
import repro.core.transport as jtp
from repro.core.params import NetworkSpec as JNet
from repro.core.params import make_strack_params as jparams
from repro.sim.fabric import ecmp_mix as j_ecmp_mix
from repro.sim.topology import _mix

import repro_torch
from repro_torch.convert import to_torch
from repro_torch.core import cc, lb, reliability as rel, transport as tp
from repro_torch.core.params import NetworkSpec, make_strack_params
from repro_torch.numerics import fma32, sinf
from repro_torch.sim.fabric import ecmp_mix

from torch_parity import diff_leaves
from torch_states import (random_cc, random_receiver, random_rel,
                          random_sack, random_spray)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ROOT = Path(__file__).resolve().parents[1]
N = 192
NOW = 100.5
P_PORT = {64: make_strack_params(NetworkSpec(link_gbps=400.0), max_paths=64),
          16: make_strack_params(NetworkSpec(link_gbps=400.0), max_paths=16)}
P_JAX = {64: jparams(JNet(link_gbps=400.0), max_paths=64),
         16: jparams(JNet(link_gbps=400.0), max_paths=16)}


def _jax_tree(cls, d: dict):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _port_tree(cls, d: dict):
    return cls(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _flows(rng, paths=64):
    p = P_PORT[paths]
    d = dict(cc=random_cc(rng, N, p), spray=random_spray(rng, N, p),
             rel=random_rel(rng, N, p))
    jf = jtp.FlowState(cc=_jax_tree(jcc.CCState, d["cc"]),
                       spray=_jax_tree(jlb.SprayState, d["spray"]),
                       rel=_jax_tree(jrel.RelState, d["rel"]))
    return d, jf, to_torch(jf, tp.FlowState)


def _same(ref, port):
    bad = diff_leaves(ref, port)
    assert not bad, bad


def _vmap(fn, *trees):
    return jax.jit(jax.vmap(fn))(*trees)


def _np(x):
    return np.asarray(x)


def _eq(a, b):
    a, b = _np(a), b.numpy()
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.view(np.int32)
    assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------------------- #
# the package boundary
# --------------------------------------------------------------------------- #

def test_port_imports_no_jax_and_nothing_of_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
    code = ("import sys, repro_torch.sim.workloads, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import RunConfig, permutation_scenario, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device()
    sc = permutation_scenario(full_bisection(2, 2), 8192)
    with pytest.raises(RuntimeError, match="cuda"):
        run(sc, RunConfig())
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


# --------------------------------------------------------------------------- #
# hashing and float32 helpers
# --------------------------------------------------------------------------- #

def test_ecmp_mix_bit_exact_past_2_31():
    rng = np.random.default_rng(0)
    info = np.iinfo(np.int32)
    a, b, c = (rng.integers(info.min, info.max, 4096, dtype=np.int32)
               for _ in range(3))
    a[:4] = [0, -1, info.max, info.min]
    want = np.asarray(j_ecmp_mix(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(c)))
    got = ecmp_mix(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    assert np.array_equal(want, got)
    pos = np.abs(a[:64]).astype(np.int64), np.abs(b[:64]), np.abs(c[:64])
    py = [_mix(int(x), int(y), int(z)) for x, y, z in zip(*pos)]
    port = ecmp_mix(*(torch.from_numpy(np.asarray(v)) for v in pos)).numpy()
    assert np.array_equal(np.asarray(py, np.int64).astype(np.int32), port)


def test_sinf_matches_the_c_library():
    libm = ctypes.CDLL("libm.so.6")
    libm.sinf.restype, libm.sinf.argtypes = ctypes.c_float, [ctypes.c_float]
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-3e6, 3e6, 20000),
                        rng.uniform(-130, 130, 20000),
                        rng.uniform(-1, 1, 5000),
                        rng.uniform(-1e-3, 1e-3, 500)]).astype(np.float32)
    want = np.array([libm.sinf(float(v)) for v in x], np.float32)
    got = sinf(torch.from_numpy(x)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_fma32_matches_xla_contraction():
    rng = np.random.default_rng(2)
    a = rng.uniform(-50, 50, 200000).astype(np.float32)
    c = rng.uniform(-50, 50, 200000).astype(np.float32)
    want = jax.jit(lambda a, c: a * np.float32(0.875)
                   + np.float32(0.125) * c)(a, c)
    got = fma32(torch.from_numpy(a), 0.875,
                torch.from_numpy(c) * np.float32(0.125))
    _eq(want, got)


# --------------------------------------------------------------------------- #
# cc.py
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cc_update_and_adjust_match_jax(seed):
    rng = np.random.default_rng(seed)
    p, jp = P_PORT[64], P_JAX[64]
    d = random_cc(rng, N, p)
    acked = (rng.integers(0, 8, N) * 4096).astype(np.float32)
    probe = rng.random(N) < 0.3
    ecn = rng.random(N) < 0.4
    delay = np.where(rng.random(N) < 0.3,
                     rng.choice([0.0, 8.0, 24.0], N),
                     rng.uniform(0, 40, N)).astype(np.float32)
    js = _jax_tree(jcc.CCState, d)
    ps = _port_tree(cc.CCState, d)
    now = jnp.float32(NOW)
    ja = _vmap(lambda s, a, pr: jcc.update_achieved_bdp(s, jp, a, pr, now),
               js, jnp.asarray(acked), jnp.asarray(probe))
    pa = cc.update_achieved_bdp(ps, p, torch.from_numpy(acked),
                                torch.from_numpy(probe), NOW)
    _same(ja, pa)
    jb = _vmap(lambda s, e, dl: jcc.adjust_cwnd(s, jp, e, dl, now), ja,
               jnp.asarray(ecn), jnp.asarray(delay))
    pb = cc.adjust_cwnd(pa, p, torch.from_numpy(ecn),
                        torch.from_numpy(delay), NOW)
    _same(jb, pb)


def test_cc_roadmap_c1_example_follows_jax_f32():
    """ROADMAP C1: in f32, now - last_selfai_ts comes out as exactly
    base_rtt at t = 16.526005, so the fairness increase is skipped (the
    f64 oracle takes it).  The port follows JAX."""
    p, jp = P_PORT[64], P_JAX[64]
    ops = [(False, 0.0, 0.0, False, 3.0),
           (False, 0.0, 0.0, False, 5.52600522677889),
           (False, 0.0, 0.0, False, 7.0),
           (True, 65.0, 0.0, False, 1.0)]
    js = jcc.init_cc(jp)
    ps = cc.init_cc(p, 1, "cpu")
    now = 0.0
    for ecn, delay, acked, probe, dt in ops:
        now += dt
        jnow = jnp.float32(now)
        js = jax.jit(jcc.update_achieved_bdp, static_argnums=1)(
            js, jp, jnp.float32(acked), jnp.asarray(probe), jnow)
        js = jax.jit(jcc.adjust_cwnd, static_argnums=1)(
            js, jp, jnp.asarray(ecn), jnp.float32(delay), jnow)
        pnow = float(np.float32(now))
        ps = cc.update_achieved_bdp(ps, p, torch.tensor([acked]),
                                    torch.tensor([probe]), pnow)
        ps = cc.adjust_cwnd(ps, p, torch.tensor([ecn]),
                            torch.tensor([delay]), pnow)
        for name in cc.CCState._fields:
            _eq(getattr(js, name).reshape(1), getattr(ps, name))
    assert float(ps.cwnd[0]) == pytest.approx(0.125)


# --------------------------------------------------------------------------- #
# lb.py
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,paths", [(0, 64), (1, 64), (2, 16)])
def test_lb_bitmap_and_choose_path_match_jax(seed, paths):
    rng = np.random.default_rng(seed)
    p, jp = P_PORT[paths], P_JAX[paths]
    d = random_spray(rng, N, p)
    ecn = rng.random(N) < 0.5
    pid = rng.integers(0, paths + 1, N).astype(np.int32)
    cwnd = rng.uniform(0.1, 200, N).astype(np.float32)
    js, ps = _jax_tree(jlb.SprayState, d), _port_tree(lb.SprayState, d)
    ju = _vmap(jlb.update_ecn_bitmap, js, jnp.asarray(ecn), jnp.asarray(pid))
    pu = lb.update_ecn_bitmap(ps, torch.from_numpy(ecn), torch.from_numpy(pid))
    _same(ju, pu)
    now = jnp.float32(NOW)
    je, jn = _vmap(lambda s, c: jlb.choose_path(s, jp, c, now), ju,
                   jnp.asarray(cwnd))
    pe, pn = lb.choose_path(pu, p, torch.from_numpy(cwnd), NOW)
    _eq(je, pe)
    _same(jn, pn)


# --------------------------------------------------------------------------- #
# reliability.py
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_receiver_on_data_matches_jax(seed):
    rng = np.random.default_rng(seed)
    p, jp = P_PORT[64], P_JAX[64]
    d = random_receiver(rng, N)
    psn = (d["epsn"] + rng.integers(-5, 530, N)).astype(np.int32)
    psn[:8] = d["epsn"][:8]
    size = np.where(rng.random(N) < 0.7, 4096.0,
                    rng.integers(1, 4096, N)).astype(np.float32)
    ecn, probe = rng.random(N) < 0.4, rng.random(N) < 0.2
    ent = rng.integers(0, 64, N).astype(np.int32)
    ts = rng.uniform(0, 100, N).astype(np.float32)
    args = [psn, size, ecn, ent, ts, probe]
    jr, js = _vmap(lambda r, *a: jrel.receiver_on_data(r, jp, *a),
                   _jax_tree(jrel.ReceiverState, d),
                   *[jnp.asarray(a) for a in args])
    pr, ps = rel.receiver_on_data(_port_tree(rel.ReceiverState, d), p,
                                  *[torch.from_numpy(a) for a in args])
    _same(jr, pr)
    _same(js, ps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shift_left_and_mask_wire_bytes_match_jax(seed):
    rng = np.random.default_rng(seed)
    p, jp = P_PORT[64], P_JAX[64]
    d = random_rel(rng, N, p)
    shift = rng.integers(0, 513, N).astype(np.int32)
    shift[:3] = [0, 512, 511]
    jrs, prs = _jax_tree(jrel.RelState, d), _port_tree(jrel.RelState, d)
    prs = rel.RelState(*prs)
    want = _vmap(jrel._shift_left, jnp.asarray(d["sacked"]),
                 jnp.asarray(shift))
    got = rel._shift_left(torch.from_numpy(d["sacked"]),
                          torch.from_numpy(shift))
    _eq(want, got)
    mask = d["claimed"]
    want = _vmap(lambda m, e, r: jrel._mask_wire_bytes(m, e, r, jp),
                 jnp.asarray(mask), jnp.asarray(d["epsn"]), jrs)
    got = rel._mask_wire_bytes(torch.from_numpy(mask),
                               torch.from_numpy(d["epsn"]), prs, p)
    _eq(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rel_sender_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    p, jp = P_PORT[64], P_JAX[64]
    d = random_rel(rng, N, p)
    sk = random_sack(rng, N, p, d, NOW)
    js, ps = _jax_tree(jrel.RelState, d), _port_tree(rel.RelState, d)
    jsk, psk = _jax_tree(jrel.SackMsg, sk), _port_tree(rel.SackMsg, sk)
    cwnd = rng.uniform(0.125, 97, N).astype(np.float32)
    ach = np.where(rng.random(N) < 0.5, 0.0,
                   rng.uniform(0, 30, N)).astype(np.float32)
    qd = np.where(rng.random(N) < 0.3, 16.0,
                  rng.uniform(0, 40, N)).astype(np.float32)
    now = jnp.float32(NOW)
    t = lambda a: torch.from_numpy(a)

    high = (d["epsn"] + rng.integers(-5, 600, N)).astype(np.int32)
    enter = rng.random(N) < 0.6
    _same(_vmap(lambda r, h, e: jrel._enter_recovery(r, jp, h, e), js,
                jnp.asarray(high), jnp.asarray(enter)),
          rel._enter_recovery(ps, p, t(high), t(enter)))

    jr, jacked = _vmap(lambda r, s, c, a, q: jrel.rel_on_sack(
        r, jp, s, c, a, q, now), js, jsk, jnp.asarray(cwnd),
        jnp.asarray(ach), jnp.asarray(qd))
    pr, packed = rel.rel_on_sack(ps, p, psk, t(cwnd), t(ach), t(qd), NOW)
    _same(jr, pr)
    _eq(jacked, packed)

    jn = _vmap(lambda r, c: jrel.rel_next_psn(r, jp, c), jr,
               jnp.asarray(cwnd))
    pn = rel.rel_next_psn(pr, p, t(cwnd))
    _same(jn[0], pn[0])
    for a, b in zip(jn[1:], pn[1:]):
        _eq(a, b)

    jt = _vmap(lambda r: jrel.rel_on_timer(r, jp, now), jr)
    pt = rel.rel_on_timer(pr, p, NOW)
    _same(jt[0], pt[0])
    _eq(jt[1], pt[1])
    _eq(jax.vmap(jrel.rel_done)(jt[0]), rel.rel_done(pt[0]))


# --------------------------------------------------------------------------- #
# transport.py
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,paths", [(0, 64), (1, 64), (2, 64), (3, 16)])
def test_flow_functions_match_jax(seed, paths):
    rng = np.random.default_rng(seed)
    p, jp = P_PORT[paths], P_JAX[paths]
    d, jf, pf = _flows(rng, paths)
    sk = random_sack(rng, N, p, d["rel"], NOW)
    sk["entropy"] = rng.integers(0, paths + 1, N).astype(np.int32)
    jsk, psk = _jax_tree(jrel.SackMsg, sk), _port_tree(rel.SackMsg, sk)
    now = jnp.float32(NOW)

    ja = _vmap(lambda f, s: jtp.flow_on_sack(f, jp, s, now), jf, jsk)
    pa = tp.flow_on_sack(pf, p, psk, NOW)
    _same(ja, pa)

    jt = _vmap(lambda f: jtp.flow_on_timer(f, jp, now), ja)
    pt = tp.flow_on_timer(pa, p, NOW)
    _same(jt[0], pt[0])
    _same(jt[1], pt[1])

    jn = _vmap(lambda f: jtp.flow_next_packet(f, jp, now), jt[0])
    pn = tp.flow_next_packet(pt[0], p, NOW)
    _same(jn[0], pn[0])
    _same(jn[1], pn[1])

    _eq(jax.vmap(jtp.flow_done)(jn[0]), tp.flow_done(pn[0]))
    je = jax.vmap(lambda f: jtp.flow_next_event(f, jp))(jn[0])
    pe = tp.flow_next_event(pn[0], p)
    _eq(je[0], pe[0])
    _eq(je[1], pe[1])


def test_init_flow_matches_jax():
    p, jp = P_PORT[64], P_JAX[64]
    total = np.array([1, 2, 16, 64, 300], np.int32)
    tail = np.array([100.0, 4096.0, 1.0, 2048.0, 4095.0], np.float32)
    jf = jax.vmap(lambda n, tb: jtp.init_flow(jp, n, tail_bytes=tb))(
        jnp.asarray(total), jnp.asarray(tail))
    pf = tp.init_flow(p, torch.from_numpy(total), torch.from_numpy(tail))
    _same(jf, pf)
    _same(jax.vmap(jrel.init_receiver)(jnp.asarray(total)),
          rel.init_receiver(torch.from_numpy(total)))
