"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Skips without a CUDA device (and imports no JAX, so it also runs on the
card's machine): ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  ``chip_smoke.py`` runs the same checks at the
full perm1024 / incast1024 / perm8k shapes (STrack, RoCEv2, PFC, faults),
at infer1024's under the active set, and at llama3-8b's, mamba2-2.7b's,
zamba2-2.7b's, mixtral-8x22b's and grok-1-314b's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core.params import NetworkSpec
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import (flash_attention_ref, ssd_chunked_ref,
                                     ssd_ref)
from repro_torch.runtime.serve import (greedy_generate, make_decode_step,
                                       make_prefill_step)
from repro_torch.models import lm
from repro_torch.sim import fabric as TF
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import incast_scenario, permutation_scenario

from torch_lm_weights import lm_weights
from torch_parity import (MOE_SERVE_REF_PATHS, SERVE_REF_PATH,
                          SSM_SERVE_REF_PATHS)
from torch_states import (random_cc, random_rel, random_roce_flow,
                          random_roce_msg, random_sack, random_spray)

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [255, 256, 257, 511, 512, 513, 4096, 32768])
def test_ranker_kernel_matches_plain(cuda, m):
    rng = np.random.default_rng(m)
    for span, density in ((97, 0.5), (3, 1.0), (7, 0.0)):
        qid = torch.from_numpy(rng.integers(0, span, m).astype(np.int32))
        flag = torch.from_numpy(rng.random(m) < density)
        qid, flag = qid.to(cuda), flag.to(cuda)
        assert torch.equal(fk.rank_in_queue(qid, flag, 97),
                           fk.rank_in_queue_plain(qid, flag, 97))


def test_fabric_on_the_card_equals_the_cpu(cuda):
    sc = permutation_scenario(full_bisection(8, 16), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, time_warp=True, trace_every=0)
    fk.reset_launches()
    _, m_gpu = TF.run_fabric_trace(sc.topo, sc.messages, 2000, cfg,
                                   device=cuda)
    strack = ("flow_transition", "serve_enqueue")  # the ranker: inside
    assert all((n > 0) == (k in strack) for k, n in fk.launches.items()), \
        fk.launches
    _, m_cpu = TF.run_fabric_trace(sc.topo, sc.messages, 2000, cfg,
                                   device="cpu")
    np.testing.assert_array_equal(m_gpu["done_tick"], m_cpu["done_tick"])
    assert m_gpu["warp_trips"] == m_cpu["warp_trips"]
    assert m_gpu["ecn_marks"] == m_cpu["ecn_marks"]


def _same(a, b):
    """Two output trees equal, float32 bit for bit."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    else:
        assert a == b


def _cuda_tree(cls, d, dev):
    return cls(**{k: torch.from_numpy(np.array(v)).to(dev)
                  for k, v in d.items()})


@pytest.mark.parametrize("t", [2400, 2401, 2403])
@pytest.mark.parametrize("paused", [False, True])
def test_roce_transition_kernel_matches_plain(cuda, t, paused):
    """``csrc/transition_roce.cu`` against the plain RoCEv2 transition on
    random flow states at 1024 lanes (RTOs, DCQCN timers, byte-counter
    stages, rewinding NACKs), with and without paused NICs."""
    from repro_torch.sim import dcqcn_fab as dq
    from repro_torch.numerics import Now
    sc = permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, protocol="rocev2", trace_every=0)
    d = TF.FabricProgram(sc.topo, 1024, 10, cfg, cuda).trans_dims
    rng = np.random.default_rng(t)
    n = 1024
    flow = random_roce_flow(rng, n, d.p, float(Now(t, d.tick_us)))
    fl = _cuda_tree(dq.RoceFlow, flow, cuda)
    due = _cuda_tree(dq.RoceMsg, random_roce_msg(rng, n, flow), cuda)
    sendable = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    src = torch.from_numpy(rng.integers(0, 256, n).astype(np.int32)).to(cuda)
    eff_nic = (torch.from_numpy(rng.random(n) < 0.5).to(cuda) if paused
               else None)
    args = (fl, due, sendable, src, t, d, eff_nic,
            fk.src_index(src, d.n_hosts))
    fk.reset_launches()
    got = fk.flow_transition(*args)
    assert fk.launches["flow_transition_roce"] == 1
    _same(got, fk.flow_transition_plain(*args))
    if t == 2400:
        assert (got[0].rto_fires > fl.rto_fires).any()


def test_strack_transition_pfc_gate_matches_plain(cuda):
    """``csrc/transition.cu``'s PFC gate: random STrack states with half the
    NICs paused (probes withheld, winners held back)."""
    from repro_torch.core.cc import CCState
    from repro_torch.core.lb import SprayState
    from repro_torch.core.reliability import RelState, SackMsg
    from repro_torch.core.transport import FlowState
    from repro_torch.numerics import Now
    sc = permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, pfc=True, trace_every=0)
    d = TF.FabricProgram(sc.topo, 1024, 10, cfg, cuda).trans_dims
    rng = np.random.default_rng(5)
    n, t = 1024, 2400
    rel_d = random_rel(rng, n, d.p)
    flows = FlowState(cc=_cuda_tree(CCState, random_cc(rng, n, d.p), cuda),
                      spray=_cuda_tree(SprayState, random_spray(rng, n, d.p),
                                       cuda),
                      rel=_cuda_tree(RelState, rel_d, cuda))
    due = _cuda_tree(SackMsg, random_sack(rng, n, d.p, rel_d,
                                          float(Now(t, d.tick_us))), cuda)
    sendable = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    src = torch.from_numpy(rng.integers(0, 256, n).astype(np.int32)).to(cuda)
    eff_nic = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    args = (flows, due, sendable, src, t, d, eff_nic,
            fk.src_index(src, d.n_hosts))
    got = fk.flow_transition(*args)
    _same(got, fk.flow_transition_plain(*args))
    assert (got[2].valid & eff_nic[src.long()]).any()


def _random_flows(cuda, protocol, d, n, t, rng):
    """Random flow states and due messages of ``n`` flows (numpy seed)."""
    from repro_torch.core.cc import CCState
    from repro_torch.core.lb import SprayState
    from repro_torch.core.reliability import RelState, SackMsg
    from repro_torch.core.transport import FlowState
    from repro_torch.numerics import Now
    from repro_torch.sim import dcqcn_fab as dq
    now = float(Now(t, d.tick_us))
    if protocol == "rocev2":
        flow = random_roce_flow(rng, n, d.p, now)
        return (_cuda_tree(dq.RoceFlow, flow, cuda),
                _cuda_tree(dq.RoceMsg, random_roce_msg(rng, n, flow), cuda))
    rel_d = random_rel(rng, n, d.p)
    flows = FlowState(cc=_cuda_tree(CCState, random_cc(rng, n, d.p), cuda),
                      spray=_cuda_tree(SprayState, random_spray(rng, n, d.p),
                                       cuda),
                      rel=_cuda_tree(RelState, rel_d, cuda))
    return flows, _cuda_tree(SackMsg, random_sack(rng, n, d.p, rel_d, now),
                             cuda)


def _trans_dims(cuda, protocol):
    sc = permutation_scenario(full_bisection(4, 4), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, protocol=protocol, trace_every=0)
    return TF.FabricProgram(sc.topo, 16, 10, cfg, cuda).trans_dims


#: stress layouts of the sources: case -> (flows, hosts, round-robin
#: modulus or None for the flow count, share of paused NICs)
SRC_CASES = {"one_source": (1024, 1024, None, 0.0),
             "random_src": (1024, 1024, None, 0.0),
             "ties": (1024, 1024, 3, 0.0),
             "paused": (1024, 1024, None, 0.5),
             "perm8k": (8192, 8192, None, 0.0)}


def _src_layout(case, n, n_hosts, rng):
    if case == "one_source":  # more flows than a block has warps
        return np.full(n, 7, np.int32)
    if case == "perm8k":
        return np.arange(n, dtype=np.int32)
    # 256 sources among the hosts, the rest empty
    hosts = np.sort(rng.choice(n_hosts, 256, replace=False))
    return hosts[rng.integers(0, 256, n)].astype(np.int32)


@pytest.mark.parametrize("active", [False, True], ids=["dense", "active"])
@pytest.mark.parametrize("case", sorted(SRC_CASES))
@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_transition_kernels_match_plain_on_source_layouts(cuda, protocol,
                                                          case, active):
    """Both transitions against their plain versions, bit for bit, on
    random flow states at timer and other ticks, over source layouts that
    stress the arbitration by source blocks: every flow on one source (a
    block walks it twice), 256 random sources among 1024 hosts (empty
    hosts between), a round-robin modulus of 3 (scores tie: every lane of
    the minimum is selected), half the NICs paused, and perm8k's 8192
    lanes; dense, and under the active set on a random slate of a third
    of the flows padded to half of them."""
    n, n_hosts, nr, paused = SRC_CASES[case]
    d = _trans_dims(cuda, protocol)._replace(n_hosts=n_hosts,
                                             n_real=nr or n)
    rng = np.random.default_rng([n, len(case), int(active)])
    src = torch.from_numpy(_src_layout(case, n, n_hosts, rng)).to(cuda)
    index = fk.src_index(src, n_hosts)
    eff_nic = (torch.from_numpy(rng.random(n_hosts) < paused).to(cuda)
               if paused else None)
    won = 0
    for t in (2400, 2403):
        flows, due = _random_flows(cuda, protocol, d, n, t, rng)
        if not active:
            sendable = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
            args = (flows, due, sendable, src, t, d, eff_nic, index)
            fk.reset_launches()
            got = fk.flow_transition(*args)
            assert sum(fk.launches.values()) == 1
            _same(got, fk.flow_transition_plain(*args))
        else:
            live = np.sort(rng.choice(n, n // 3, replace=False))
            slate = np.full(n // 2, n, np.int32)
            slate[:live.size] = live
            act = torch.from_numpy(slate).to(cuda)
            args = (due, act, src, t, d, eff_nic, index)
            got = fk.flow_transition_active(TF._clone_tree(flows), *args)
            _same(got, fk.flow_transition_active_plain(
                TF._clone_tree(flows), *args))
        won += int(got[4].sum())
        if case == "ties" and not active:
            per_src = torch.bincount(src[got[4]].long(), minlength=n_hosts)
            assert int(per_src.max()) > 1   # tied winners on one NIC
    assert won > 0


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_transition_kernels_on_an_all_padded_slate(cuda, protocol):
    """Every lane of the slate N: zero offers, nothing selected, the flow
    record untouched, as the plain version."""
    d = _trans_dims(cuda, protocol)._replace(n_hosts=1024, n_real=1024)
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.integers(0, 1024, 1024).astype(np.int32)
                           ).to(cuda)
    flows, due = _random_flows(cuda, protocol, d, 1024, 2400, rng)
    act = torch.full((512,), 1024, dtype=torch.int32, device=cuda)
    args = (due, act, src, 2400, d, None, fk.src_index(src, 1024))
    mine = TF._clone_tree(flows)
    got = fk.flow_transition_active(mine, *args)
    _same(got, fk.flow_transition_active_plain(TF._clone_tree(flows), *args))
    _same(mine, flows)
    assert not bool(got[4].any())


@pytest.mark.parametrize("protocol", ["rocev2", "strack"])
def test_serve_and_pfc_account_kernels_match_plain_under_pfc(cuda, protocol):
    """The serve/enqueue chain with its paused rows, and the PFC stage, on
    dense ticks of the 4x4 incast with a 200 KB buffer (paused NICs and
    rows from tick 21)."""
    sc = incast_scenario(full_bisection(4, 4), 8, 512 * 2 ** 10,
                         net=NetworkSpec(link_gbps=400.0))
    cfg = TF.FabricConfig(net=sc.net, protocol=protocol, pfc=True,
                          trace_every=0, switch_buffer_bytes=2e5)
    prog = TF.FabricProgram(sc.topo, len(sc.messages), 200, cfg, cuda)
    src, dst, total, tails, ent0 = TF._flow_arrays(sc.flows, cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(sc.messages),
              cfg.lb_mode, ent0)
    st = prog.init_state()
    gated = 0
    for t in range(120):
        eff_nic, prow = prog.eff_pause(st, t)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic)
        out = fk.flow_transition(*targs)
        _same(out, fk.flow_transition_plain(*targs))
        _, tx, ptx, pv, sel, _ = out
        sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow)
        rings = [type(st.q)(*[f.clone() for f in st.q]) for _ in range(2)]
        res = fk.serve_enqueue(rings[0], *sargs[1:])
        _same(res, fk.serve_enqueue_plain(rings[1], *sargs[1:]))
        _same(tuple(f[:prog.Q] for f in rings[0]),
              tuple(f[:prog.Q] for f in rings[1]))
        pargs = (prog.pfc_state(st), res[3], res[2], res[5], res[6], res[9],
                 res[7], rings[0], res[0], st.qsize, res[1], t,
                 prog.pfc_flows, prog.pfc_dims)
        _same(fk.pfc_account(*pargs), fk.pfc_account_plain(*pargs))
        gated += int((prow & (st.qsize[:prog.Q] > 0)).sum())
        st, _, _ = prog.tick(st, t)
    assert gated > 0 and int(st.pauses) > 0


def test_rocev2_pfc_fabric_on_the_card_equals_the_cpu(cuda):
    sc = incast_scenario(full_bisection(4, 4), 8, 512 * 2 ** 10,
                         net=NetworkSpec(link_gbps=400.0))
    cfg = TF.FabricConfig(net=sc.net, protocol="rocev2", time_warp=True,
                          trace_every=0, switch_buffer_bytes=2e5)
    fk.reset_launches()
    fin_g, m_gpu = TF.run_fabric_trace(sc.topo, sc.messages, 3000, cfg,
                                       device=cuda)
    assert fk.launches["flow_transition_roce"] > 0
    assert fk.launches["pfc_account"] > 0
    fin_c, m_cpu = TF.run_fabric_trace(sc.topo, sc.messages, 3000, cfg,
                                       device="cpu")
    np.testing.assert_array_equal(m_gpu["done_tick"], m_cpu["done_tick"])
    for k in ("warp_trips", "pauses", "drops", "ecn_marks", "gbn_rewinds",
              "rto_fires"):
        assert m_gpu[k] == m_cpu[k], k
    _same(tuple(x.cpu() for x in fin_g.flows), fin_c.flows)


def _program(sc, dev, n_ticks, **kw):
    cfg = TF.FabricConfig(net=sc.net, trace_every=0, **kw)
    prog = TF.FabricProgram(sc.topo, len(sc.messages), n_ticks, cfg, dev)
    src, dst, total, tails, ent0 = TF._flow_arrays(sc.flows, cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(sc.messages),
              cfg.lb_mode, ent0)
    return prog


def _to_cpu(tree):
    """``tree`` (tensors in tuples and named tuples) with every tensor on
    the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple):
        items = [_to_cpu(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _serve_and_pfc(prog, st, t, sargs, lanes=None):
    """serve/enqueue on ``sargs`` and, under PFC, the PFC stage on its
    result, each against its plain version on the same inputs.  The PFC
    stage is held against its plain version on the CPU, whose
    ``index_add_`` sums a queue's bytes in candidate order (on the card
    its atomics may not)."""
    rings = [type(st.q)(*[f.clone() for f in st.q]) for _ in range(2)]
    res = fk.serve_enqueue(rings[0], *sargs[1:])
    _same(res, fk.serve_enqueue_plain(rings[1], *sargs[1:]))
    _same(tuple(f[:prog.Q] for f in rings[0]),
          tuple(f[:prog.Q] for f in rings[1]))
    if prog.pfc:
        pargs = (prog.pfc_state(st), res[3], res[2], res[5], res[6], res[9],
                 res[7], rings[0], res[0], sargs[2], res[1], t,
                 prog.pfc_flows, prog.pfc_dims, lanes)
        _same(_to_cpu(fk.pfc_account(*pargs)),
              fk.pfc_account_plain(*_to_cpu(pargs)))
    return res


def _fractional(x) -> bool:
    return bool((x != torch.floor(x)).any())


@pytest.mark.parametrize("msg_bytes", [256 * 2 ** 10, 256 * 2 ** 10 - 0.7],
                         ids=["whole", "fractional"])
@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_serve_enqueue_kernel_on_large_buckets_and_ring_wrap(
        cuda, protocol, msg_bytes):
    """The one-launch serve/enqueue (and under RoCEv2 the PFC stage) on the
    cases the walk of a bucket and the ring's wrap make hard, against the
    plain versions: a 8x16 incast whose host-down queue 0 takes every
    sender's advance (dense ticks that drop); every lane's data and probe
    injected into one row (a bucket of about 2 N, past the fixed bucket
    slots), into a host-down and a ToR uplink row; a probe burst (every
    probe valid); every row's packets moved along its ring so that its
    tail is at the ring's last slots, alone and with the one bucket.
    Messages of a whole number of MTUs, and 0.7 bytes short of it, whose
    fractional tails make the order of the PFC stage's float sums show
    (the case asserts that fractional bytes were in play)."""
    sc = incast_scenario(full_bisection(8, 16), 64, msg_bytes,
                         net=NetworkSpec(link_gbps=400.0))
    prog = _program(sc, cuda, 400, protocol=protocol)
    st = prog.init_state()
    drops, frac = 0, False
    for t in range(120):
        eff_nic, prow = prog.eff_pause(st, t)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic)
        _, tx, ptx, pv, sel, _ = fk.flow_transition(*targs)
        sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow)
        if t % 8 == 0 or t >= 100:
            res = _serve_and_pfc(prog, st, t, sargs)
            drops += int(res[8])
            frac |= _fractional(res[9][res[7]])
            if prog.pfc:
                frac |= _fractional(prog.pfc_state(st).qbytes)
        if t in (60, 104):
            L, TS, cap = prog.N, prog.TS, prog.cap
            ones = torch.ones((L,), dtype=torch.bool, device=cuda)
            burst = list(sargs)
            burst[14] = ones
            _serve_and_pfc(prog, st, t, tuple(burst))
            for row in (2 * TS + 3, 5):
                one = list(sargs)
                one[15] = torch.full((L,), row, dtype=torch.int32,
                                     device=cuda)
                one[16] = one[15]
                one[13] = ones
                one[14] = torch.arange(L, device=cuda) % 3 == 0
                res = _serve_and_pfc(prog, st, t, tuple(one))
                # lossy queues drop the bucket's tail; PFC's drop nothing
                assert (int(res[8]) > 0) == (not prog.pfc)
                assert bool(res[7][2 * TS:].any())
            for end in (cap - 1, cap - 2):  # each row's tail at slot end
                shift = (end - sargs[1] - sargs[2]) % cap
                shift[-1] = 0
                cols = (torch.arange(cap, device=cuda)[None, :]
                        - shift[:, None]) % cap
                rolled = st._replace(q=type(st.q)(
                    *[f.gather(1, cols.long()) for f in st.q]))
                wrap = list(sargs)
                wrap[1] = sargs[1] + shift
                _serve_and_pfc(prog, rolled, t, tuple(wrap))
                _serve_and_pfc(prog, rolled, t,
                               tuple(wrap[:13] + one[13:17] + wrap[17:]))
        st, _, _ = prog.tick(st, t)
    assert drops > 0 or protocol == "rocev2"
    assert frac == (msg_bytes % 1 != 0)


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_serve_and_pfc_kernels_at_perm8k_shapes(cuda, protocol):
    """serve/enqueue and (RoCEv2) the PFC stage on dense ticks of perm8k
    (``full_bisection(128, 64)``: Q = 24576 rows, M = 32768 candidates,
    HPT + S = 128 counters a ToR warp)."""
    sc = permutation_scenario(full_bisection(128, 64), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    prog = _program(sc, cuda, 100, protocol=protocol)
    assert (prog.Q, 2 * prog.TS + 2 * prog.N) == (24576, 32768)
    st = prog.init_state()
    for t in range(20):
        eff_nic, prow = prog.eff_pause(st, t)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic)
        _, tx, ptx, pv, sel, _ = fk.flow_transition(*targs)
        sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow)
        if t in (3, 8, 16, 19):
            _serve_and_pfc(prog, st, t, sargs)
        st, _, _ = prog.tick(st, t)


def test_serve_and_pfc_are_one_launch_each(cuda):
    """On CUDA tensors one serve_enqueue call and one pfc_account call each
    run exactly one device operation, their own kernel (no memset, no
    ranker): ``torch.profiler`` over 10 calls at an incast tick under
    RoCEv2 + PFC."""
    from torch.profiler import ProfilerActivity, profile
    sc = incast_scenario(full_bisection(4, 4), 8, 512 * 2 ** 10,
                         net=NetworkSpec(link_gbps=400.0))
    prog = _program(sc, cuda, 200, protocol="rocev2",
                    switch_buffer_bytes=2e5)
    st = prog.init_state()
    for t in range(40):
        st, _, _ = prog.tick(st, t)
    eff_nic, prow = prog.eff_pause(st, 40)
    targs = prog.transport_args(st, 40, prog.sendable_msg(st, 40), eff_nic)
    _, tx, ptx, pv, sel, _ = fk.flow_transition(*targs)
    sargs, _, _ = prog.serve_args(st, 40, tx, ptx, sel, pv, prow)
    ring = type(st.q)(*[f.clone() for f in st.q])
    res = fk.serve_enqueue(ring, *sargs[1:])
    pargs = (prog.pfc_state(st), res[3], res[2], res[5], res[6], res[9],
             res[7], ring, res[0], st.qsize, res[1], 40, prog.pfc_flows,
             prog.pfc_dims)
    for fn, own in ((lambda: fk.serve_enqueue(ring, *sargs[1:]),
                     "serve_enqueue_kernel"),
                    (lambda: fk.pfc_account(*pargs), "pfc_kernel")):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        events = {ev.key: ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA}
        assert len(events) == 1, events
        ((name, count),) = events.items()
        assert own in name and count == 10, events


def test_transition_paths_are_one_launch_each(cuda):
    """On CUDA tensors each transition call runs exactly one device
    operation, its own kernel (no memset, no second kernel):
    ``torch.profiler`` over 10 calls of each path, STrack dense, STrack
    with the PFC gate, RoCEv2 + PFC, and the active set under STrack and
    under RoCEv2 + PFC, in one profiler session (each call's events in
    turn: exactly its kernel, ten times)."""
    from torch.profiler import ProfilerActivity, profile
    inc = incast_scenario(full_bisection(4, 4), 8, 512 * 2 ** 10,
                          net=NetworkSpec(link_gbps=400.0))
    perm = permutation_scenario(full_bisection(8, 16), 64 * 2 ** 10,
                                net=NetworkSpec(link_gbps=400.0), seed=0)
    calls = []
    for what, sc, kw, own in (
            ("strack dense", perm, {}, "strack_kernel"),
            ("strack pfc", inc, dict(pfc=True, switch_buffer_bytes=2e5),
             "strack_kernel"),
            ("rocev2 pfc", inc, dict(protocol="rocev2",
                                     switch_buffer_bytes=2e5),
             "roce_kernel")):
        prog = _program(sc, cuda, 200, **kw)
        st = prog.init_state()
        for t in range(40):
            st, _, _ = prog.tick(st, t)
        eff_nic, _ = prog.eff_pause(st, 40)
        targs = prog.transport_args(st, 40, prog.sendable_msg(st, 40),
                                    eff_nic)
        calls.append((what, lambda a=targs: fk.flow_transition(*a), own))
    for protocol, own in (("strack", "strack_kernel"),
                          ("rocev2", "roce_kernel")):
        _, _, prog = _open_loop_program(cuda, 200, protocol=protocol)
        st = prog.init_state()
        for t in range(60):
            st, _, _ = prog.tick(st, t)
        sendable = prog.sendable_msg(st, 60)
        lanes, _ = prog.lane_slate(sendable[prog.dep.msg_of_flow.long()]
                                   & ~prog.proto.done(st.flows))
        eff_nic, _ = prog.eff_pause(st, 60)
        targs = prog.transport_args(st, 60, sendable, eff_nic, lanes)
        fl = TF._clone_tree(targs[0])
        calls.append((f"{protocol} active", lambda f=fl, a=targs:
                      fk.flow_transition_active(f, *a[1:]), own))
    for _, fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, fn, _ in calls:
            for _ in range(10):
                fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    assert len(evs) == 10 * len(calls), sorted({e.name for e in evs})
    for i, (what, _, own) in enumerate(calls):
        mine = evs[10 * i:10 * (i + 1)]
        assert all(own in e.name for e in mine), (what, mine[0].name)


def test_pfc_account_kernel_with_an_all_padded_slate(cuda):
    """The PFC stage under the active set when no lane holds a flow (every
    lane of the slate N): the capped open-loop trace under RoCEv2 + PFC,
    the transition, serve/enqueue and the PFC stage on that slate against
    their plain versions at ticks where the queues hold packets."""
    _, _, prog = _open_loop_program(cuda, 200, protocol="rocev2")
    st = prog.init_state()
    held = 0
    for t in range(150):
        if t in (40, 80, 120, 149):
            lanes = prog.lanes(torch.full((prog.A,), prog.N,
                                          dtype=torch.int32, device=cuda))
            eff_nic, prow = prog.eff_pause(st, t)
            targs = prog.transport_args(st, t, prog.sendable_msg(st, t),
                                        eff_nic, lanes)
            out = fk.flow_transition_active(TF._clone_tree(targs[0]),
                                            *targs[1:])
            _same(out, fk.flow_transition_active_plain(
                TF._clone_tree(targs[0]), *targs[1:]))
            _, tx, ptx, pv, sel, _, _ = out
            sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow,
                                          None, lanes)
            res = _serve_and_pfc(prog, st, t, sargs, lanes.idx)
            assert not bool(res[7][2 * prog.TS:].any())
            held += int(st.qsize[:prog.Q].sum())
        st, _, _ = prog.tick(st, t)
    assert held > 0


#: Every fault class at once on a 4x4 fabric (tests/test_torch_faults_state.py).
FAULTS44 = dict(link_flaps=((0, 0, 10, 60),), uplink_flaps=((1, 2, 5, 120),),
                host_flaps=((5, 30, 80),),
                link_degrade=((1, 1, 0, 200, 0.5),),
                link_corrupt=((2, 2, 0, 300, 0.05),),
                host_corrupt=((7, 0, 300, 0.2),), seed=3)


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_serve_kernel_fault_branches_match_plain(cuda, protocol):
    """The serve/enqueue chain with its fault rows (down, duty, corruption
    draw) against its plain version on dense ticks of a 4x4 permutation
    under every fault class; the ticks must show a down row that pops, a
    duty-closed row with a ready head, a corrupted survivor and a
    survivor on a corrupting row that the draw spares."""
    sc = permutation_scenario(full_bisection(4, 4), 128 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, protocol=protocol, trace_every=0,
                          faults=TFa.FaultSpec(**FAULTS44))
    prog = TF.FabricProgram(sc.topo, len(sc.messages), 300, cfg, cuda)
    src, dst, total, tails, ent0 = TF._flow_arrays(sc.flows, cfg)
    prog.bind(src, dst, total, tails, TF._arrival_array(sc.messages),
              cfg.lb_mode, ent0)
    st = prog.init_state()
    seen = dict(down_pops=0, duty_closed=0, corrupted=0, spared=0)
    for t in range(300):
        eff_nic, prow = prog.eff_pause(st, t)
        fm = prog.fault_masks(t)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic)
        _, tx, ptx, pv, sel, _ = fk.flow_transition(*targs)
        sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow, fm)
        rings = [type(st.q)(*[f.clone() for f in st.q]) for _ in range(2)]
        res = fk.serve_enqueue(rings[0], *sargs[1:])
        _same(res, fk.serve_enqueue_plain(rings[1], *sargs[1:]))
        _same(tuple(f[:prog.Q] for f in rings[0]),
              tuple(f[:prog.Q] for f in rings[1]))
        pop, has, surv = res[2], res[3], res[10]
        ready = (st.qsize[:prog.Q] > 0) & (pop.ready <= t)
        seen["down_pops"] += int((has & fm.row_down).sum())
        seen["duty_closed"] += int((ready & ~fm.row_duty).sum())
        seen["corrupted"] += int(res[12])
        seen["spared"] += int((surv & ~pop.probe
                               & (fm.row_cor_p > 0)).sum())
        st, _, _ = prog.tick(st, t)
    assert all(v > 0 for v in seen.values()), seen


def test_fault_draw_kernel_matches_plain(cuda):
    """The serve kernel's splitmix64 draw against ``fault_u01`` on a grid
    of keys: rows of a 1024-host fabric, ticks from 0 to near 2^30 and
    psns over the int32 range, negative ones included."""
    from repro_torch.kernels import _cuda_bind
    rng = np.random.default_rng(0)
    n = 1 << 16
    row = rng.integers(0, 3072, n).astype(np.int32)
    t = np.concatenate([rng.integers(0, 30000, n // 2),
                        rng.integers(2 ** 30 - 4096, 2 ** 30 + 4096,
                                     n // 2)]).astype(np.int32)
    psn = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    for seed in (0, 3, 2 ** 31 - 1):
        got = _cuda_bind.fault_draw(fk._lib("serve_enqueue"), seed,
                                    *[torch.from_numpy(a).to(cuda)
                                      for a in (row, t, psn)])
        want = TFa.fault_u01(seed, torch.from_numpy(row),
                             torch.from_numpy(t), torch.from_numpy(psn))
        _same(got.cpu(), want)


def test_faulted_fabric_on_the_card_equals_the_cpu(cuda):
    sc = permutation_scenario(full_bisection(4, 4), 128 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    for protocol in ("strack", "rocev2"):
        cfg = TF.FabricConfig(net=sc.net, protocol=protocol, time_warp=True,
                              trace_every=0,
                              faults=TFa.FaultSpec(**FAULTS44))
        fk.reset_launches()
        fin_g, m_gpu = TF.run_fabric_trace(sc.topo, sc.messages, 6000, cfg,
                                           device=cuda)
        assert fk.launches["serve_enqueue"] > 0
        fin_c, m_cpu = TF.run_fabric_trace(sc.topo, sc.messages, 6000, cfg,
                                           device="cpu")
        np.testing.assert_array_equal(m_gpu["done_tick"], m_cpu["done_tick"])
        for k in ("warp_trips", "drops", "ecn_marks", "blackholed_pkts",
                  "corrupt_drops", "retransmits"):
            assert m_gpu[k] == m_cpu[k], (protocol, k)
        np.testing.assert_array_equal(m_gpu["win_retx"], m_cpu["win_retx"])
        assert m_cpu["blackholed_pkts"] > 0 and m_cpu["corrupt_drops"] > 0


def _open_loop_program(dev, n_ticks, **kw):
    """The capped program (32 lanes of 40 flows) of the active-set state
    tests' open-loop 4x4 trace (``torch_parity.OPEN_LOOP_TENANTS``), built
    with the port's generator, on ``dev``."""
    from repro_torch.sim.traffic import InferenceTenant, mixed_scenario
    from torch_parity import OPEN_LOOP_TENANTS
    sc, _ = mixed_scenario(full_bisection(4, 4), (),
                           [InferenceTenant(**t) for t in OPEN_LOOP_TENANTS],
                           net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, trace_every=0, active_cap=32, **kw)
    return sc, cfg, TF.trace_program(sc.topo, sc.messages, n_ticks, cfg, dev)


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_active_set_kernels_match_plain(cuda, protocol):
    """The active transition (on clones of the flow record, which it
    updates in place), the lane-mapped serve/enqueue and, under RoCEv2's
    PFC, the PFC stage with the lanes' sources, against their plain
    versions on 200 dense ticks of the capped open-loop trace, where the
    slate holds padded lanes, fills to its last lane and holds flow N-1."""
    _, _, prog = _open_loop_program(cuda, 200, protocol=protocol)
    st = prog.init_state()
    padded = full = 0
    for t in range(200):
        eff_nic, prow = prog.eff_pause(st, t)
        sendable = prog.sendable_msg(st, t)
        lanes, _ = prog.lane_slate(sendable[prog.dep.msg_of_flow.long()]
                                   & ~prog.proto.done(st.flows))
        targs = prog.transport_args(st, t, sendable, eff_nic, lanes)
        out = fk.flow_transition_active(TF._clone_tree(targs[0]),
                                        *targs[1:])
        _same(out, fk.flow_transition_active_plain(
            TF._clone_tree(targs[0]), *targs[1:]))
        _, tx, ptx, pv, sel, _, _ = out
        sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow, None,
                                      lanes)
        rings = [type(st.q)(*[f.clone() for f in st.q]) for _ in range(2)]
        res = fk.serve_enqueue(rings[0], *sargs[1:])
        _same(res, fk.serve_enqueue_plain(rings[1], *sargs[1:]))
        _same(tuple(f[:prog.Q] for f in rings[0]),
              tuple(f[:prog.Q] for f in rings[1]))
        if prog.pfc:
            pargs = (prog.pfc_state(st), res[3], res[2], res[5], res[6],
                     res[9], res[7], rings[0], res[0], st.qsize, res[1], t,
                     prog.pfc_flows, prog.pfc_dims, lanes.idx)
            _same(fk.pfc_account(*pargs), fk.pfc_account_plain(*pargs))
        ok = lanes.idx < prog.N
        padded += int((~ok).any())
        full += int(ok.all())
        st, _, _ = prog.tick(st, t)
    assert padded > 0 and full > 0


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_capped_fabric_on_the_card_equals_the_cpu(cuda, protocol):
    sc, cfg, _ = _open_loop_program(cuda, 6000, protocol=protocol)
    cfg = dataclasses.replace(cfg, time_warp=True)
    fk.reset_launches()
    fin_g, m_gpu = TF.run_fabric_trace(sc.topo, sc.messages, 6000, cfg,
                                       device=cuda)
    name = ("flow_transition_roce_active" if protocol == "rocev2"
            else "flow_transition_active")
    assert fk.launches[name] > 0 and fk.launches["serve_enqueue"] > 0
    assert fk.launches["flow_transition"] == 0
    assert fk.launches["flow_transition_roce"] == 0
    fin_c, m_cpu = TF.run_fabric_trace(sc.topo, sc.messages, 6000, cfg,
                                       device="cpu")
    np.testing.assert_array_equal(m_gpu["done_tick"], m_cpu["done_tick"])
    for k in ("warp_trips", "pauses", "drops", "ecn_marks", "retransmits",
              "group_done_us"):
        assert m_gpu[k] == m_cpu[k], k
    _same(_cpu(fin_g.flows), fin_c.flows)


def _cpu(tree):
    if isinstance(tree, tuple):
        return type(tree)(*[_cpu(v) for v in tree])
    return tree.cpu()


@pytest.mark.parametrize("B,H,K,Tq,Tk,hd,causal,window,q_offset", [
    (1, 4, 4, 128, 128, 64, True, None, 0),
    (2, 8, 2, 256, 256, 64, True, None, 0),
    (1, 4, 1, 128, 384, 128, True, None, 0),
    (2, 2, 2, 100, 100, 32, True, None, 0),
    (1, 2, 2, 64, 192, 64, False, None, 0),
    (1, 2, 2, 256, 256, 64, True, 96, 0),
    (2, 4, 2, 1, 512, 64, True, None, 300),
    (3, 4, 1, 1, 100, 16, True, None, 99),
    (1, 2, 1, 8, 8, 16, True, None, -4),
    (1, 4, 4, 200, 200, 80, True, None, 0),       # hd 80, ragged q tile
    (1, 8, 2, 1000, 1000, 128, True, None, 0),    # 1000 = 7 x 128 + 104
    (1, 8, 2, 4, 300, 128, True, None, 296),      # decode, keys split
    (2, 32, 1, 2, 200, 64, True, None, 198),      # decode, 64 rows of MQA
    (1, 4, 2, 4, 8, 16, True, None, -4),          # decode, no live key
])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")])
def test_flash_attention_kernel_matches_plain(cuda, B, H, K, Tq, Tk, hd,
                                              causal, window, q_offset,
                                              dtypes):
    """The CUDA kernel against its plain version on the card, on the cases
    of tests/test_torch_flash.py and the edges of the tc and decode routes
    (hd 80, a ragged q tile, the decode's key split, a row with no live
    key): 2e-5 in f32, 2e-2 in bf16.  The call takes the route _route
    names."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(Tq * 7 + Tk)
    qdt, kvdt = (getattr(torch, d) for d in dtypes)
    q = torch.randn((B, H, Tq, hd), generator=g, device=cuda).to(qdt)
    k = torch.randn((B, K, Tk, hd), generator=g, device=cuda).to(kvdt)
    v = torch.randn((B, K, Tk, hd), generator=g, device=cuda).to(kvdt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches["flash_attention"] == 1
    assert fa.route_launches[fa._route(Tq, hd, qdt, kvdt, H, K)] == 1
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == qdt and got.shape == want.shape
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # model layout: strided views, no copy
    got_t = fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, **kw)
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


def test_llama3_smoke_serve_on_the_card_matches_the_jax_reference(cuda):
    """The f32 SMOKE model on the card: pallas prefill and pallas decode
    (the kernel, q_offset = pos) from an f32 cache against the JAX-made
    reference, 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = json.loads(SERVE_REF_PATH.read_text())
    cfg = dataclasses.replace(get_config(ref["arch"], smoke=True),
                              dtype="float32", attn_impl="pallas")
    params = lm_params_from_jax(lm_weights(cfg, ref["seed"]), cfg)
    toks = torch.tensor(ref["prompt"], dtype=torch.int32, device=cuda)
    fa.reset_launches()
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    want = torch.tensor(ref["prefill_last_logits"], device=cuda)
    torch.testing.assert_close(got.ravel(), want, rtol=1e-4, atol=1e-4)
    cache = lm.init_cache(cfg, ref["batch"], ref["steps"],
                          dtype=torch.float32)
    step = make_decode_step(cfg)
    out = []
    for t in range(ref["steps"]):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
        out.append(logits)
    want = torch.tensor(ref["decode_logits_f32_cache"], device=cuda)
    torch.testing.assert_close(torch.stack(out).ravel(), want, rtol=1e-4,
                               atol=1e-4)
    assert fa.launches["flash_attention"] == cfg.n_layers * (1 + ref["steps"])


@pytest.mark.parametrize("B,H,K,Tq,S,hd,window,q_offset", [
    (2, 8, 2, 1, 16, 64, 16, 0),         # one written slot, 15 never
    (2, 8, 2, 1, 16, 64, 16, 15),        # the ring full
    (2, 8, 2, 1, 16, 64, 16, 16),        # wrapped: slot 0 holds 16
    (2, 8, 2, 1, 16, 64, 5, 37),         # a window shorter than the ring
    (1, 48, 8, 1, 512, 128, 4096, 542),  # mixtral's generate cell
    (1, 48, 8, 1, 4096, 128, 4096, 4159),
    (2, 8, 2, 4, 64, 128, 64, 130),      # 4 rows, keys split over blocks
    (1, 4, 1, 3, 8, 16, 8, 1),           # rows before the first write
])
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")])
def test_flash_attention_decode_reads_a_ring(cuda, B, H, K, Tq, S, hd,
                                             window, q_offset, dtypes):
    """The decode route on a ring cache (position p in slot p % S) against
    its plain version: slots never written, a full ring, wrapped rings
    (one or two runs of live slots), 2e-5 in f32, 2e-2 in bf16."""
    g = torch.Generator(device=cuda).manual_seed(S + q_offset)
    qdt, kvdt = (getattr(torch, d) for d in dtypes)
    q = torch.randn((B, H, Tq, hd), generator=g, device=cuda).to(qdt)
    k = torch.randn((B, K, S, hd), generator=g, device=cuda).to(kvdt)
    v = torch.randn((B, K, S, hd), generator=g, device=cuda).to(kvdt)
    kw = dict(window=window, q_offset=q_offset, ring=True)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.route_launches["decode"] == 1
    want = flash_attention_ref(q, k, v, **kw)
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="ring"):
        fa.flash_attention(q.new_zeros((B, H, 5, hd)), k, v, **kw)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
def test_moe_smoke_serve_on_the_card_matches_the_jax_reference(cuda, arch):
    """The f32 SMOKE model on the card: pallas prefill at the config's
    capacity factor, pallas decode of every prompt position from an f32
    cache (mixtral's ring of 32 wraps at 32) and greedy tokens against the
    JAX-made reference (tests/test_torch_moe.py), 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = json.loads(MOE_SERVE_REF_PATHS[arch].read_text())
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              attn_impl="pallas")
    params = lm_params_from_jax(lm_weights(cfg, ref["seed"]), cfg)
    toks = torch.tensor(ref["prompt"], dtype=torch.int32, device=cuda)
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    want = torch.tensor(ref["prefill_last_logits"], device=cuda)
    torch.testing.assert_close(got.ravel(), want, rtol=1e-4, atol=1e-4)
    steps, new = ref["steps"], ref["new"]
    cache = lm.init_cache(cfg, ref["batch"], steps + new, dtype=torch.float32)
    step = make_decode_step(cfg)
    fa.reset_launches()
    out, tok, gen = [], toks[:, :1], []
    for t in range(steps + new - 1):
        logits, cache = step(params, cache, tok, t)
        if t < steps:
            out.append(logits)
        if t + 1 < steps:
            tok = toks[:, t + 1:t + 2]
        else:
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            gen.append(tok)
    want = torch.tensor(ref["position_logits"], device=cuda)
    torch.testing.assert_close(torch.stack(out).ravel(), want, rtol=1e-4,
                               atol=1e-4)
    assert torch.cat(gen, 1).tolist() == ref["greedy_tokens"]
    assert fa.route_launches["decode"] == cfg.n_layers * (steps + new - 1)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128), (1, 64, 8, 16, 32, 64),
    (2, 45, 3, 16, 8, 128), (1, 512, 3, 72, 128, 128), (2, 96, 2, 8, 20, 48),
    (1, 4096, 80, 64, 128, 128), (4, 1024, 80, 64, 64, 128),
    (2, 960, 3, 72, 20, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain(cuda, B, T, H, P, N, chunk, dtype):
    """The CUDA kernel against its plain version on the card: y and the
    final state, 1e-4 in f32 and 5e-2 in bf16 (the reference's own
    tolerances), on the cases of tests/test_torch_ssd.py, at mamba2's
    (1 x 4096) and zamba2's (4 x 1024, N = 64) prefill shapes and on
    ragged shapes (P = 72: a partial column slice; N = 20; L = 48; 20
    chunks of 48)."""
    _ssd_kernel_vs_plain(cuda, B, T, H, P, N, chunk, dtype, 0.3, 0.0)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [(2, 512, 4, 64, 128, 128),
                                             (2, 960, 3, 72, 20, 48)])
def test_ssd_scan_kernel_with_decays_that_underflow(cuda, B, T, H, P, N,
                                                    chunk):
    """A = -exp(3 + 0.5 z) (~-7 to -55): most decays exp(cs_l - cs_m) and
    chunk decays exp(cs_L) underflow to 0, at the same tolerance."""
    _ssd_kernel_vs_plain(cuda, B, T, H, P, N, chunk, "float32", 0.5, 3.0)


def _ssd_kernel_vs_plain(cuda, B, T, H, P, N, chunk, dtype, a_scale,
                         a_shift):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(T * 7 + N)
    dt_ = getattr(torch, dtype)
    x = torch.randn((B, T, H, P), generator=g, device=cuda).to(dt_)
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * a_scale
                   + a_shift)
    Bm = (torch.randn((B, T, N), generator=g, device=cuda) / N ** 0.5).to(dt_)
    Cm = (torch.randn((B, T, N), generator=g, device=cuda) / N ** 0.5).to(dt_)
    ssd.reset_launches()
    y, state = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ssd.launches["ssd_scan"] == 1
    want_y, want_s = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    assert y.dtype == dt_ and state.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), want_y.to(dt_).float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(state, want_s, rtol=tol, atol=tol)
    if T <= 128:
        seq_y, seq_s = ssd_ref(x, dt, A, Bm, Cm)
        torch.testing.assert_close(y.float(), seq_y, rtol=tol, atol=tol)
        torch.testing.assert_close(state, seq_s, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_smoke_serve_on_the_card_matches_the_jax_reference(cuda, arch):
    """The f32 SMOKE model on the card, SSD through the kernel (and zamba2's
    attention through the flash kernel): prefill and decode from an f32
    cache against the JAX-made reference at 2e-3 (bf16 products, see
    tests/test_torch_ssm.py), greedy tokens exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = json.loads(SSM_SERVE_REF_PATHS[arch].read_text())
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              attn_impl="pallas")
    params = lm_params_from_jax(lm_weights(cfg, ref["seed"]), cfg)
    toks = torch.tensor(ref["prompt"], dtype=torch.int32, device=cuda)
    ssd.reset_launches()
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    assert ssd.launches["ssd_scan"] == cfg.n_layers
    want = torch.tensor(ref["prefill_last_logits"], device=cuda)
    torch.testing.assert_close(got.ravel(), want, rtol=2e-3, atol=2e-3)
    cache = lm.init_cache(cfg, ref["batch"], ref["steps"],
                          dtype=torch.float32)
    step = make_decode_step(cfg)
    out = []
    for t in range(ref["steps"]):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
        out.append(logits)
    want = torch.tensor(ref["decode_logits_f32_cache"], device=cuda)
    torch.testing.assert_close(torch.stack(out).ravel(), want, rtol=2e-3,
                               atol=2e-3)
    gen = greedy_generate(params, cfg, toks, ref["new"],
                          ref["steps"] + ref["new"])
    assert gen.tolist() == ref["greedy_tokens"]


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_sweep_on_the_card_equals_the_cpu(cuda, protocol):
    """A batch of three permutation seeds (RoCEv2: with PFC and entropy
    seeds 0-2) on the card: only the batched kernels launch, and every
    entry's summary, done ticks and warp trips equal the CPU's batch."""
    from repro_torch.sim.workloads import RunConfig, _fabric_cfg, sweep
    scs = [permutation_scenario(full_bisection(4, 4), 64 * 2 ** 10,
                                net=NetworkSpec(link_gbps=400.0), seed=s)
           for s in range(3)]
    cfgs = [RunConfig(protocol=protocol, n_ticks=2000, roce_entropy_seed=s
                      if protocol == "rocev2" else None) for s in range(3)]
    fk.reset_launches()
    gpu = sweep(scs, cfgs, device=cuda)
    want = {"flow_transition_batch" if protocol == "strack"
            else "flow_transition_roce_batch", "serve_enqueue_batch"}
    if protocol == "rocev2":
        want.add("pfc_account_batch")
    assert {k for k, n in fk.launches.items() if n} == want, fk.launches
    assert gpu == sweep(scs, cfgs, device="cpu")
    fcfg = _fabric_cfg(scs[0], cfgs[0])
    _, per = TF.run_fabric_trace_batch(
        scs[0].topo, [sc.messages for sc in scs], 2000, fcfg,
        entropy_seeds=[c.roce_entropy_seed for c in cfgs], device=cuda)
    for sc, c, m in zip(scs, cfgs, per):
        _, solo = TF.run_fabric_trace(sc.topo, sc.messages, 2000,
                                      _fabric_cfg(sc, c), device=cuda)
        np.testing.assert_array_equal(m["done_tick"], solo["done_tick"])
        assert int(m["warp_trips"]) == int(solo["warp_trips"])


def test_batched_kernels_match_plain_on_the_card(cuda):
    """The batched transition and serve/enqueue against their batched
    plain versions on the card at dense ticks of a batch of three seeds,
    every entry stepping and the middle one frozen."""
    from repro_torch.sim.fabric import _clone_tree
    from repro_torch.sim.workloads import RunConfig, _fabric_cfg
    scs = [permutation_scenario(full_bisection(4, 4), 64 * 2 ** 10,
                                net=NetworkSpec(link_gbps=400.0), seed=s)
           for s in range(3)]
    prog = TF.batch_program(scs[0].topo, [sc.messages for sc in scs], 200,
                            _fabric_cfg(scs[0], RunConfig()), device=cuda)
    st = prog.init_state()
    for t in range(41):
        if t in (3, 16, 40):
            for live in (None, torch.tensor([True, False, True],
                                            device=cuda)):
                sm = (st.pending <= 0) & (prog.arrival <= t)
                targs = prog.transport_args(st, t, sm, None, live)
                out = fk.flow_transition_batch(*targs)
                plain = fk.flow_transition_batch_plain(*targs)
                for a, b in zip(fk._tree_leaves(out), fk._tree_leaves(plain)):
                    assert torch.equal(a, b)
                sargs, _, _ = prog.serve_args(st, t, out[1], out[2], out[4],
                                              out[3], None, None, live)
                rings = [_clone_tree(st.q) for _ in range(2)]
                res_k = fk.serve_enqueue_batch(rings[0], *sargs[1:])
                res_p = fk.serve_enqueue_batch_plain(rings[1], *sargs[1:])
                for a, b in zip(fk._tree_leaves(res_k[:11]),
                                fk._tree_leaves(res_p[:11])):
                    assert torch.equal(a, b)
        st, _, _ = prog.tick(st, t)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [(2, 256, 4, 64, 128, 128),
                                             (1, 96, 3, 16, 16, 16),
                                             (2, 40, 2, 5, 7, 8),
                                             (2, 256, 80, 64, 128, 128),
                                             (1, 64, 13, 8, 12, 32)])
def test_ssd_scan_backward_kernel_matches_twin(cuda, B, T, H, P, N, chunk):
    """SsdScanFn's gradients (the backward kernel) against the plain twin's
    (autograd through the plain scan) within 1e-4 of each gradient's
    largest magnitude, the final state's gradient included; two calls give
    the same bits.  H 80 sums W over eight head groups, H 13 over a group
    and a part of one."""
    g = torch.Generator(device=cuda).manual_seed(B * T + N)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, Bm, Cm, dy = r(B, T, H, P), r(B, T, N), r(B, T, N), r(B, T, H, P)
    dt = torch.nn.functional.softplus(r(B, T, H) - 1.0)
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    dfin = r(B, H, N, P)
    grads = []
    for _ in range(2):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, st = ssd.SsdScanFn.apply(*ins, chunk)
        grads.append(torch.autograd.grad((y * dy).sum() + (st * dfin).sum(),
                                         ins))
    want = ssd.ssd_scan_bwd_plain(dy, x, dt, A, Bm, Cm, chunk, dfin)
    for a, a2, w in zip(*grads, want):
        assert torch.equal(a, a2)
        assert float((a - w).abs().max() / w.abs().max()) <= 1e-4


def test_kernels_without_a_backward_refuse_tensors_that_need_one(cuda):
    """The flash kernel hands back tensors autograd cannot see through:
    CUDA inputs that need a gradient raise.  The SSD scan's wrapper runs
    SsdScanFn, so its output carries the backward kernel."""
    x = torch.randn(1, 32, 2, 16, device=cuda, requires_grad=True)
    dt = torch.rand(1, 32, 2, device=cuda)
    A = -torch.ones(2, device=cuda)
    Bm = torch.randn(1, 32, 8, device=cuda)
    y, _ = ssd.ssd_scan(x, dt, A, Bm, Bm.clone(), chunk=16)
    assert y.grad_fn is not None and y.requires_grad
    with torch.no_grad():
        y, _ = ssd.ssd_scan(x, dt, A, Bm, Bm.clone(), chunk=16)
    assert y.grad_fn is None
    q = torch.randn(1, 2, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa.flash_attention(q, q.detach(), q.detach())
