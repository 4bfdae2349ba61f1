"""The front door's batched sweep in the port: ``sweep()``,
``run_fabric_trace_batch`` and ``run_fabric_batch`` against the JAX
package on the CPU.

``sweep()`` over permutation seeds is one batch whose rows equal JAX's
``sweep()`` and the port's ``run()`` of each seed; over one scenario and a
list of configs it puts the three ``lb_mode``s in one batch and splits
protocol and ``subflows`` (static to the program) into groups, rows in
input order.  Both entry points raise the reference's errors with its
text; the active set in a batch raises naming ROADMAP A14 and the event
oracle A10.  The batched kernels' plain versions equal the unbatched ones
entry by entry, a frozen entry coming out as it went in; the batch's
fields of the kernels' C structs stand where their ctypes mirrors put
them.  The final states are held leaf for leaf in
``test_torch_sweep_state.py``.
"""
import pytest
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import workloads as JW
from repro.sim.topology import full_bisection as j_full_bisection

from repro_torch.core.params import NetworkSpec
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.sim import fabric as TF
from repro_torch.sim import workloads as TW
from repro_torch.sim.topology import full_bisection

from torch_parity import differing_leaves, small_scenario, state_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]


def _jax_port_sweep(scs_args, cfgs_kw):
    """``sweep()`` of both packages on 4x4 permutations ``scs_args``
    (seeds) under ``cfgs_kw`` (RunConfig fields each)."""
    j_scs = [small_scenario("jax", "perm", s) for s in scs_args]
    t_scs = [small_scenario("port", "perm", s) for s in scs_args]
    j = JW.sweep(j_scs, [JW.RunConfig(**kw) for kw in cfgs_kw])
    t = TW.sweep(t_scs, [TW.RunConfig(**kw) for kw in cfgs_kw], device="cpu")
    return j, t, t_scs


@pytest.mark.parametrize("axes", ["lb_modes", "protocol_subflows"])
def test_sweep_partitions_static_axes(axes):
    """``sweep()`` over one scenario and a list of configs: the three
    ``lb_mode``s in one batch (data to the program), or protocol and
    ``subflows`` (static: one batch per group, the counterpart of
    ``test_timewarp.py::test_sweep_mixed_static_axes_partition``).  Rows
    come back in input order, each equal to JAX's ``sweep()`` row and to
    the port's ``run()``."""
    if axes == "lb_modes":
        cfgs = [dict(lb_mode=m) for m in ("oblivious", "adaptive", "fixed")]
    else:
        cfgs = [dict(protocol="rocev2", subflows=2, n_ticks=1500),
                dict(protocol="strack", n_ticks=1500),
                dict(protocol="rocev2", subflows=1, n_ticks=1500),
                dict(protocol="strack", subflows=2, n_ticks=1500)]
    j, t, t_scs = _jax_port_sweep([3], cfgs)
    assert len(t) == len(cfgs)
    for kw, jr, tr in zip(cfgs, j, t):
        solo = TW.run(t_scs[0], TW.RunConfig(**kw), device="cpu")
        assert tr == solo, kw
        assert set(tr) == set(jr), kw
        for k in tr:
            assert str(tr[k]) == str(jr[k]), (kw, k, tr[k], jr[k])
        assert tr["unfinished"] == 0


def test_sweep_seeds_one_batch_equals_jax():
    """``sweep(seeds, cfg)`` broadcasts one config over permutation seeds:
    one batch whose rows equal JAX's ``sweep()`` and the port's ``run()``
    of each seed."""
    j, t, t_scs = _jax_port_sweep([0, 1, 2, 3, 4], [dict()])
    for sc, jr, tr in zip(t_scs, j, t):
        assert tr == TW.run(sc, TW.RunConfig(), device="cpu")
        assert {k: str(v) for k, v in tr.items()} == \
            {k: str(v) for k, v in jr.items()}


def _error(fn) -> str:
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    return str(e.value)


#: name -> f(W, scenarios, RunConfig) calling sweep() wrongly
SWEEP_ERRORS = {
    "no_scenarios": lambda W, scs, rc: W.sweep([], rc()),
    "no_configs": lambda W, scs, rc: W.sweep(scs[:1], []),
    "lengths": lambda W, scs, rc: W.sweep(scs[:3], [rc(), rc()]),
    "topology": lambda W, scs, rc: W.sweep([scs[0], scs[3]], rc()),
    "network": lambda W, scs, rc: W.sweep([scs[0], scs[4]], rc()),
    "messages": lambda W, scs, rc: W.sweep([scs[0], scs[5]], rc()),
    "dependencies": lambda W, scs, rc: W.sweep([scs[6], scs[7]], rc()),
}


def _error_scenarios(pkg):
    W, full, Net = ((JW, j_full_bisection, JNet) if pkg == "jax"
                    else (TW, full_bisection, NetworkSpec))
    topo, net = full(4, 4), Net(link_gbps=400.0)
    perm = lambda s, t=topo, n=net: W.permutation_scenario(
        t, 64 * 2 ** 10, net=n, seed=s)
    chain = lambda deps: W.Scenario("chain", topo, net, tuple(
        W.Message(mid=i, src=i, dst=i + 1, size=4096.0, deps=d)
        for i, d in enumerate(deps)))
    return [perm(0), perm(1), perm(2), perm(0, full(2, 4)),
            perm(0, topo, Net(link_gbps=100.0)),
            W.incast_scenario(topo, 4, 4096.0, net=net),
            chain([(), (0,)]), chain([(), ()])]


@pytest.mark.parametrize("what", sorted(SWEEP_ERRORS))
def test_sweep_errors_are_the_references(what):
    """``sweep()`` rejects what the reference rejects, with its text."""
    j = _error(lambda: SWEEP_ERRORS[what](JW, _error_scenarios("jax"),
                                          JW.RunConfig))
    t = _error(lambda: SWEEP_ERRORS[what](TW, _error_scenarios("port"),
                                          TW.RunConfig))
    assert t == j


#: name -> f(F, topo, flows a batch of permutation flow lists, cfg)
BATCH_ERRORS = {
    "empty": lambda F, topo, fl, cfg: F.run_fabric_trace_batch(
        topo, [], 100, cfg, **_dev(F)),
    "lb_modes_length": lambda F, topo, fl, cfg: F.run_fabric_trace_batch(
        topo, [_msgs(F, fl[0])] * 2, 100, cfg, lb_modes=["adaptive"],
        **_dev(F)),
    "unknown_lb_mode": lambda F, topo, fl, cfg: F.run_fabric_trace_batch(
        topo, [_msgs(F, fl[0])], 100, cfg, lb_modes=["random"], **_dev(F)),
    "subflow_count": lambda F, topo, fl, cfg: F.run_fabric_trace_batch(
        topo, [_msgs(F, fl[0]), _msgs(F, fl[0][:3])], 100, cfg, **_dev(F)),
    "shard": lambda F, topo, fl, cfg: F.run_fabric_trace_batch(
        topo, [_msgs(F, fl[0])], 100,
        F.FabricConfig(net=cfg.net, trace_every=0, shard=2), **_dev(F)),
    "flow_lists": lambda F, topo, fl, cfg: F.run_fabric_batch(
        topo, [fl[0], fl[0][:4]], 100, cfg, **_dev(F)),
}


def _dev(F):
    return {} if F is JF else {"device": "cpu"}


def _msgs(F, flows):
    return [F._FlowMsg(mid=i, src=s, dst=d, size=b)
            for i, (s, d, b) in enumerate(flows)]


@pytest.mark.parametrize("what", sorted(BATCH_ERRORS))
def test_batch_errors_are_the_references(what):
    """``run_fabric_trace_batch`` / ``run_fabric_batch`` reject what the
    reference rejects, with its text (``shard > 1``: its ValueError)."""
    out = []
    for F, W, full, Net in ((JF, JW, j_full_bisection, JNet),
                            (TF, TW, full_bisection, NetworkSpec)):
        topo = full(4, 4)
        flows = [list(W.permutation_scenario(topo, 8192.0, seed=s).flows)
                 for s in (0, 1)]
        cfg = F.FabricConfig(net=Net(link_gbps=400.0), time_warp=True,
                             trace_every=0)
        out.append(_error(lambda: BATCH_ERRORS[what](F, topo, flows, cfg)))
    assert out[1] == out[0]


def test_batch_deferred_paths_raise():
    """The active set in a batch raises naming ROADMAP A14 (a cap at or
    above the flow count is the dense program and runs); the event oracle
    raises naming A10, as ``run()`` does."""
    sc = small_scenario("port", "perm", 0)
    with pytest.raises(NotImplementedError, match="A14"):
        TW.sweep([sc, sc], TW.RunConfig(active_cap=8), device="cpu")
    rows = TW.sweep([sc], TW.RunConfig(active_cap=16, n_ticks=400),
                    device="cpu")
    assert rows[0] == TW.run(sc, TW.RunConfig(active_cap=16, n_ticks=400),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        TW.sweep([sc], TW.RunConfig(backend="events"), device="cpu")


def _tick_args(prog, st, t, live):
    eff_nic, prow = prog.eff_pause(st, t)
    sm = (st.pending <= 0) & (prog.arrival <= t)
    return prog.transport_args(st, t, sm, eff_nic, live), prow


@pytest.mark.parametrize("kind,cfg_kw", [
    ("perm", {}), ("incast", dict(protocol="rocev2",
                                  switch_buffer_bytes=2e5))])
def test_batched_plain_versions_entry_by_entry(kind, cfg_kw):
    """The batched plain versions against the unbatched ones entry by
    entry, at dense ticks of a batch of three (every entry stepping, and
    the middle one frozen, which comes out as it went in and serves and
    sends nothing); a batch of one gives the unbatched call's bits."""
    from repro_torch.sim.fabric import _clone_tree
    scs = [small_scenario("port", kind, s) for s in (0, 1, 2)]
    cfg = TW.RunConfig(**cfg_kw)
    fcfg = TW._fabric_cfg(scs[0], cfg)
    prog = TF.batch_program(scs[0].topo, [sc.messages for sc in scs], 200,
                            fcfg, device="cpu")
    solo = [TF.trace_program(sc.topo, sc.messages, 200, fcfg, "cpu")
            for sc in scs]
    st = prog.init_state()
    mid = torch.tensor([True, False, True])
    seen = 0
    for t in range(41):
        if t in (5, 24, 40):
            for live in (None, mid):
                targs, prow = _tick_args(prog, st, t, live)
                out = fk.flow_transition_batch_plain(*targs)
                sargs, _, _ = prog.serve_args(st, t, out[1], out[2], out[4],
                                              out[3], prow, None, live)
                ring = _clone_tree(st.q)
                res = fk.serve_enqueue_batch_plain(ring, *sargs[1:])
                pfc = (fk.pfc_account_batch_plain(
                    prog.pfc_state(st), res[3], res[2], res[5], res[6],
                    res[9], res[7], ring, res[0], st.qsize, res[1], t,
                    prog.pfc_flows, prog.pfc_dims, live)
                    if prog.pfc else None)
                for b in range(3):
                    st_b = TF.FabricState(*[fk.tree_map(lambda x: x[b], v)
                                            for v in prog.stacked(st)])
                    if live is not None and b == 1:   # frozen
                        assert differing_leaves(state_leaves(fk.tree_map(
                            lambda x: x[b], out[0])),
                            state_leaves(st_b.flows), 0) == {}
                        assert not bool(res[3][b].any())
                        assert torch.equal(res[1][b], st.qsize[b])
                        if pfc is not None:
                            assert differing_leaves(state_leaves(fk.tree_map(
                                lambda x: x[b], pfc)), state_leaves(
                                prog.pfc_state(st_b)), 0) == {}
                        continue
                    p = solo[b]
                    eff_nic, prow_b = p.eff_pause(st_b, t)
                    out_b = fk.flow_transition_plain(*p.transport_args(
                        st_b, t, p.sendable_msg(st_b, t), eff_nic))
                    at_b = lambda tree: state_leaves(fk.tree_map(
                        lambda x: x[b], tree))
                    assert differing_leaves(at_b(out), state_leaves(out_b), 0) == {}
                    args_b, _, _ = p.serve_args(st_b, t, out_b[1], out_b[2],
                                                out_b[4], out_b[3], prow_b)
                    ring_b = _clone_tree(st_b.q)
                    res_b = fk.serve_enqueue_plain(ring_b, *args_b[1:])
                    assert differing_leaves(at_b(res[:11]), state_leaves(res_b[:11]),
                                   0) == {}
                    assert differing_leaves(at_b(ring), state_leaves(ring_b),
                                   0) == {}
                    if pfc is not None:
                        pfc_b = fk.pfc_account_plain(
                            p.pfc_state(st_b), res_b[3], res_b[2], res_b[5],
                            res_b[6], res_b[9], res_b[7], ring_b, res_b[0],
                            st_b.qsize, res_b[1], t, p.pfc_flows,
                            p.pfc_dims)
                        assert differing_leaves(at_b(pfc), state_leaves(pfc_b),
                                       0) == {}
                    seen += 1
        st, _, _ = prog.tick(st, t)
    assert seen == 3 * 3 + 3 * 2
    # a batch of one: the unbatched call's bits
    one = TF.batch_program(scs[0].topo, [scs[0].messages], 200, fcfg,
                           device="cpu")
    st1 = one.init_state()
    for t in range(30):
        st1, _, _ = one.tick(st1, t)
    targs, _ = _tick_args(one, st1, 30, None)
    s1 = solo[0]
    st_s = s1.init_state()
    for t in range(30):
        st_s, _, _ = s1.tick(st_s, t)
    out_1 = fk.tree_map(lambda x: x[0], fk.flow_transition_batch(*targs))
    out_s = fk.flow_transition(*s1.transport_args(
        st_s, 30, s1.sendable_msg(st_s, 30), s1.eff_pause(st_s, 30)[0]))
    assert differing_leaves(state_leaves(out_1), state_leaves(out_s), 0) == {}


def test_batch_structs_and_limits_mirror_the_kernels():
    """The batch's fields of the kernels' C structs (the transitions'
    entry stride ``FE``, serve's and the PFC stage's ``B`` and ``live``)
    stand where their ctypes mirrors put them, and the serve kernel's
    batch limit is the wrapper's."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _cuda_bind as B
    from test_torch_active_kernels import _c_fields
    csrc = Path(B.__file__).parent / "csrc"
    for src, name, cls, field in (
            ("transition", "TransParams", B.TransParams, "FE"),
            ("transition_roce", "RoceParams", B.RoceParams, "FE"),
            ("serve_enqueue", "ServeParams", B.ServeParams, "B"),
            ("serve_enqueue", "ServeIn", B.ServeIn, "live"),
            ("serve_enqueue", "PfcParams", B.PfcParams, "B"),
            ("serve_enqueue", "PfcIn", B.PfcIn, "live")):
        c = _c_fields((csrc / f"{src}.cu").read_text(), name)
        py = [f[0] for f in cls._fields_]
        assert c == py and field in c, (src, name)
    text = (csrc / "serve_enqueue.cu").read_text()
    assert int(re.search(r"constexpr int kMaxBatch = (\d+);",
                         text).group(1)) == B.MAX_BATCH
    for src in ("transition", "transition_roce"):
        text = (csrc / f"{src}.cu").read_text()
        assert "const bool* live" in text and "f % p.FE" in text, src
