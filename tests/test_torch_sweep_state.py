"""The batched program's final state (``run_fabric_trace_batch``) held
leaf for leaf against the JAX package's vmapped program and against each
entry run alone, by both packages, on the CPU.

Each case runs B traces of one program shape as one ``BatchProgram``:

* permutation seeds 0-3 on a 4x4 fabric under STrack (warp on);
* one permutation under the three ``lb_mode``s in one batch (a per-entry
  spray mode, selected per entry);
* an 8-to-1 incast on a 4x4 fabric with a 200 KB buffer under RoCEv2 +
  PFC, with ``roce_entropy_seed`` 0-2 (switch ports pause);
* a dependency-edged ring placed by seeds 0 and 1 under one shared fault
  schedule (a link flap, a host flap, a degraded and a corrupting link).

Every ``FabricState`` leaf of each entry equals the port's solo run and
JAX's solo run bit for bit (integers exactly, float32 by their bits), and
JAX's batch on every leaf but those where JAX's batch differs from JAX's
own solo run: its vmapped warp loop rounds some float32 deadlines
(``now + c``: the probe and RTO deadlines) one ulp away (ROADMAP C17),
and the port keeps the solo program's rounding.  Warp trips, done ticks
and the summaries equal JAX's.
"""
import dataclasses

import numpy as np
import pytest

from repro.sim import fabric as JF
from repro.sim import faults as JFa
from repro.sim import workloads as JW

from repro_torch.sim import fabric as TF
from repro_torch.sim import faults as TFa
from repro_torch.sim import workloads as TW

from torch_parity import (differing_leaves, entry_leaves, small_scenario,
                          state_leaves)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: A flap, a host flap, a degraded link and a corrupting link, shared by a
#: batch (the reference's ``in_axes=None``).
FAULTS = dict(link_flaps=((0, 1, 20, 90),), host_flaps=((3, 40, 120),),
              link_degrade=((1, 0, 0, 300, 0.5),),
              link_corrupt=((2, 3, 0, 300, 0.05),), seed=5)

#: case -> (scenario kind, batch axis: ("seed", seeds), ("lb_mode",
#: modes) or ("entropy", seeds), RunConfig fields)
CASES = {
    "perm_seeds_strack": ("perm", ("seed", (0, 1, 2, 3)), {}),
    "perm_lb_modes": ("perm", ("lb_mode", JF.LB_MODES), {}),
    "incast_rocev2_pfc_entropy": ("incast", ("entropy", (0, 1, 2)),
                                  dict(protocol="rocev2", n_ticks=1500,
                                       switch_buffer_bytes=2e5)),
    "ring_placements_faults": ("ring", ("seed", (0, 1)),
                               dict(faults=True, n_ticks=500)),
}


def _batch(pkg, case):
    """``(topo, messages_batch, n_ticks, FabricConfig, lb_modes,
    entropy_seeds, RunConfigs, scenarios)`` of a case in one package."""
    kind, (axis, values), kw = CASES[case]
    W = JW if pkg == "jax" else TW
    kw = dict(kw)
    if kw.pop("faults", False):
        kw["faults"] = (JFa if pkg == "jax" else TFa).FaultSpec(**FAULTS)
    if axis == "seed":
        scs = [small_scenario(pkg, kind, s) for s in values]
        cfgs = [W.RunConfig(**kw)] * len(values)
    else:
        scs = [small_scenario(pkg, kind, 0)] * len(values)
        key = "lb_mode" if axis == "lb_mode" else "roce_entropy_seed"
        cfgs = [W.RunConfig(**kw, **{key: v}) for v in values]
    fcfg = W._fabric_cfg(scs[0], cfgs[0])
    n_ticks = max(W._scenario_ticks(sc, c) for sc, c in zip(scs, cfgs))
    return (scs[0].topo, [sc.messages for sc in scs], n_ticks, fcfg,
            [c.lb_mode for c in cfgs], [c.roce_entropy_seed for c in cfgs],
            cfgs, scs)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both packages' batch and solo runs of one case."""
    name = request.param
    jt, jmsgs, n_ticks, jcfg, lbs, ents, _, _ = _batch("jax", name)
    tt, tmsgs, t_ticks, tcfg, _, _, rcfgs, scs = _batch("port", name)
    assert t_ticks == n_ticks
    j_fin, j_per = JF.run_fabric_trace_batch(jt, jmsgs, n_ticks, jcfg,
                                             lb_modes=lbs,
                                             entropy_seeds=ents)
    j_solo = [JF.run_fabric_trace(jt, msgs, n_ticks, dataclasses.replace(
        jcfg, lb_mode=lb, roce_entropy_seed=ent))
        for msgs, lb, ent in zip(jmsgs, lbs, ents)]
    t_fin, t_per = TF.run_fabric_trace_batch(tt, tmsgs, n_ticks, tcfg,
                                             lb_modes=lbs,
                                             entropy_seeds=ents,
                                             device="cpu")
    t_solo = [TF.run_fabric_trace(tt, msgs, n_ticks, dataclasses.replace(
        tcfg, lb_mode=lb, roce_entropy_seed=ent), device="cpu")
        for msgs, lb, ent in zip(tmsgs, lbs, ents)]
    q_rows = 2 * tt.n_tor * tt.n_spine + tt.n_hosts
    return dict(name=name, j_fin=j_fin, j_per=j_per, j_solo=j_solo,
                t_fin=t_fin, t_per=t_per, t_solo=t_solo, q_rows=q_rows,
                rcfgs=rcfgs, scs=scs)


def test_batch_entries_equal_their_solo_runs(case):
    """Each entry of the port's batch equals the port's solo run and JAX's
    solo run on every state leaf, and its warp trips equal both."""
    q = case["q_rows"]
    for i, ((tf, tm), (jf, jm)) in enumerate(zip(case["t_solo"],
                                                 case["j_solo"])):
        got = entry_leaves(case["t_fin"], i)
        assert differing_leaves(got, state_leaves(tf), q) == {}, i
        assert differing_leaves(got, state_leaves(jf), q) == {}, i
        trips = int(case["t_per"][i]["warp_trips"])
        assert trips == int(tm["warp_trips"]) == int(jm["warp_trips"]), i


#: The float32 deadlines ``now + c`` that JAX's vmapped warp loop may
#: round one ulp away from its own solo program (ROADMAP C17).
DEADLINES = {"flows.rel.probe_deadline", "flows.rel.rto_deadline",
             "flows.rto_deadline"}


def test_batch_equals_jax_batch_leaf_for_leaf(case):
    """The port's stacked finals equal JAX's ``run_fabric_trace_batch`` on
    every leaf but where JAX's batch differs from its own solo runs: a
    deadline ``now + c`` one ulp away (ROADMAP C17), never an integer or
    another float.  There the port keeps the solo rounding, so it lies
    within that ulp of JAX's batch."""
    q = case["q_rows"]
    for i, (jf, _) in enumerate(case["j_solo"]):
        vmap_rounding = differing_leaves(entry_leaves(case["j_fin"], i), state_leaves(jf), q)
        assert set(vmap_rounding) <= DEADLINES, vmap_rounding
        assert all(u == 1 for u in vmap_rounding.values()), vmap_rounding
        got = differing_leaves(entry_leaves(case["t_fin"], i), entry_leaves(case["j_fin"], i), q)
        assert got == vmap_rounding, (i, got, vmap_rounding)


def test_batch_metrics_equal_jax(case):
    """Per-entry metrics: done ticks, message release/done ticks, every
    summary key and the warp diagnostics equal JAX's batch."""
    for i, (tm, jm) in enumerate(zip(case["t_per"], case["j_per"])):
        np.testing.assert_array_equal(tm["done_tick"], jm["done_tick"])
        assert tm["fct_us"] == jm["fct_us"]
        ts, js = TF.summarize(tm), JF.summarize(jm)
        assert set(ts) == set(js)
        for k in ts:
            assert str(ts[k]) == str(js[k]), (i, k, ts[k], js[k])
        for k in ("warp_trips", "end_tick", "trace_every"):
            assert int(np.asarray(tm[k])) == int(np.asarray(jm[k])), (i, k)
