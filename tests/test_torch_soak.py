"""The port's soak driver (``repro_torch.sim.traffic.soak``) against the JAX
package's, on the CPU.

At ``TOPO44`` with ``tests/test_traffic.py``'s tenants, a clean soak of
two epochs and a chaos soak of ``[None, link_flap(0, 0, 10, 120), None]``
equal JAX's soak on the whole return dict and on the rendered ``.prom``
text; each reports one program build, and each epoch (re-bound onto the
soak's one ``FabricProgram``) equals a fresh run of that epoch alone, on
its summary and on every leaf of its final state.  The reference's errors
are the port's; ``inert_faults_like`` and ``record_epoch`` equal JAX's;
the committed ``soak64_chaos2_strack_ref.json`` is whole.
"""
import dataclasses
import importlib.util
import json

import numpy as np
import pytest

import repro.sim.traffic as JTr
import repro_torch.sim.fabric as TFab
import repro_torch.sim.traffic as TTr
from repro.core.params import NetworkSpec as JNet
from repro.obs.metrics import MetricsRegistry as JReg
from repro.obs.metrics import render_prometheus as j_render
from repro.sim import fabric as JFab
from repro.sim import faults as JFa
from repro.sim.topology import full_bisection as j_full_bisection
from repro_torch.core.params import NetworkSpec
from repro_torch.obs.metrics import (MetricsRegistry, parse_prometheus,
                                     render_prometheus)
from repro_torch.sim import faults as TFa
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import (RunConfig, _fabric_cfg,
                                       _fabric_summary)

from torch_parity import (CHAOS1024, ROOT, SOAK_REF, SOAK_REF_PATH, canon,
                          jax_fleet, port_fleet, state_leaves)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: tests/test_traffic.py's fleet: two training jobs and a burst tenant on
#: a 4x4 fabric at 400 Gbps, seed 3.
JOBS = [dict(name="job_ring", algo="ring", ranks=4,
             collective_bytes=64 * 2 ** 10, steps=2),
        dict(name="job_hd", algo="hd", ranks=4,
             collective_bytes=64 * 2 ** 10, start_tick=50)]
TENANTS = [dict(name="burst", n_flows=16, mean_interarrival_ticks=4.0,
                size_bytes=8 * 2 ** 10, size_jitter=0.5, n_targets=2)]
SEED = 3
MODS = {"jax": (JTr, JFa, JReg, j_render, JNet, j_full_bisection),
        "port": (TTr, TFa, MetricsRegistry, render_prometheus, NetworkSpec,
                 full_bisection)}


def _soak(pkg, tmp_path, epochs, chaos=None, **kw):
    """Either package's soak of the fleet with a registry and an
    ``out_path``: (return dict, the file's text, the rendered text)."""
    Tr, Fa, Reg, render, Net, fb = MODS[pkg]
    if pkg == "jax":
        JFab.clear_program_cache()   # so that it reports its one build
    else:
        kw["device"] = "cpu"
    reg = Reg()
    out = tmp_path / f"{pkg}.prom"
    res = Tr.soak(fb(4, 4), [Tr.TrainingJob(**j) for j in JOBS],
                  [Tr.InferenceTenant(**t) for t in TENANTS], epochs=epochs,
                  net=Net(link_gbps=400.0), seed=SEED, registry=reg,
                  out_path=str(out), chaos=chaos and chaos(Fa), **kw)
    return res, out.read_text(), render(reg)


def _flap(Fa):
    return [None, Fa.link_flap(0, 0, 10, 120), None]


@pytest.fixture(scope="module")
def port_chaos(tmp_path_factory):
    """The port's chaos soak, each epoch's final state and metrics kept
    as the soak's one program returns them."""
    kept, real = [], TFab.run_program

    def keep(prog):
        final, metrics = real(prog)
        kept.append((prog, final, metrics))
        return final, metrics
    TFab.run_program = keep
    try:
        out = _soak("port", tmp_path_factory.mktemp("soak"), 3, _flap)
    finally:
        TFab.run_program = real
    return out, kept


def test_clean_soak_equals_jax(tmp_path):
    got = {pkg: _soak(pkg, tmp_path, 2) for pkg in MODS}
    (res, text, rendered), (j_res, j_text, _) = got["port"], got["jax"]
    assert canon(res) == canon(j_res)
    assert text == rendered == j_text
    assert res["program_builds"] == 1
    assert res["totals"]["unfinished"] == 0
    assert parse_prometheus(text)[("strack_epochs_total", ())] == 2.0


def test_chaos_soak_equals_jax(port_chaos, tmp_path):
    (res, text, rendered), kept = port_chaos
    j_res, j_text, _ = _soak("jax", tmp_path, 3, _flap)
    assert canon(res) == canon(j_res)
    assert text == rendered == j_text
    assert res["program_builds"] == j_res["program_builds"] == 1
    assert [r["chaos"] for r in res["epoch_rows"]] == [False, True, False]
    assert res["epoch_rows"][1]["blackholed_pkts"] > 0
    assert all(r["blackholed_pkts"] == 0 for r in res["epoch_rows"][::2])
    assert "strack_fct_degradation_ratio" in text
    assert len({id(prog) for prog, _, _ in kept}) == 1


def test_each_soak_epoch_equals_a_fresh_run(port_chaos):
    """The re-bind check: each epoch of the soak's one program equals a
    run of that epoch alone on a program of its own (summary and every
    final state leaf)."""
    (res, _, _), kept = port_chaos
    topo, jobs = full_bisection(4, 4), [TTr.TrainingJob(**j) for j in JOBS]
    tenants = [TTr.InferenceTenant(**t) for t in TENANTS]
    flap = _flap(TFa)
    inert = TTr.inert_faults_like(flap[1])
    for e, (_, final, metrics) in enumerate(kept):
        sc, _ = TTr.mixed_scenario(topo, jobs, tenants,
                                   net=NetworkSpec(link_gbps=400.0),
                                   seed=SEED, epoch=e)
        cfg = RunConfig(n_ticks=res["n_ticks"], faults=flap[e] or inert)
        f_final, f_metrics = TFab.run_fabric_trace(
            topo, sc.messages, res["n_ticks"], _fabric_cfg(sc, cfg),
            device="cpu")
        assert canon(_fabric_summary(sc, cfg, metrics)) == canon(
            _fabric_summary(sc, cfg, f_metrics)), e
        a, b = state_leaves(final), state_leaves(f_final)
        assert a.keys() == b.keys()
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not bad, (e, bad)
        assert res["epoch_rows"][e]["max_fct_us"] == _fabric_summary(
            sc, cfg, f_metrics)["max_fct"]


def test_soak_errors_equal_jax():
    def err(pkg, **kw):
        Tr, Fa, _, _, Net, fb = MODS[pkg]
        kw = {k: (v(Fa) if callable(v) else v) for k, v in kw.items()}
        if pkg == "port":
            kw["device"] = "cpu"
        if kw.get("cfg") == "events":
            kw["cfg"] = (JTr if pkg == "jax" else TTr).RunConfig(
                backend="events")
        with pytest.raises(ValueError) as ei:
            Tr.soak(fb(4, 4), [], [Tr.InferenceTenant(name="t", n_flows=4)],
                    net=Net(link_gbps=400.0), **kw)
        return str(ei.value)

    cases = [dict(epochs=1, cfg="events"), dict(epochs=0),
             dict(epochs=2, chaos=lambda Fa: [Fa.link_flap(0, 0, 1, 5),
                                               Fa.host_flap(0, 1, 5)]),
             dict(epochs=2, chaos=lambda Fa: [None, None]),
             dict(epochs=3, chaos=lambda Fa: [None, Fa.link_flap(0, 0, 1, 5)])]
    for kw in cases:
        assert err("port", **kw) == err("jax", **kw), kw


def test_rebind_refuses_another_program_shape():
    """A program re-binds only a trace of its own shape: another flow
    count, horizon or fault shape raises, the program left as it was."""
    topo, net = full_bisection(2, 2), NetworkSpec(link_gbps=400.0)
    from repro_torch.sim.workloads import permutation_scenario
    sc = permutation_scenario(topo, 8192, net=net)
    cfg = _fabric_cfg(sc, RunConfig(faults=TFa.link_flap(0, 0, 1, 5)))
    builds = TFab.program_builds
    prog = TFab.trace_program(topo, sc.messages, 200, cfg, "cpu")
    assert TFab.program_builds == builds + 1
    with pytest.raises(ValueError, match="rebind"):
        TFab.trace_program(topo, sc.messages[:3], 200, cfg, "cpu", prog)
    with pytest.raises(ValueError, match="rebind"):
        TFab.trace_program(topo, sc.messages, 201, cfg, "cpu", prog)
    with pytest.raises(ValueError, match="rebind"):
        TFab.trace_program(topo, sc.messages, 200, dataclasses.replace(
            cfg, faults=TFa.host_flap(0, 1, 5)), "cpu", prog)
    # data (lb_mode, the fault values) re-binds without a build
    again = TFab.trace_program(topo, sc.messages, 200, dataclasses.replace(
        cfg, lb_mode="oblivious", faults=TFa.link_flap(1, 1, 2, 9)), "cpu",
        prog)
    assert again is prog and TFab.program_builds == builds + 1
    assert int(prog.fd.flap_row_t0.min()) == 2


@pytest.mark.parametrize("spec", ["CHAOS1024", "flap"])
def test_inert_faults_like_equals_jax(spec):
    got = {}
    for pkg, (Tr, Fa, *_) in MODS.items():
        fs = (Fa.FaultSpec(**CHAOS1024) if spec == "CHAOS1024"
              else Fa.link_flap(0, 0, 10, 120))
        inert = Tr.inert_faults_like(fs)
        assert inert.shape_key == fs.shape_key and inert.last_edge == 0
        got[pkg] = dataclasses.astuple(inert)
    assert got["port"] == got["jax"]


def test_record_epoch_equals_jax():
    """An epoch summary with a NaN tenant row and an unnamed group folded
    twice into each package's registry renders the same text."""
    res = {"drops": 3, "pauses": 1, "ecn_marks": 7, "retransmits": 2,
           "unfinished": 1, "qdepth_max_pkts": 12, "qdepth_p99_pkts": 9.5,
           "tenant_fct": {0: dict(count=4, unfinished=0, p50=1.5, p99=2.25,
                                  avg=1.75, max=2.5),
                          2: dict(count=2, unfinished=2, p50=float("nan"),
                                  p99=float("nan"), avg=float("nan"),
                                  max=float("nan"))}}
    text = {}
    for pkg, (Tr, _, Reg, render, *_) in MODS.items():
        reg = Reg()
        for _ in range(2):
            Tr.record_epoch(reg, res, {0: "train"})
        text[pkg] = render(reg)
    assert text["port"] == text["jax"]
    assert 'strack_fct_us{quantile="p50",tenant="2"} NaN' in text["port"]


def test_soak64_reference_file_is_whole():
    """The committed 64-host chaos soak: two drained epochs (a clean one,
    then CHAOS1024's), one program, each epoch's ``run()`` summary, and
    ``.prom`` text that parses back to its counters."""
    ref = json.loads(SOAK_REF_PATH.read_text())
    assert (ref["seed"], ref["epochs"]) == (SOAK_REF["seed"],
                                            SOAK_REF["epochs"])
    assert ref["chaos"] == [None, json.loads(json.dumps(CHAOS1024))]
    soak = ref["soak"]
    assert soak["program_builds"] == 1
    assert [r["chaos"] for r in soak["epoch_rows"]] == [False, True]
    assert all(r["unfinished"] == 0 for r in soak["epoch_rows"])
    assert soak["totals"]["unfinished"] == 0
    assert len(ref["epoch_runs"]) == 2
    assert all(r["unfinished"] == 0 and r["end_tick"] == soak["n_ticks"]
               for r in ref["epoch_runs"])
    chaos_run = ref["epoch_runs"][1]
    assert chaos_run["blackholed_pkts"] > 0 and chaos_run["corrupt_drops"] > 0
    for row, run in zip(soak["epoch_rows"], ref["epoch_runs"]):
        assert row["max_fct_us"] == run["max_fct"]
    parsed = parse_prometheus(ref["prom"])
    assert parsed[("strack_epochs_total", ())] == 2.0
    assert parsed[("strack_blackholed_pkts_total", ())] == \
        soak["totals"]["blackholed_pkts"]
    topo, _, jobs, tenants = jax_fleet("default")
    assert topo.n_hosts == 64
    assert soak["totals"]["messages"] == 2 * len(JTr.mixed_scenario(
        topo, jobs, tenants, seed=0)[0].messages)


def test_chip_smoke_fleets_are_the_soak_benchmarks():
    """``chip_smoke.py``'s copies of ``benchmarks/soak.py``'s fleets (it
    may not import that module, which imports the JAX package) build the
    same records."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_fleets", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, fleet in (("default", cs.SOAK_FLEET), ("spot", cs.SPOT_FLEET)):
        assert repr(cs.fleet_records(fleet)) == repr(port_fleet(name)), name
    from benchmarks.soak import SPOT_BAND
    assert cs.SPOT_BAND == SPOT_BAND
