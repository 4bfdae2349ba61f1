"""The per-tick trace of the port (``trace_every``, ``trace_queues``,
``qdelay_threshold_us``) held against the JAX package on the CPU.

* Dense ticks with a trace row every ``k`` ticks, ``k`` 1 and 5 over a
  horizon that is not a multiple of 5 (the remainder ticks run after the
  last row, unsampled): a 4x4 STrack permutation, an 8-to-1 RoCEv2 + PFC
  incast with a 200 KB buffer (ports pause) and an 8x16 permutation.
  Every row of every key equals JAX's (integers exactly, ``delivered`` by
  its float32 bits, ``cwnd_mean`` within ``CWND_RTOL``: a mean of N
  windows summed in XLA's order on one side, PyTorch's on the other), and
  the summary is the same at every decimation.
* ``trace_queues`` on ``test_timewarp.py``'s settle scenarios, cut to a
  shorter horizon and lower thresholds (at the default 8 us these queues
  never settle late): ``queue_settle_us`` equals JAX's, the run ticks densely (no ``warp_trips``), and
  a batch of two seeds gives each entry's solo rows.
* The checks of ``RunConfig`` with the reference's texts.
* ``perm1024_trace4_strack_ref.json`` rebuilt from JAX (~12 s) equals the
  committed file; the two committed sweep files are whole and agree with
  ``perm1024_strack_ref.json`` (rebuilt by ``tests/torch_parity.py``
  only: a minute each on a CPU).
"""
import json

import numpy as np
import pytest

from repro.sim import fabric as JF
from repro.sim import workloads as JW

from repro_torch.sim import fabric as TF
from repro_torch.sim import workloads as TW

from torch_parity import (REF_DIR, REF_PATH, SWEEP_REF_PATHS, SWEEP_REFS,
                          TRACE_EXACT_KEYS, TRACE_REF, TRACE_REF_PATH,
                          _bits, small_scenario, trace_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: cwnd_mean rows of the two packages: one float32 mean of N windows
#: summed in two orders (a few ulps; a wrong window moves it by 1/N of a
#: packet or more).
CWND_RTOL = 1e-6

#: case -> (scenario kind, RunConfig fields, fabric shape)
CASES = {
    "perm44_strack": ("perm", {}, (4, 4)),
    "incast44_rocev2_pfc": ("incast", dict(protocol="rocev2",
                                           switch_buffer_bytes=2e5), (4, 4)),
    "perm8x16_strack": ("perm", {}, (8, 16)),
}
N_TICKS = 153


def _scenario(pkg, kind, shape):
    if shape == (4, 4):
        return small_scenario(pkg, kind, 1)
    if pkg == "jax":
        from repro.core.params import NetworkSpec as Net
        from repro.sim.topology import full_bisection
    else:
        from repro_torch.core.params import NetworkSpec as Net
        from repro_torch.sim.topology import full_bisection
    W = JW if pkg == "jax" else TW
    return W.permutation_scenario(full_bisection(*shape), 64 * 2 ** 10,
                                  net=Net(link_gbps=400.0), seed=1)


def _runs(case, every):
    """Both packages' metrics of ``case`` with a trace row every
    ``every`` ticks over ``N_TICKS`` dense ticks."""
    kind, kw, shape = CASES[case]
    out = []
    for pkg, W, F, dev in (("jax", JW, JF, {}), ("port", TW, TF,
                                                 {"device": "cpu"})):
        sc = _scenario(pkg, kind, shape)
        cfg = W.RunConfig(n_ticks=N_TICKS, trace_every=every, **kw)
        _, m = F.run_fabric_trace(sc.topo, sc.messages, N_TICKS,
                                  W._fabric_cfg(sc, cfg), **dev)
        out.append(m)
    return out


@pytest.mark.parametrize("every", [1, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_rows_equal_jax(case, every):
    """Every trace key's rows equal JAX's; the rows sample block ends."""
    jm, tm = _runs(case, every)
    assert tm["trace_every"] == jm["trace_every"] == every
    for k in TRACE_EXACT_KEYS:
        a, b = np.asarray(jm[k]), np.asarray(tm[k])
        assert a.shape == b.shape and a.shape[0] == N_TICKS // every, k
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    np.testing.assert_allclose(np.asarray(tm["cwnd_mean"]),
                               np.asarray(jm["cwnd_mean"]), rtol=CWND_RTOL,
                               atol=0)
    assert TF.summarize(tm) == {k: v for k, v in JF.summarize(jm).items()}
    if case.startswith("incast"):
        assert np.asarray(tm["paused_ports"]).max() > 0
        assert np.asarray(tm["pauses_trace"])[-1] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_summaries_exact_at_any_decimation(case):
    """The summary comes from the final state, not the rows: the same at
    k = 1, k = 5 and with no trace (dense and warp)."""
    kind, kw, shape = CASES[case]
    sc = _scenario("port", kind, shape)
    rows = [TW.run(sc, TW.RunConfig(n_ticks=N_TICKS, trace_every=k, **kw),
                   device="cpu") for k in (1, 5)]
    plain = TW.run(sc, TW.RunConfig(n_ticks=N_TICKS, **kw), device="cpu")
    assert "warp_trips" not in rows[0] and "warp_trips" not in rows[1]
    assert "warp_trips" in plain
    drop = lambda r: {k: v for k, v in r.items()
                      if k not in ("warp_trips", "end_tick")}
    assert rows[0] == rows[1] == drop(plain)


#: test_timewarp.py's settle scenarios at a shorter horizon: (kind,
#: RunConfig fields)
SETTLE = {
    "perm44_500ns": ("perm", dict(n_ticks=400, qdelay_threshold_us=0.5)),
    "incast44_every4_1us": ("incast", dict(n_ticks=400, trace_every=4,
                                           qdelay_threshold_us=1.0)),
    "incast44_1us": ("incast", dict(n_ticks=400, qdelay_threshold_us=1.0)),
}


@pytest.mark.parametrize("name", sorted(SETTLE))
def test_queue_settle_equals_jax(name):
    """``trace_queues`` forces dense ticks with a row every tick (or
    every ``trace_every``); ``queue_settle_us`` equals JAX's, and the
    summary has no warp diagnostics."""
    kind, kw = SETTLE[name]
    j = JW.run(small_scenario("jax", kind, 4),
               JW.RunConfig(trace_queues=True, **kw))
    t = TW.run(small_scenario("port", kind, 4),
               TW.RunConfig(trace_queues=True, **kw), device="cpu")
    assert "warp_trips" not in t and "end_tick" not in t
    assert set(t) == set(j)
    for k in t:
        assert str(t[k]) == str(j[k]), (k, t[k], j[k])
    assert t["queue_settle_us"] > 0


def test_trace_batch_entries_equal_solo():
    """A batch of two permutation seeds under ``trace_queues`` and
    ``trace_every=3``: each entry's rows (``cwnd_mean`` bit for bit) and
    summary, ``queue_settle_us`` among its keys, equal its solo run's."""
    scs = [small_scenario("port", "perm", s) for s in (0, 1)]
    cfg = TW.RunConfig(n_ticks=N_TICKS, trace_queues=True, trace_every=3,
                       qdelay_threshold_us=0.5)
    fcfg = TW._fabric_cfg(scs[0], cfg)
    _, per = TF.run_fabric_trace_batch(scs[0].topo,
                                       [sc.messages for sc in scs], N_TICKS,
                                       fcfg, device="cpu")
    for sc, m in zip(scs, per):
        _, solo = TF.run_fabric_trace(sc.topo, sc.messages, N_TICKS, fcfg,
                                      device="cpu")
        for k in TRACE_EXACT_KEYS + ("cwnd_mean",):
            np.testing.assert_array_equal(_bits(np.asarray(m[k])),
                                          _bits(np.asarray(solo[k])),
                                          err_msg=k)
        row = TW._fabric_summary(sc, cfg, m)
        assert row == TW._fabric_summary(sc, cfg, solo)
        assert row["queue_settle_us"] > 0 and "warp_trips" not in row


@pytest.mark.parametrize("kw", [
    dict(trace_every=-1), dict(active_cap=4, trace_queues=True),
    dict(active_cap=4, trace_every=2), dict(shard=2, trace_queues=True)])
def test_run_config_trace_checks_are_the_references(kw):
    with pytest.raises(ValueError) as j:
        JW.RunConfig(**kw)
    with pytest.raises(ValueError) as t:
        TW.RunConfig(**kw)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("kw", [
    dict(trace_queues=True), dict(trace_every=3),
    dict(trace_queues=True, trace_every=7, time_warp=False), dict()])
def test_fabric_cfg_trace_forces_dense_ticks(kw):
    """``_fabric_cfg``: ``trace_queues`` samples every tick unless
    ``trace_every`` says otherwise, and any trace ticks densely."""
    j = JW._fabric_cfg(small_scenario("jax", "perm", 0), JW.RunConfig(**kw))
    t = TW._fabric_cfg(small_scenario("port", "perm", 0), TW.RunConfig(**kw))
    assert (t.trace_every, t.time_warp) == (j.trace_every, j.time_warp)


def test_trace_reference_file_rebuilds_from_jax():
    """``perm1024_trace4_strack_ref.json`` is what the JAX package gives
    now; its rows sample 128 block ends of 4 ticks and its done ticks are
    those of the warp run in ``perm1024_strack_ref.json``."""
    want = json.loads(TRACE_REF_PATH.read_text())
    assert json.loads(json.dumps(trace_reference())) == want
    assert want["trace_every"] == TRACE_REF["trace_every"] == 4
    assert all(r["rows"] == 128 for r in want["rows"].values())
    assert len(want["cwnd_mean"]) == 128
    assert want["done_tick"] == json.loads(REF_PATH.read_text())["done_tick"]


@pytest.mark.parametrize("stem", sorted(SWEEP_REFS))
def test_sweep_reference_files_are_whole(stem):
    """Each committed sweep file holds one entry a value of its axis, each
    finished; perm1024's seed-0 entry (STrack) equals the solo file, and
    the RoCEv2 entries share the solo RoCEv2 file's horizon."""
    ref = json.loads(SWEEP_REF_PATHS[stem].read_text())
    axis, values = SWEEP_REFS[stem][1]
    assert (ref["axis"], ref["values"]) == (axis, list(values))
    assert len(ref["entries"]) == len(values)
    assert all(e["unfinished"] == 0 for e in ref["entries"])
    if axis == "seed":
        solo = json.loads(REF_PATH.read_text())
        assert ref["n_ticks"] == solo["n_ticks"]
        assert all(solo[k] == v for k, v in ref["entries"][0].items())
        assert len({tuple(e["done_tick"]) for e in ref["entries"]}) == 8
    else:
        solo = json.loads((REF_DIR / "perm1024_rocev2_ref.json").read_text())
        assert ref["n_ticks"] == solo["n_ticks"]
        assert all(len(e["done_tick"]) == 1024 for e in ref["entries"])
