"""The port's observatory (``repro_torch.obs``, a copy of ``repro.obs``):
``tests/test_obs.py``'s cases on the port's registry render/parse round
trip, the stdlib HTTP exporter (on an ephemeral port), the
BENCH_history.jsonl trend gate; and the port's rendering and parsing
equal to the reference's on the same registry."""
import json
import subprocess
import sys
import threading
import urllib.request

import pytest

from repro_torch.obs.exporter import CONTENT_TYPE, make_server
from repro_torch.obs.metrics import (MetricsRegistry, parse_prometheus,
                                     render_prometheus)
from repro_torch.obs.trend import (append_run, gate_and_append, load_history,
                                   record_from_report, trend_problems)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]


# --------------------------------------------------------------------------- #
# MetricsRegistry + text exposition round trip
# --------------------------------------------------------------------------- #

def _registry():
    reg = MetricsRegistry()
    reg.declare("strack_drops_total", "packets dropped", "counter")
    reg.inc("strack_drops_total", 5)
    reg.inc("strack_drops_total", 2)
    reg.declare("strack_fct_us", "per-tenant FCT", "gauge")
    reg.set("strack_fct_us", 12.5, tenant="train_a", quantile="p99")
    reg.set("strack_fct_us", 3.25, tenant='odd"name\\x', quantile="p50")
    reg.set("strack_qdepth_max_pkts", 17)          # auto-declared gauge
    return reg


def test_render_parse_round_trip():
    reg = _registry()
    text = render_prometheus(reg)
    parsed = parse_prometheus(text)
    assert parsed[("strack_drops_total", ())] == 7.0
    assert parsed[("strack_fct_us", (("quantile", "p99"),
                                     ("tenant", "train_a")))] == 12.5
    assert parsed[("strack_fct_us", (("quantile", "p50"),
                                     ("tenant", 'odd"name\\x')))] == 3.25
    assert parsed[("strack_qdepth_max_pkts", ())] == 17.0
    assert len(parsed) == 4


def test_render_emits_help_and_type_lines():
    text = render_prometheus(_registry())
    lines = text.splitlines()
    assert "# HELP strack_drops_total packets dropped" in lines
    assert "# TYPE strack_drops_total counter" in lines
    assert "# TYPE strack_fct_us gauge" in lines
    # TYPE precedes the samples of its metric (exposition format rule)
    assert lines.index("# TYPE strack_drops_total counter") < \
        lines.index("strack_drops_total 7")


def test_registry_rejects_bad_names_and_redeclares():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.declare("bad name")
    with pytest.raises(ValueError):
        reg.declare("x", type="histogram")
    reg.declare("ok_total", type="counter")
    with pytest.raises(ValueError):
        reg.declare("ok_total", type="gauge")
    with pytest.raises(ValueError):
        reg.set("m", 1.0, **{"bad-label": "v"})


def test_parser_rejects_undeclared_and_garbage():
    with pytest.raises(ValueError):
        parse_prometheus("strack_x 1\n")           # no TYPE line
    with pytest.raises(ValueError):
        parse_prometheus("# TYPE strack_x gauge\nstrack_x one\n")
    with pytest.raises(ValueError):
        parse_prometheus("# TYPE strack_x spline\nstrack_x 1\n")
    # comments and blank lines are fine
    assert parse_prometheus("\n# a comment\n# TYPE a gauge\na 1\n") == \
        {("a", ()): 1.0}


# --------------------------------------------------------------------------- #
# the stdlib exporter
# --------------------------------------------------------------------------- #

def test_exporter_serves_metrics_file(tmp_path):
    prom = tmp_path / "m.prom"
    prom.write_text(render_prometheus(_registry()))
    srv = make_server(str(prom), port=0)           # ephemeral port
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == CONTENT_TYPE
            body = r.read().decode()
        assert parse_prometheus(body)[("strack_drops_total", ())] == 7.0
        # scrapes re-read the file: a soak's periodic dumps show live
        prom.write_text("# TYPE live_gauge gauge\nlive_gauge 1\n")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as r:
            assert "live_gauge" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
        assert ei.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


# --------------------------------------------------------------------------- #
# the cross-PR trend gate
# --------------------------------------------------------------------------- #

def _rec(**scenarios):
    return {"utc": "t", "jax": "j", "backend": "cpu",
            "scenarios": scenarios}


def test_trend_gate_catches_slow_boil_regression(tmp_path):
    hist = tmp_path / "BENCH_history.jsonl"
    append_run(str(hist), _rec(perm=1000.0))
    # each step is within a 20% snapshot gate of the last...
    append_run(str(hist), _rec(perm=880.0))
    append_run(str(hist), _rec(perm=780.0))
    history = load_history(str(hist))
    assert len(history) == 3
    # ...but the trajectory gate compares against the best-ever run
    assert trend_problems(history, _rec(perm=700.0)) != []
    assert trend_problems(history, _rec(perm=950.0)) == []
    # a brand-new scenario needs no baseline
    assert trend_problems(history, _rec(novel=1.0)) == []


def test_trend_tolerates_missing_and_corrupt_history(tmp_path, capsys):
    assert load_history(str(tmp_path / "absent.jsonl")) == []
    hist = tmp_path / "h.jsonl"
    hist.write_text('{"scenarios": {"a": 10.0}}\n'
                    "NOT JSON AT ALL\n"
                    '["not", "a", "record"]\n'
                    '{"scenarios": {"a": 12.0}}\n')
    history = load_history(str(hist))
    assert [r["scenarios"]["a"] for r in history] == [10.0, 12.0]
    err = capsys.readouterr().err
    assert "corrupt line skipped" in err and "malformed record" in err


def test_gate_and_append_records_even_regressions(tmp_path):
    hist = tmp_path / "h.jsonl"
    report = {"meta": {"utc": "t", "jax": "j", "backend": "cpu"},
              "scenarios": {"perm": {"warp": {"ticks_per_s": 1000.0}}}}
    assert gate_and_append(str(hist), report) == []
    bad = {"meta": report["meta"],
           "scenarios": {"perm": {"warp": {"ticks_per_s": 100.0}}}}
    problems = gate_and_append(str(hist), bad)
    assert problems and "below the best run" in problems[0]
    assert len(load_history(str(hist))) == 2   # the bad run is recorded


def test_record_from_report_skips_malformed_rows():
    rec = record_from_report(
        {"meta": {"utc": "t"},
         "scenarios": {"ok": {"warp": {"ticks_per_s": 5.0}},
                       "broken": {"warp": {}},
                       "worse": "not a dict"}})
    assert rec["scenarios"] == {"ok": 5.0}


# --------------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------------- #

def test_render_and_parse_equal_the_reference():
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro.obs.metrics import parse_prometheus as j_parse
    from repro.obs.metrics import render_prometheus as j_render
    regs = (_registry(), JReg())
    regs[1].declare("strack_drops_total", "packets dropped", "counter")
    regs[1].inc("strack_drops_total", 5)
    regs[1].inc("strack_drops_total", 2)
    regs[1].declare("strack_fct_us", "per-tenant FCT", "gauge")
    regs[1].set("strack_fct_us", 12.5, tenant="train_a", quantile="p99")
    regs[1].set("strack_fct_us", 3.25, tenant='odd"name\\x', quantile="p50")
    regs[1].set("strack_qdepth_max_pkts", 17)
    text = render_prometheus(regs[0])
    assert text == j_render(regs[1])
    assert parse_prometheus(text) == j_parse(text)


def test_trend_gate_equals_the_reference(tmp_path):
    from repro.obs.trend import trend_problems as j_trend_problems
    hist = tmp_path / "h.jsonl"
    for v in (1000.0, 880.0, 780.0):
        append_run(str(hist), _rec(perm=v, ring=2 * v))
    history = load_history(str(hist))
    for cand in (_rec(perm=700.0), _rec(perm=950.0, ring=10.0),
                 _rec(novel=1.0)):
        assert trend_problems(history, cand) == j_trend_problems(history,
                                                                 cand)


def test_exporter_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.exporter",
                          "--help"], capture_output=True, text=True,
                         timeout=60, check=True)
    assert "--file" in out.stdout and "--port" in out.stdout
