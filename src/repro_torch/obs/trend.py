"""Cross-PR benchmark trajectory: BENCH_history.jsonl append + gate.

``BENCH_fabric.json`` is a snapshot that each ``make bench`` overwrites,
so its regression gate only ever sees the previous run.  This module
keeps the whole trajectory instead: one JSON line per bench run
(timestamp + the per-scenario warm warp ticks/sec), appended by
``bench_all`` and uploaded by CI as an artifact.  The gate compares the
new run against the **best** throughput each scenario ever recorded —
a slow-boil regression that loses 5% per PR gets caught even though no
single step trips the snapshot gate.

History line format (one JSON object per line)::

    {"utc": "...", "jax": "...", "backend": "cpu",
     "scenarios": {"perm1024": 51234.0, ...}}

Corrupt lines are skipped with a loud warning (a truncated append must
not wedge every future bench run), and a missing file is simply an
empty history.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional


def record_from_report(report: dict) -> dict:
    """Distill a BENCH_fabric.json report dict to one history line."""
    meta = report.get("meta") or {}
    scenarios = {}
    for name, row in (report.get("scenarios") or {}).items():
        try:
            scenarios[name] = float(row["warp"]["ticks_per_s"])
        except (KeyError, TypeError, ValueError):
            continue
    return {"utc": meta.get("utc", ""), "jax": meta.get("jax", ""),
            "backend": meta.get("backend", ""), "scenarios": scenarios}


def load_history(path: str) -> List[dict]:
    """All well-formed history lines; [] when the file is missing."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except FileNotFoundError:
        return []
    except OSError as e:
        print(f"trend gate: cannot read {path} ({e}) — empty history",
              file=sys.stderr)
        return []
    out = []
    for ln, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            print(f"trend gate: {path}:{ln}: corrupt line skipped",
                  file=sys.stderr)
            continue
        if isinstance(rec, dict) and isinstance(rec.get("scenarios"),
                                                dict):
            out.append(rec)
        else:
            print(f"trend gate: {path}:{ln}: malformed record skipped",
                  file=sys.stderr)
    return out


def append_run(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def trend_problems(history: List[dict], record: dict,
                   tol: float = 0.20) -> List[str]:
    """Gate ``record`` against the best-ever throughput per scenario.

    A scenario regresses when its new ticks/sec is more than ``tol``
    below the maximum any history line recorded for it.  Scenarios with
    no history land silently (new benchmarks need no baseline)."""
    best: dict = {}
    for rec in history:
        for name, tps in rec["scenarios"].items():
            try:
                tps = float(tps)
            except (TypeError, ValueError):
                continue
            if tps > best.get(name, 0.0):
                best[name] = tps
    problems = []
    for name, tps in sorted((record.get("scenarios") or {}).items()):
        ref = best.get(name)
        if ref and ref > 0 and tps < (1.0 - tol) * ref:
            problems.append(
                f"trend: scenarios.{name} warp ticks/sec is "
                f"{(1 - tps / ref) * 100:.1f}% below the best run in "
                f"history ({ref:,.1f} -> {tps:,.1f}; gate is {tol:.0%})")
    return problems


def gate_and_append(path: str, report: dict,
                    tol: float = 0.20,
                    record: Optional[dict] = None) -> List[str]:
    """The bench_all hook: distill, gate vs history, then append.

    The new run is appended even when it regresses — the trajectory
    must show the bad run, and the process exit code (driven by the
    returned problems) is the gate."""
    rec = record if record is not None else record_from_report(report)
    problems = trend_problems(load_history(path), rec, tol=tol)
    try:
        append_run(path, rec)
        print(f"trend: appended run to {path} "
              f"({len(rec['scenarios'])} scenarios)")
    except OSError as e:
        print(f"trend gate: cannot append to {path} ({e})",
              file=sys.stderr)
    return problems
