"""Minimal Prometheus-style metrics: registry + text render + parser.

One class and two functions, stdlib only:

  * :class:`MetricsRegistry` — named counters and gauges with label
    sets.  ``inc()`` accumulates (counter semantics), ``set()``
    overwrites (gauge semantics); each name carries a HELP string and a
    TYPE so the rendered exposition is self-describing.
  * :func:`render_prometheus` — the text exposition format (version
    0.0.4): ``# HELP`` / ``# TYPE`` comment pairs followed by
    ``name{label="value",...} number`` sample lines.
  * :func:`parse_prometheus` — the inverse, strict enough to be a
    round-trip gate in the test suite and in ``benchmarks/soak.py``:
    every sample line must parse, every samples' name must have been
    declared by a TYPE line.

The fabric's metric names all live under the ``strack_`` prefix; see
docs/observatory.md for the full name/label catalogue.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# name{labels} value   (labels optional; value is any float literal)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Dict[str, str]) -> LabelSet:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


class MetricsRegistry:
    """Counters and gauges keyed by (metric name, label set).

    ``declare`` is idempotent; ``inc``/``set`` auto-declare with an
    empty HELP when the name is new, so ad-hoc use stays one-liner
    cheap while the soak driver declares everything up front with
    proper HELP strings.
    """

    def __init__(self):
        # name -> (help, type); insertion order = exposition order
        self._meta: Dict[str, Tuple[str, str]] = {}
        # name -> {labelset: value}
        self._samples: Dict[str, Dict[LabelSet, float]] = {}

    def declare(self, name: str, help: str = "",
                type: str = "gauge") -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        if type not in ("counter", "gauge"):
            raise ValueError(f"bad metric type {type!r}")
        old = self._meta.get(name)
        if old is not None and old[1] != type:
            raise ValueError(f"metric {name!r} re-declared as {type}, "
                             f"was {old[1]}")
        if old is None or (not old[0] and help):
            self._meta[name] = (help, type)
        self._samples.setdefault(name, {})

    def inc(self, name: str, delta: float = 1.0, **labels) -> None:
        """Counter-style accumulate (declares ``name`` as counter)."""
        if name not in self._meta:
            self.declare(name, type="counter")
        key = _labelset(labels)
        self._samples[name][key] = self._samples[name].get(key, 0.0) + delta

    def set(self, name: str, value: float, **labels) -> None:
        """Gauge-style overwrite (declares ``name`` as gauge)."""
        if name not in self._meta:
            self.declare(name, type="gauge")
        self._samples[name][_labelset(labels)] = float(value)

    def get(self, name: str, **labels) -> float:
        return self._samples[name][_labelset(labels)]

    def samples(self) -> Iterable[Tuple[str, LabelSet, float]]:
        for name, by_labels in self._samples.items():
            for key, value in sorted(by_labels.items()):
                yield name, key, value


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(reg: MetricsRegistry) -> str:
    """Prometheus text exposition (0.0.4) of every declared metric."""
    out = []
    for name, (help, type) in reg._meta.items():
        if help:
            out.append(f"# HELP {name} {_escape(help)}")
        out.append(f"# TYPE {name} {type}")
        for key, value in sorted(reg._samples.get(name, {}).items()):
            if key:
                lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
                out.append(f"{name}{{{lbl}}} {_fmt_value(value)}")
            else:
                out.append(f"{name} {_fmt_value(value)}")
    return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> Dict[Tuple[str, LabelSet], float]:
    """Parse a text exposition back to ``{(name, labelset): value}``.

    Strict: raises ``ValueError`` on an unparseable sample line, on a
    sample whose metric has no preceding ``# TYPE`` declaration, or on
    an unknown metric type — the round-trip gate the soak smoke and CI
    use to prove the ``.prom`` file is real Prometheus format.
    """
    declared: Dict[str, str] = {}
    out: Dict[Tuple[str, LabelSet], float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram", "summary",
                                                   "untyped"):
                raise ValueError(f"line {ln}: bad TYPE line {line!r}")
            declared[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        name = m.group("name")
        if name not in declared:
            raise ValueError(f"line {ln}: sample for undeclared metric "
                             f"{name!r}")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(raw):
                labels[pm.group(1)] = _unescape(pm.group(2))
                consumed += len(pm.group(0))
            if consumed < len(raw.replace(",", "").replace(" ", "")):
                raise ValueError(f"line {ln}: bad label block {raw!r}")
        v = m.group("value")
        try:
            value = float(v)
        except ValueError:
            raise ValueError(f"line {ln}: bad sample value {v!r}")
        out[(name, _labelset(labels))] = value
    return out
