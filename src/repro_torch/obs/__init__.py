"""Observatory: zero-dependency fabric telemetry.

The soak driver (``repro_torch.sim.traffic.soak``) folds each epoch's fabric
counters — queue depth max/p99, PFC pauses, ECN marks, drops,
retransmits, per-tenant FCT percentiles — into a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, renders it in Prometheus
text exposition format, and dumps it to a ``.prom`` file that
``repro_torch.obs.exporter`` can serve over HTTP with nothing but the stdlib.
``repro_torch.obs.trend`` keeps the cross-PR benchmark trajectory
(``BENCH_history.jsonl``) and gates regressions against the best run in
history, not just the last one.

Everything here is pure stdlib: no prometheus_client, no torch.
The port's copy of ``repro.obs``.
"""
from .metrics import (MetricsRegistry, parse_prometheus,  # noqa: F401
                      render_prometheus)
from .trend import append_run, gate_and_append, load_history, \
    trend_problems  # noqa: F401
