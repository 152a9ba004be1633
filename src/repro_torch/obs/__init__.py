"""repro_torch.obs — stage-level tracing, metrics and overlap attribution
(port of ``repro.obs``).

Three pieces:

  * :mod:`repro_torch.obs.tracer` — thread-safe span tracer with
    Chrome-trace JSON export and an in-process ring buffer; a no-op
    tracer is the process default.  The port's hot path (``Croft3D``,
    the executor's stage legs and transposes, the packed real pipeline,
    ``poisson_solve``'s multiplier, the inverse's 1/N) opens
    :func:`span` calls, which cost one read of the tracer slot and one of
    the profiler's flag until :func:`enable` / :func:`tracing` installs
    a real tracer or ``torch.profiler`` records.  Under a profiler a
    span is a ``repro_torch.<name>`` range in the profiler's trace, and
    :func:`profiled` gives the session's spans by name with their host
    and device seconds (device time from a pair of timing events on the
    span's stream, taken only while someone records).
  * :mod:`repro_torch.obs.metrics` — named counters, gauges and
    log-bucketed histograms with quantile estimation; JSON snapshots and
    Prometheus text exposition.
  * :mod:`repro_torch.obs.instrument` / :mod:`repro_torch.obs.report` —
    re-drive a plan's schedule stage by stage with host-side timing
    shims, attach the collectives ``Mesh.counting()`` counts, and join
    the measured per-stage timings against the analytic cost model
    (``python -m repro_torch.obs.report trace.json``) to produce the
    overlap-efficiency table the paper's 42–51 % hiding claim is about.

The tuner reads the collective calibration gauges and writes its
``tune_*`` and ``wisdom_corrupt_files`` counters here, and wraps its
timing runs in ``tag_scope(traffic="tuning")``.
"""

from repro_torch.obs.tracer import (  # noqa: F401
    CATEGORIES,
    NOOP,
    NoopTracer,
    Tracer,
    current_tags,
    disable,
    enable,
    get_tracer,
    profiled,
    set_tracer,
    span,
    tag_scope,
    tracing,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)

__all__ = [
    "CATEGORIES", "NOOP", "NoopTracer", "Tracer", "current_tags",
    "disable", "enable", "get_tracer", "profiled", "set_tracer", "span",
    "tag_scope", "tracing", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry",
]
