"""Metrics registry: counters, gauges, log-bucketed histograms.

Port of ``repro/obs/metrics.py``, a copy of that pure-Python module (the
port imports nothing of ``repro``).

One named registry per subsystem (the transform service owns one; the
tuner and benchmarks share the process-default one).  Two export
formats from the same objects:

  * :meth:`MetricsRegistry.snapshot` — JSON-able dict, embedded into
    ``BENCH_*.json`` so bench artifacts and live metrics share a schema;
  * :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
    (``# TYPE`` headers, ``_bucket{le=...}`` cumulative histograms) for
    scraping a long-running service.

Histograms are log-bucketed by default (geometric bucket edges, so the
p99 of a microsecond-to-second latency range costs ~100 buckets, not
10^6) with interpolated quantile estimation — accuracy is bounded by
the bucket growth factor, pinned against numpy in tests/test_obs.py.
Exact small-integer distributions (batch sizes) use explicit ``bounds``
instead.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Optional, Sequence

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-value gauge."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Log-bucketed histogram with interpolated quantiles.

    Default buckets are geometric: edge ``i`` is ``lo * growth**i`` (64
    of them span ``[1us, ~1000s]`` at the default growth of 1.4), so a
    quantile estimate is exact to within one growth factor — the
    linear interpolation inside the winning bucket cuts that further.
    ``bounds`` overrides with explicit edges (exact integer histograms
    like batch sizes: ``bounds=range(1, max_batch + 1)``).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", lo: float = 1e-6,
                 growth: float = 1.4, n_buckets: int = 64,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        if bounds is not None:
            self.bounds = [float(b) for b in bounds]
            if self.bounds != sorted(self.bounds):
                raise ValueError("bounds must be sorted")
        else:
            if lo <= 0 or growth <= 1:
                raise ValueError("need lo > 0 and growth > 1")
            self.bounds = [lo * growth ** i for i in range(n_buckets)]
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    # -- reads ----------------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def buckets(self) -> list:
        """[(upper_edge, cumulative_count)] including the +Inf bucket."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for edge, c in zip(self.bounds, counts):
            cum += c
            out.append((edge, cum))
        out.append((math.inf, cum + counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile estimate (None when empty).

        Rank ``q * count`` is located in the cumulative bucket counts;
        the estimate interpolates linearly across the winning bucket's
        [lower, upper) edge range, clamped to the observed min/max so
        single-bucket distributions report honest extremes.
        """
        with self._lock:
            counts = list(self._counts)
            count, vmin, vmax = self._count, self._min, self._max
        if not count:
            return None
        q = min(1.0, max(0.0, q))
        rank = q * count
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lower = self.bounds[i - 1] if i > 0 else min(
                    vmin, self.bounds[0])
                upper = self.bounds[i] if i < len(self.bounds) else vmax
                frac = (rank - cum) / c
                est = lower + frac * (upper - lower)
                return min(max(est, vmin), vmax)
            cum += c
        return vmax

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            vmin = self._min if count else None
            vmax = self._max if count else None
        # sparse bucket map (log histograms are mostly empty)
        nonzero = {("+Inf" if i == len(self.bounds) else repr(self.bounds[i])):
                   c for i, c in enumerate(counts) if c}
        return {"type": "histogram", "count": count, "sum": total,
                "min": vmin, "max": vmax, "buckets": nonzero,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named metric store: get-or-create, snapshot, Prometheus text."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get(name, lambda: Counter(name, help))
        if not isinstance(m, Counter):
            raise TypeError(f"{name!r} is a {m.kind}, not a counter")
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get(name, lambda: Gauge(name, help))
        if not isinstance(m, Gauge):
            raise TypeError(f"{name!r} is a {m.kind}, not a gauge")
        return m

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        m = self._get(name, lambda: Histogram(name, help, **kw))
        if not isinstance(m, Histogram):
            raise TypeError(f"{name!r} is a {m.kind}, not a histogram")
        return m

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def snapshot_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (histograms cumulative)."""
        with self._lock:
            metrics = dict(self._metrics)
        lines = []
        for name, m in sorted(metrics.items()):
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{pname} {m.value:g}")
            else:
                for edge, cum in m.buckets():
                    le = "+Inf" if math.isinf(edge) else f"{edge:g}"
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {m.sum:g}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# process-default registry (the tuner, benches, and CLIs share it; the
# transform service owns its own so two services never mix counters)
# ---------------------------------------------------------------------------

_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(reg: MetricsRegistry) -> None:
    global _default
    with _default_lock:
        _default = reg
