"""Span tracer: thread-safe, nestable, Chrome-trace-event export.

Port of ``repro/obs/tracer.py``, a copy of that pure-Python module (the
port imports nothing of ``repro``).  Every measured claim about *where
time goes* — the paper's FFT-hides-MPI overlap story, the tuner's
measurement traffic — flows through one tracer so a single
``trace.json`` can be dropped into ``chrome://tracing`` / Perfetto.

Design constraints:

  * **zero-cost when disabled** — the default tracer is a
    :class:`NoopTracer` whose ``span()`` returns one shared null context
    manager (no allocation per call), and spans are host-side only: they
    record host clocks and launch nothing on the device;
  * **thread-safe** — the serve worker, plan-cache upgrade threads, and
    client threads emit concurrently into one lock-guarded ring buffer
    (``maxlen`` bounds memory under continuous serving);
  * **retroactive spans** — cross-thread phases (a request's queue wait
    starts on the client thread, ends on the worker) are recorded with
    :meth:`Tracer.complete` from explicit ``time.monotonic()``
    timestamps, the same clock ``TransformRequest.t_submit`` uses.

Span categories (the ``cat`` field, filterable in Perfetto):

  ``plan``        planning / compile / whole-transform anchors
  ``pack``        prologue packing (PackTwo, stack-and-pad, ...)
  ``fft``         local FFT compute legs
  ``collective``  global transposes (all_to_all / ppermute rounds)
  ``unpack``      epilogue unpacking (UnpackTwo, SplitPairs, ...)
  ``epilogue``    terminal schedule epilogues (fused k-space multiply)
  ``queue``       serve-side waits (queue, batch assembly)
  ``h2d/d2h``     host<->device payload hops
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Optional

CATEGORIES = ("plan", "pack", "fft", "collective", "unpack", "epilogue",
              "queue", "h2d/d2h")

_PID = os.getpid()

# thread-local ambient tags (see tag_scope): merged into every span's args
# so e.g. tuner-issued transforms are distinguishable from serving traffic
_local = threading.local()


def current_tags() -> dict:
    stack = getattr(_local, "tags", None)
    return dict(stack[-1]) if stack else {}


@contextlib.contextmanager
def tag_scope(**tags):
    """Attach ``tags`` to every span/event emitted by this thread inside
    the scope (``tuning.measure`` wraps its timing runs in
    ``tag_scope(traffic="tuning")`` so tuner traffic never masquerades
    as serving traffic in a shared trace)."""
    stack = getattr(_local, "tags", None)
    if stack is None:
        stack = _local.tags = []
    merged = dict(stack[-1]) if stack else {}
    merged.update(tags)
    stack.append(merged)
    try:
        yield
    finally:
        stack.pop()


class _NullSpan:
    """Shared no-op context manager (one instance, zero per-call cost)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NoopTracer:
    """The default tracer: every method is a no-op.

    Instrumented call sites are written ``get_tracer().span(...)``; with
    this tracer installed that is one attribute lookup and a shared null
    context manager — nothing allocated, nothing recorded.
    """

    enabled = False

    def span(self, name: str, cat: str = "plan", **args):
        return _NULL_SPAN

    def complete(self, name, cat, t_start, t_end, args=None):
        pass

    def instant(self, name, cat="plan", args=None):
        pass

    def add_meta(self, key, value):
        pass

    def events(self):
        return []


NOOP = NoopTracer()


class _SpanCtx:
    """Context manager recording one complete ("X") span on exit."""

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer, name, cat, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def set(self, **kw):
        """Attach result attributes discovered while the span is open."""
        self.args.update(kw)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.tracer.complete(self.name, self.cat, self.t0, time.monotonic(),
                             self.args)
        return False


class Tracer:
    """Thread-safe span recorder over a bounded ring buffer.

    Events are Chrome-trace dicts (``ph``: "X" complete spans, "i"
    instants, with ``ts``/``dur`` in microseconds on the
    ``time.monotonic()`` clock re-based to the tracer's creation).
    ``save(path)`` writes the ``{"traceEvents": [...]}`` JSON object
    form that chrome://tracing and Perfetto load directly.
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        self.t0 = time.monotonic()
        self._events = collections.deque(maxlen=capacity)
        self._meta: dict = {}
        self._lock = threading.Lock()
        self.dropped = 0

    # -- emission -------------------------------------------------------
    def span(self, name: str, cat: str = "plan", **args):
        merged = current_tags()
        merged.update(args)
        return _SpanCtx(self, name, cat, merged)

    def complete(self, name: str, cat: str, t_start: float, t_end: float,
                 args: Optional[dict] = None) -> None:
        """Record a finished span from explicit monotonic timestamps
        (cross-thread phases: queue wait starts on the submitting
        thread, ends on the worker)."""
        merged = current_tags()
        if args:
            merged.update(args)
        ev = {"name": name, "cat": cat, "ph": "X", "pid": _PID,
              "tid": threading.get_ident(),
              "ts": (t_start - self.t0) * 1e6,
              "dur": max(0.0, (t_end - t_start)) * 1e6,
              "args": merged}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def instant(self, name: str, cat: str = "plan",
                args: Optional[dict] = None) -> None:
        merged = current_tags()
        if args:
            merged.update(args)
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": _PID,
              "tid": threading.get_ident(),
              "ts": (time.monotonic() - self.t0) * 1e6, "args": merged}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def add_meta(self, key: str, value) -> None:
        """Attach trace-level metadata (plan descriptions, model
        predictions) — what a report joins spans against."""
        with self._lock:
            self._meta[key] = value

    # -- export ---------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def meta(self) -> dict:
        with self._lock:
            return dict(self._meta)

    def to_chrome(self) -> dict:
        """The chrome://tracing / Perfetto JSON object form."""
        with self._lock:
            return {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "metadata": dict(self._meta, dropped_events=self.dropped),
            }

    def save(self, path: str) -> str:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path


# ---------------------------------------------------------------------------
# global tracer slot
# ---------------------------------------------------------------------------

_tracer: "NoopTracer | Tracer" = NOOP
_tracer_lock = threading.Lock()


def get_tracer():
    """The process-wide tracer (the :data:`NOOP` singleton by default)."""
    return _tracer


def set_tracer(tracer) -> None:
    global _tracer
    with _tracer_lock:
        _tracer = tracer if tracer is not None else NOOP


def enable(capacity: int = 65536) -> Tracer:
    """Install (and return) a recording tracer; idempotent if one is
    already installed."""
    global _tracer
    with _tracer_lock:
        if not _tracer.enabled:
            _tracer = Tracer(capacity)
        return _tracer


def disable() -> None:
    set_tracer(NOOP)


@contextlib.contextmanager
def tracing(path: Optional[str] = None, capacity: int = 65536):
    """Scope with a fresh recording tracer installed globally; on exit
    the previous tracer is restored and, when ``path`` is given, the
    trace is saved there.

        with obs.tracing("trace.json") as tr:
            plan.forward(x)           # host-side spans land in tr
    """
    global _tracer
    with _tracer_lock:
        prev = _tracer
        tr = Tracer(capacity)
        _tracer = tr
    try:
        yield tr
    finally:
        with _tracer_lock:
            _tracer = prev
        if path is not None:
            tr.save(path)
