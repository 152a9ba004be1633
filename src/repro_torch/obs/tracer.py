"""Span tracer: thread-safe, nestable, Chrome-trace-event export.

Port of ``repro/obs/tracer.py``, a copy of that pure-Python module (the
port imports nothing of ``repro``).  Every measured claim about *where
time goes* — the paper's FFT-hides-MPI overlap story, the tuner's
measurement traffic — flows through one tracer so a single
``trace.json`` can be dropped into ``chrome://tracing`` / Perfetto.

Design constraints:

  * **zero-cost when disabled** — the default tracer is a
    :class:`NoopTracer` whose ``span()`` returns one shared null context
    manager (no allocation per call).  The port's hot path calls the
    module-level :func:`span`, which with no recording tracer installed
    and no ``torch.profiler`` recording costs one read of the tracer
    slot and one of the profiler's flag, and returns the same shared
    null context;
  * **spans launch nothing on the device** — a span records host clocks;
    where it is given the device of its work and that is a CUDA device,
    a recording span also takes a pair of timing events on the current
    stream (the NVTX model: spans light up when someone looks), resolved
    once they have completed, with no synchronize of the span's own.
    Only the spans whose device time something reads are given their
    device; the rest are host clocks and profiler ranges alone;
  * **under a profiler** — while ``torch.profiler`` records, a :func:`span`
    also opens ``record_function("repro_torch.<name>")``, so it lies in
    the profiler's trace beside the device ops it launched.  With no
    tracer installed, its count, host and device seconds go into the
    record of the newest profiled session (:func:`profiled`);
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

import torch
import torch.autograd.profiler as _autograd_profiler

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

    A :func:`span` timed on a CUDA device also gets ``args["device_ms"]``,
    the device milliseconds between its pair of timing events, and
    :meth:`device_ms` totals them by span name (saved as
    ``metadata.device_ms_by_span`` where there are any).
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        self.t0 = time.monotonic()
        self._events = collections.deque(maxlen=capacity)
        self._meta: dict = {}
        self._lock = threading.Lock()
        self._pairs = _Pairs(self._add_device)
        self._device_ms: dict = {}
        self.dropped = 0

    # -- emission -------------------------------------------------------
    def span(self, name: str, cat: str = "plan", **args):
        merged = current_tags()
        merged.update(args)
        return _SpanCtx(self, name, cat, merged)

    def complete(self, name: str, cat: str, t_start: float, t_end: float,
                 args: Optional[dict] = None) -> dict:
        """Record a finished span from explicit monotonic timestamps
        (cross-thread phases: queue wait starts on the submitting
        thread, ends on the worker); returns its event."""
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
        return ev

    def _port_span(self, name, cat, t_start, t_end, args, pair) -> None:
        ev = self.complete(name, cat, t_start, t_end, args)
        with self._lock:
            self._pairs.put(pair, ev, cat)

    def _add_device(self, ev: dict, ms: float) -> None:
        ev["args"]["device_ms"] = ms
        self._device_ms[ev["name"]] = self._device_ms.get(ev["name"], 0.0) + ms

    def device_ms(self) -> dict:
        """Device milliseconds by span name, once every pending pair of
        timing events has completed (this waits for the device)."""
        with self._lock:
            self._pairs.drain(wait=True)
            return dict(self._device_ms)

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
        dev = self.device_ms()
        extra = {"device_ms_by_span": dev} if dev else {}
        with self._lock:
            return {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "metadata": dict(self._meta, dropped_events=self.dropped,
                                 **extra),
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
    trace is saved there.  The port's spans on a CUDA device are timed
    there too (:class:`Tracer`).

        with obs.tracing("trace.json") as tr:
            plan.forward(x)           # the plan's spans land in tr
        tr.device_ms()                # device ms by span name
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


# ---------------------------------------------------------------------------
# the port's hot-path spans
# ---------------------------------------------------------------------------

# Timing events once read, by device, for later spans to record again:
# making and destroying a CUDA event costs more host time than recording
# one.  Pending pairs are read at the exit of a ``plan`` span (an API
# anchor: the host has queued its transform and the device is busy with
# it), or once this many wait; never at every span's exit, where each
# query would cost host time between launches.
_spare_events = collections.defaultdict(list)
_READ_EVERY = 4096


def _timing_event(device):
    """A timing event recorded now on ``device``'s current stream; None
    where the work is not on a CUDA device."""
    if device is None or device.type != "cuda":
        return None
    try:
        ev = _spare_events[device].pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Pairs:
    """Pairs of timing events waiting to be read, each with the key its
    milliseconds go to (``add(key, ms)``): the one device-time path of a
    :class:`Tracer` and of the profiled record.  Its owner holds the
    lock around every call."""

    __slots__ = ("pending", "add")

    def __init__(self, add):
        self.pending = collections.deque()
        self.add = add

    def put(self, pair, key, cat: str) -> None:
        """Queue a span's ``(start, end, device)`` pair (None where it was
        not timed); read the completed ones at a ``plan`` span's exit, or
        once :data:`_READ_EVERY` wait."""
        if pair is not None:
            self.pending.append((pair, key))
        if cat == "plan" or len(self.pending) >= _READ_EVERY:
            self.drain()

    def drain(self, wait: bool = False) -> None:
        """Hand each completed pair to ``add``, oldest first, and keep its
        events for reuse; with ``wait``, every pair, waiting for the
        device."""
        pending = self.pending
        while pending:
            (start, end, device), key = pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            pending.popleft()
            self.add(key, start.elapsed_time(end))
            _spare_events[device] += (start, end)


class _Record:
    """The port's spans in one profiled session, by name: ``{"count",
    "host_s", "device_s"}`` (``device_s`` None where no span of the name
    was timed on a CUDA device).  Bounded by the number of names."""

    def __init__(self):
        self.spans: dict = {}
        self.read = False
        self._pairs = _Pairs(self._add_device)
        self._lock = threading.Lock()

    def add(self, name: str, cat: str, host_s: float, pair) -> bool:
        """Count one span; False, and nothing counted, once the record
        has been read."""
        with self._lock:
            if self.read:
                return False
            row = self.spans.get(name)
            if row is None:
                row = self.spans[name] = {"count": 0, "host_s": 0.0,
                                          "device_s": None}
            row["count"] += 1
            row["host_s"] += host_s
            self._pairs.put(pair, name, cat)
            return True

    def _add_device(self, name: str, ms: float) -> None:
        row = self.spans[name]
        row["device_s"] = (row["device_s"] or 0.0) + ms * 1e-3

    def resolved(self) -> dict:
        """Every pair resolved (this waits for the device); marks the
        record read."""
        with self._lock:
            self._pairs.drain(wait=True)
            self.read = True
            return self.spans


_record: Optional[_Record] = None
_record_lock = threading.Lock()


def _add_profiled(name: str, cat: str, host_s: float, pair) -> None:
    """Count a span into the newest profiled session's record; the first
    span after a read of the record starts a fresh one."""
    global _record
    while True:
        rec = _record
        if rec is None or rec.read:
            with _record_lock:
                if _record is rec:
                    _record = _Record()
                rec = _record
        if rec.add(name, cat, host_s, pair):
            return


def profiled() -> dict:
    """The port's spans of the newest profiled session: ``{span name:
    {"count": n, "host_s": s, "device_s": s or None}}``, every timing
    event resolved (this waits for the device).

    While ``torch.profiler`` records and no :class:`Tracer` is installed,
    every :func:`span` is counted here; the first span after a read
    starts a fresh record, so a read right after a profiled window holds
    that window's spans alone, and reads with no span between them
    return the same record.  Empty before any profiled span."""
    rec = _record
    return {} if rec is None else rec.resolved()


class _PortSpan:
    """A recording :func:`span`: host clocks; the profiler's
    ``repro_torch.<name>`` range while the profiler records; a pair of
    timing events where it was given its work's device and that is a
    CUDA device.  Holds no tensor."""

    __slots__ = ("tracer", "name", "cat", "args", "device", "t0", "rf",
                 "start")

    def __init__(self, tracer, name, cat, device, args):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args
        self.device = device
        self.t0, self.rf, self.start = 0.0, None, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function("repro_torch."
                                                     + self.name)
            self.rf.__enter__()
        self.start = _timing_event(self.device)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.monotonic()
        pair = None
        if self.start is not None:
            pair = (self.start, _timing_event(self.device), self.device)
            self.start = None
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
            self.rf = None
        if self.tracer.enabled:
            if exc_type is not None:
                self.args.setdefault("error", exc_type.__name__)
            self.tracer._port_span(self.name, self.cat, self.t0, t1,
                                   self.args, pair)
        else:
            _add_profiled(self.name, self.cat, t1 - self.t0, pair)
        return False


def span(name: str, cat: str = "plan", device=None, **args):
    """A span of the port's hot path, at a layer boundary::

        with span("transpose:pack", "pack", mesh.device):
            send = chunks.contiguous()

    ``device`` is where the span's work runs (a ``torch.device``; not an
    arg), given only where something reads the span's device time (a
    pair of timing events a span, which includes any idle of the stream
    between them); the others, and the API's ``plan`` anchors, pass none
    and take no events.  ``args`` hold ints and strings.  With no recording tracer
    installed and no ``torch.profiler`` recording it returns the shared
    null context: one read of the tracer slot, one of the profiler's
    flag, nothing recorded.  Otherwise it records into the installed
    :class:`Tracer`, or, under a profiler with none installed, into the
    profiled session's record (:func:`profiled`)."""
    tracer = _tracer
    if not tracer.enabled and not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _PortSpan(tracer, name, cat, device, args)
