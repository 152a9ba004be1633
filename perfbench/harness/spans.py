"""Reading what the port records of itself: the spans of the traced
window, from ``repro_torch.obs.profiled()`` (the record the port keeps of
the newest profiled session: per span name its count and its host and
device seconds), and the counters of its process registry.

The window is the only profiled session of a run (the warm-up runs
before the profiler starts, the check after it stops), so the record is
the window's.  A program that keeps no such record, span or counter
gives nothing to read: each function returns None and raises nothing.
"""

from __future__ import annotations

from typing import Iterable, Optional


def device_ms_per_step(ctx, names: Iterable[str]) -> Optional[float]:
    """Device milliseconds per step of the spans ``names`` (each span's
    time between its pair of timing events on its stream), summed; None
    off the card, or where the program recorded none of them.  The
    interval includes any idle of the stream inside the span, such as the
    host's launch latency where a span opens a step, so a change of host
    time alone can move it."""
    if not ctx.on_card():
        return None
    try:
        from repro_torch.obs import profiled
    except ImportError:
        return None
    record = profiled()
    rows = [record[n] for n in names if n in record]
    if not rows or any(r.get("device_s") is None for r in rows):
        return None
    return sum(r["device_s"] for r in rows) / ctx.steps * 1e3


def counter(ctx, name: str) -> Optional[float]:
    """The value of the program's counter ``name`` in its process
    registry; None off the card, or where it has no such counter."""
    if not ctx.on_card():
        return None
    try:
        from repro_torch.obs.metrics import get_registry
    except ImportError:
        return None
    found = get_registry().get(name)
    return None if found is None else float(found.value)
