"""Reading a ``torch.profiler`` chrome trace: device intervals and what
launched them.

Device time is read from the timeline's intervals, never from sums of
kernel times alone: the busy time is the union of every device op's
interval inside the window, so ops that overlap (an NCCL kernel beside
an FFT) count once.  Each device op is attributed to the innermost
``perfbench.*`` range that was open on the host thread that launched it
(kernel and launch share a correlation id), so the harness's own ops are
told apart from the program's.

The port's hand-written kernels are named by scanning
``src/repro_torch/kernels/csrc/*.cu`` for their ``__global__`` functions:
a kernel added later is found without an edit here.  NCCL's kernels are
those whose name holds ``nccl``.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Iterable, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
RANGE_PREFIX = "perfbench."

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"([A-Za-z_]\w*)\s*\(")


def handwritten_kernels(csrc: Path) -> dict:
    """``{source stem: [kernel function names]}`` of every ``.cu``."""
    return {p.stem: sorted(set(_GLOBAL.findall(p.read_text())))
            for p in sorted(Path(csrc).glob("*.cu"))}


def name_matcher(names: Iterable[str]) -> Callable[[str], bool]:
    """True for a device op named after one of ``names`` (as a whole
    identifier inside the demangled name)."""
    names = sorted(set(names))
    if not names:
        return lambda name: False
    pat = re.compile(r"(?<![A-Za-z0-9_])(?:" + "|".join(map(re.escape, names))
                     + r")(?![A-Za-z0-9_])")
    return lambda name: pat.search(name) is not None


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def union(intervals: Iterable[tuple]) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def measure(merged: list) -> float:
    return sum(e - s for s, e in merged)


def intersect(a: list, b: list) -> list:
    """Intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _innermost(ranges: list, points: list) -> list:
    """For each point, the name of the innermost of the (start, end,
    name) ranges that holds it (ranges nest), or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out, stack, k = [None] * len(points), [], 0
    for i in order:
        t = points[i]
        while k < len(ranges) and ranges[k][0] <= t:
            stack.append(ranges[k])
            k += 1
        # a range that closed before t sits above any range that holds t
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


class Timeline:
    """The device ops of one rank inside the traced window."""

    def __init__(self, trace: dict, window: str = WINDOW):
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X"]
        marks = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == window]
        if not marks:
            raise ValueError(f"the trace holds no {window!r} range")
        mark = marks[-1]
        self.t0 = float(mark["ts"])
        self.t1 = self.t0 + float(mark["dur"])
        self.host_tid = mark.get("tid")
        launches = {}
        ranges, host = defaultdict(list), []
        for e in events:
            cat = e.get("cat")
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), float(e["ts"]))
            elif cat == "user_annotation" and e["name"].startswith(RANGE_PREFIX):
                s = float(e["ts"])
                ranges[e.get("tid")].append((s, s + float(e["dur"]), e["name"]))
            if cat in ("user_annotation", "cpu_op") and \
                    e.get("tid") == self.host_tid:
                s = float(e["ts"])
                host.append((s, s + float(e["dur"]), e["name"]))
        self._host = host
        ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s = max(float(e["ts"]), self.t0)
            t = min(float(e["ts"]) + float(e.get("dur", 0)), self.t1)
            if t > s:
                ops.append([e["name"], s, t,
                            launches.get(e.get("args", {}).get("correlation"))])
        # the range each op was launched under
        by_tid = defaultdict(list)
        for k, op in enumerate(ops):
            if op[3] is not None:
                by_tid[op[3][0]].append(k)
        for tid, idx in by_tid.items():
            names = _innermost(ranges.get(tid, []),
                               [ops[k][3][1] for k in idx])
            for k, name in zip(idx, names):
                ops[k][3] = name
        for op in ops:
            if isinstance(op[3], tuple):
                op[3] = None
        self.ops = [tuple(op) for op in ops]   # (name, start, end, range)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def has_device_ops(self) -> bool:
        return bool(self.ops)

    def select(self, pred: Callable[[tuple], bool]) -> list:
        return [op for op in self.ops if pred(op)]

    def busy(self, ops: Optional[list] = None) -> list:
        return union((s, e) for _, s, e, _ in
                     (self.ops if ops is None else ops))

    def busy_s(self) -> float:
        return measure(self.busy()) * 1e-6

    def time_s(self, ops: list) -> float:
        """Sum of the ops' times (overlaps count each time)."""
        return sum(e - s for _, s, e, _ in ops) * 1e-6

    def exposed_s(self, mine: list) -> float:
        """Time during which one of ``mine`` runs and no other op does."""
        own = self.busy(mine)
        chosen = set(map(id, mine))
        rest = self.busy([op for op in self.ops if id(op) not in chosen])
        return (measure(own) - measure(intersect(own, rest))) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for name, s, e, _ in self.ops:
            total[name] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time inside the window, summed by what the launching
        thread was doing at each gap's middle: the innermost
        ``perfbench.*`` range and, inside it, the innermost op."""
        busy, gaps, t = self.busy(), [], self.t0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.t1:
            gaps.append((t, self.t1))
        mids = [(s + e) / 2 for s, e in gaps]
        ours = _innermost([r for r in self._host
                           if r[2].startswith(RANGE_PREFIX)], mids)
        ops = _innermost([r for r in self._host
                          if not r[2].startswith(RANGE_PREFIX)], mids)
        total = defaultdict(float)
        for (s, e), rng, op in zip(gaps, ours, ops):
            label = " > ".join(x for x in (rng or "outside any range",
                                           op or "python") if x)
            total[label] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]
