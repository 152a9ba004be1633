"""Persistent wisdom — FFTW's ``fftw_export_wisdom`` for the planner.

Port of ``repro/tuning/wisdom.py``: the same JSON format, checksum, lock,
quarantine and merge, so a file written by either package loads in the
other.  The backend field of a key is ``"cpu"`` for plans on CPU
tensors, ``"gpu"`` on the card (the name the reference's JAX gives the
same backend) and ``"any"`` for meshless ``mode="model"`` tunes.

A wisdom store is a JSON file mapping problem keys to the winning
(decomposition, options) plus how the winner was chosen (model score or
measured seconds).  The key captures everything the plan depends on:

    Nx x Ny x Nz | mesh axis names+sizes | dtype | backend [| problem]

(the problem suffix appears for non-default problem classes, i.e.
``r2c`` — c2c keys keep the original four-field format so existing
wisdom files stay valid) so a plan tuned once (e.g. on the job's first
process, or in a previous run) is reused everywhere the same problem
shows up.  ``merge`` keeps the better-measured entry on key collisions,
so wisdom files can be combined across hosts like FFTW wisdom.

Command line (FFTW's ``fftw-wisdom`` tool analogue)::

    python -m repro_torch.tuning.wisdom merge OUT.json [IN.json ...] [--seed]
    python -m repro_torch.tuning.wisdom show PATH.json
    python -m repro_torch.tuning.wisdom stats PATH.json

``--seed`` folds in the shipped seed wisdom (``seed_wisdom.json``,
model-mode plans for common shape/mesh/problem combinations, priced
under the card's priors; measured entries from your own runs always take
precedence on merge).

Concurrency: the serving plan cache's background measurement thread
writes wisdom while requests are in flight, and several service
processes may share one wisdom file.  All persistent writes therefore go
through :func:`merge_entries` — reload-latest + record + write-to-temp +
atomic rename, serialized by a lock file — so concurrent writers merge
instead of clobbering each other's entries (last-loader-wins lost
updates).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.decomposition import Decomposition
from repro_torch.core.distributed import FFTOptions
from repro_torch.resil import inject as inject_lib
from repro_torch.tuning.candidates import Candidate

WISDOM_VERSION = 1
DEFAULT_PATH_ENV = "CROFT_WISDOM"
SEED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "seed_wisdom.json")


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``torch.complex64`` ->
    ``"complex64"``), the key's dtype field."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def backend_of(mesh) -> str:
    """The key's backend field: ``"gpu"`` for a mesh on the card, ``"cpu"``
    for one on CPU tensors, ``"any"`` without a mesh."""
    if mesh is None:
        return "any"
    return "gpu" if torch.device(mesh.device).type == "cuda" else "cpu"


def wisdom_key(shape: Sequence[int], axis_sizes: Mapping[str, int],
               dtype, backend: str, problem: str = "c2c",
               batch: int = 1) -> str:
    from repro_torch.tuning.candidates import split_grad
    shape_s = "x".join(str(int(s)) for s in shape)
    # canonical order: the same problem must hash identically regardless
    # of how the caller ordered the axis mapping
    mesh_s = ",".join(f"{n}={int(s)}"
                      for n, s in sorted(axis_sizes.items()))
    key = f"{shape_s}|{mesh_s}|{dtype_name(dtype)}|{backend}"
    base_problem, is_grad = split_grad(problem)
    if base_problem != "c2c":  # c2c keys keep the legacy four-field format
        key += f"|{base_problem}"
    if batch != 1:  # unbatched keys keep the legacy format (= b1), so
        key += f"|b{int(batch)}"  # wisdom written before the batch
        # dimension existed still hits for batch=1 problems
    if is_grad:  # training-step plans never collide with inference plans
        key += "|grad"
    return key


def _listify(axes):
    return [list(a) if isinstance(a, tuple) else a for a in axes]


def _tuplify(axes):
    return tuple(tuple(a) if isinstance(a, list) else a for a in axes)


@dataclasses.dataclass
class WisdomEntry:
    """The chosen plan for one problem key."""

    decomp_kind: str
    decomp_axes: tuple
    opts: dict                      # FFTOptions fields
    source: str                     # "model" | "measure"
    model_s: Optional[float] = None
    measured_s: Optional[float] = None
    hlo: Optional[dict] = None      # collective stats of the winner
    created: Optional[float] = None
    problem: str = "c2c"            # "c2c" | "r2c"
    strategy: Optional[str] = None  # r2c: "packed" | "embed"
    #: searched-schedule winners: the full ``sched:...`` plan token.  The
    #: legacy fields above still describe the data placement, so wisdom
    #: readers that predate the schedule search parse these entries as a
    #: (decomp, opts) plan (from_json drops the unknown key); readers
    #: that understand it reconstruct the exact pipeline from the token.
    schedule: Optional[str] = None

    def candidate(self) -> Candidate:
        if self.schedule is not None:
            from repro_torch.tuning.candidates import ScheduleCandidate
            return ScheduleCandidate.from_plan_key(self.schedule)
        # tolerate opts written by other versions: unknown keys dropped
        known = {f.name for f in dataclasses.fields(FFTOptions)}
        opts = {k: v for k, v in self.opts.items() if k in known}
        return Candidate(Decomposition(self.decomp_kind,
                                       _tuplify(self.decomp_axes)),
                         FFTOptions(**opts), problem=self.problem,
                         strategy=self.strategy)

    @classmethod
    def from_candidate(cls, cand: Candidate, source: str,
                       model_s: Optional[float] = None,
                       measured_s: Optional[float] = None,
                       hlo: Optional[dict] = None) -> "WisdomEntry":
        return cls(decomp_kind=cand.decomp.kind,
                   decomp_axes=cand.decomp.axes,
                   opts=dataclasses.asdict(cand.opts), source=source,
                   model_s=model_s, measured_s=measured_s, hlo=hlo,
                   created=time.time(), problem=cand.problem,
                   strategy=getattr(cand, "strategy", None),
                   schedule=cand.plan_key
                   if getattr(cand, "is_schedule", False) else None)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["decomp_axes"] = _listify(self.decomp_axes)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "WisdomEntry":
        d = dict(d)
        d["decomp_axes"] = _tuplify(d.get("decomp_axes", []))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def better_of(self, other: "WisdomEntry") -> "WisdomEntry":
        """Prefer measured over modeled, then the faster measurement.
        Between two unmeasured (model) entries the newer one wins, so
        cost-model improvements propagate into existing wisdom files
        (and merging an old file back in cannot clobber fresh plans)."""
        mine, theirs = self.measured_s, other.measured_s
        if mine is None and theirs is None:
            if (other.created or 0.0) >= (self.created or 0.0):
                return other
            return self
        if mine is None:
            return other
        if theirs is None or mine <= theirs:
            return self
        return other


def _entries_checksum(entries_json: Mapping) -> str:
    """Integrity checksum over the canonical entries JSON.  A store
    whose stored checksum disagrees was truncated or bit-rotted (a
    crashed writer cannot cause this — writes are temp-file + atomic
    rename); it is moved aside and rebuilt from model mode."""
    blob = json.dumps(entries_json, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def quarantine_corrupt(path: str) -> Optional[str]:
    """Move a corrupt wisdom file aside to ``<path>.corrupt-<n>`` (first
    free n) so the evidence survives for forensics while the planner
    rebuilds from model mode.  Returns the new name, or None if another
    process won the rename (or the move failed)."""
    for n in range(1, 1000):
        dst = f"{path}.corrupt-{n}"
        if os.path.exists(dst):
            continue
        try:
            os.rename(path, dst)  # atomic: exactly one mover wins
        except OSError:
            return None
        from repro_torch.obs import metrics as metrics_lib
        metrics_lib.get_registry().counter("wisdom_corrupt_files").inc()
        return dst
    return None


class Wisdom:
    """In-memory wisdom table with JSON import/export."""

    def __init__(self, entries: Optional[dict] = None,
                 path: Optional[str] = None):
        self.entries: dict[str, WisdomEntry] = dict(entries or {})
        self.path = path

    # -- persistence --------------------------------------------------------
    @classmethod
    def load(cls, path: Optional[str] = None) -> "Wisdom":
        """Load from ``path`` (or $CROFT_WISDOM); missing file -> empty.

        A file that fails to parse, or whose stored ``checksum`` does
        not match its entries, is *quarantined*: moved aside to
        ``<path>.corrupt-<n>`` (see :func:`quarantine_corrupt`) so the
        next planner run rebuilds clean wisdom from model mode instead
        of tripping over the same corruption forever.  Files written
        before the checksum existed load normally (no checksum field =
        nothing to verify)."""
        path = path or os.environ.get(DEFAULT_PATH_ENV)
        w = cls(path=path)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    blob = json.load(f)
                if not isinstance(blob, dict):
                    raise ValueError("wisdom store is not a JSON object")
            except (OSError, ValueError):
                quarantine_corrupt(path)
                return w  # unreadable/corrupt file -> empty wisdom
            if blob.get("version", 0) > WISDOM_VERSION:
                # from a newer version: valid, just unknown — treat as
                # empty and re-tune, but do NOT quarantine it
                return w
            entries_json = blob.get("entries", {})
            want = blob.get("checksum")
            if want is not None and want != _entries_checksum(entries_json):
                quarantine_corrupt(path)
                return w
            for key, d in entries_json.items():
                try:
                    w.entries[key] = WisdomEntry.from_json(d)
                except (TypeError, ValueError):
                    continue  # malformed entry -> miss, not a crash
        return w

    def save(self, path: Optional[str] = None) -> Optional[str]:
        path = path or self.path
        if not path:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        entries_json = {k: e.to_json() for k, e in self.entries.items()}
        blob = {"version": WISDOM_VERSION, "entries": entries_json,
                "checksum": _entries_checksum(entries_json)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        # chaos site: a writer killed here leaves the store intact plus a
        # stale .tmp that the next locked merge cleans up
        inject_lib.fire("wisdom.write.crash", path)
        os.replace(tmp, path)
        return path

    # -- access -------------------------------------------------------------
    def lookup(self, key: str) -> Optional[WisdomEntry]:
        return self.entries.get(key)

    def record(self, key: str, entry: WisdomEntry) -> None:
        prev = self.entries.get(key)
        self.entries[key] = entry if prev is None else prev.better_of(entry)

    def merge(self, other: "Wisdom") -> None:
        for key, entry in other.entries.items():
            self.record(key, entry)

    def __len__(self) -> int:
        return len(self.entries)


class _FileLock:
    """Tiny advisory lock: ``path.lock`` created O_EXCL, retried with
    backoff.  Stale locks (a writer that died mid-merge) are broken after
    ``stale_s`` so a crashed upgrade thread cannot wedge the service."""

    def __init__(self, path: str, timeout: float = 10.0,
                 stale_s: float = 30.0):
        self.path, self.timeout, self.stale_s = path, timeout, stale_s

    def __enter__(self):
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return self
            except FileExistsError:
                try:
                    age = time.time() - os.path.getmtime(self.path)
                    if age > self.stale_s:
                        self._break_stale()
                        continue
                except OSError:
                    continue  # holder released between stat and unlink
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not acquire wisdom lock {self.path}")
                time.sleep(0.02)

    def _break_stale(self) -> None:
        """Break a dead writer's lock without unlinking a live one.

        A bare unlink races: two waiters can both observe staleness, the
        first breaks the lock and re-acquires, and the second then
        unlinks the first's *fresh* lock — two writers in the critical
        section.  Instead, rename the lock to a unique name: rename is
        atomic, so exactly one waiter wins (losers get ENOENT and
        re-loop), and the winner owns the renamed file exclusively.  It
        then re-checks staleness on the renamed file — if it actually
        stole a fresh lock (broken and re-acquired in the stat/rename
        window), it restores it via ``link``, which refuses to clobber
        any newer lock."""
        unique = f"{self.path}.stale.{os.getpid()}.{threading.get_ident()}"
        try:
            os.rename(self.path, unique)
        except OSError:
            return  # another waiter won the rename (or holder released)
        try:
            fresh = (time.time() - os.path.getmtime(unique)) <= self.stale_s
        except OSError:
            fresh = False
        if fresh:
            try:
                os.link(unique, self.path)  # EEXIST if relocked meanwhile
            except OSError:
                pass
        try:
            os.unlink(unique)
        except OSError:
            pass

    def __exit__(self, *exc):
        try:
            os.unlink(self.path)
        except OSError:
            pass


def merge_entries(path: str, entries: Mapping[str, WisdomEntry]) -> int:
    """Merge ``entries`` into the wisdom file at ``path`` atomically.

    Safe under concurrent writers: reload the latest file contents under
    a lock file, fold the new entries in (``better_of`` per key), write
    to a temp file and rename.  Returns the merged store's size.  This
    is the single write path for production wisdom — the planner's
    ``save=True`` and the serving plan cache's background measurement
    thread both land here.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _FileLock(path + ".lock"):
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            # stale temp from a writer killed between temp-write and
            # rename; we hold the lock, so no live writer owns it
            try:
                os.unlink(tmp)
            except OSError:
                pass
        w = Wisdom.load(path)
        w.path = path
        for key, entry in entries.items():
            w.record(key, entry)
        w.save(path)
        return len(w)


def merge_files(out: str, inputs: Sequence[str],
                include_seed: bool = False) -> int:
    """CLI ``merge``: fold wisdom files into ``out`` under the same lock
    discipline as :func:`merge_entries`."""
    folded = Wisdom()
    if include_seed:
        folded.merge(load_seed())
    for p in inputs:
        folded.merge(Wisdom.load(p))
    return merge_entries(out, folded.entries)


def load_seed() -> "Wisdom":
    """The shipped seed wisdom (model-mode plans for common problems).

    Opt-in by design: ``Wisdom.load`` never folds it in automatically, so
    planner behavior stays a pure function of the caller's wisdom file —
    use ``python -m repro_torch.tuning.wisdom merge OUT --seed`` (or
    merge it yourself) to start a cluster's wisdom from the seed.
    """
    return Wisdom.load(SEED_PATH) if os.path.exists(SEED_PATH) else Wisdom()


# ---------------------------------------------------------------------------
# command line (the fftw-wisdom analogue)
# ---------------------------------------------------------------------------

def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.wisdom",
        description="Inspect and merge CROFT wisdom files.",
        epilog="The shipped seed (--seed) is the port's own: the key set "
               "of the reference's seed_wisdom.json, each entry the plan "
               "that repro_torch.tuning.tune(shape, axis_sizes=..., "
               "mode='model', dtype=..., problem=..., batch=...) picks "
               "for that key under the H100 priors of "
               "repro_torch.tuning.cost_model.  The loop that makes it is "
               "_regenerate_seed in tests/test_torch_tuning.py, which "
               "checks the shipped file against it.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge wisdom files (better entry "
                                      "wins per key) into OUT")
    mp.add_argument("out", help="output wisdom file (merged in place if "
                                "it already exists)")
    mp.add_argument("inputs", nargs="*", help="wisdom files to fold in")
    mp.add_argument("--seed", action="store_true",
                    help="also fold in the shipped seed wisdom")
    sp = sub.add_parser("show", help="print a wisdom file's entries")
    sp.add_argument("path")
    tp = sub.add_parser("stats", help="summarize a wisdom file: keys, "
                                      "modes, staleness")
    tp.add_argument("path")
    args = ap.parse_args(argv)

    if args.cmd == "merge":
        n = merge_files(args.out, args.inputs, include_seed=args.seed)
        print(f"wrote {n} entries -> {args.out}")
        return 0
    if args.cmd == "stats":
        return _stats(args.path)
    w = Wisdom.load(args.path)
    for key in sorted(w.entries):
        e = w.entries[key]
        t = (f"{e.measured_s * 1e6:.0f}us measured" if e.measured_s is not None
             else f"{e.model_s * 1e6:.0f}us modeled" if e.model_s is not None
             else "?")
        stages = None
        try:
            cand = e.candidate()
            label = cand.label
            if getattr(cand, "is_schedule", False):
                stages = cand.stage_summary()
        except (TypeError, ValueError):
            label = "<unreadable entry>"
        print(f"{key}\n    [{e.source}] {label} ({t})")
        if stages is not None:
            print(f"    stages: {stages}")
    print(f"{len(w)} entries")
    return 0


def _age_s(entry: WisdomEntry, now: float) -> Optional[float]:
    return None if entry.created is None else max(0.0, now - entry.created)


def _fmt_age(age: Optional[float]) -> str:
    if age is None:
        return "age unknown"
    for unit, span in (("d", 86400.0), ("h", 3600.0), ("m", 60.0)):
        if age >= span:
            return f"{age / span:.1f}{unit} old"
    return f"{age:.0f}s old"


def _stats(path: str) -> int:
    """CLI ``stats``: per-key mode/problem/staleness, aggregate counts.

    Staleness matters in production: "model" entries are cold estimates
    awaiting a background measurement upgrade, and very old "measure"
    entries predate current code/hardware — both are re-tune candidates.
    """
    w = Wisdom.load(path)
    now = time.time()
    by_source: dict[str, int] = {}
    by_problem: dict[str, int] = {}
    ages = []
    n_sched = 0
    for key in sorted(w.entries):
        e = w.entries[key]
        by_source[e.source] = by_source.get(e.source, 0) + 1
        by_problem[e.problem] = by_problem.get(e.problem, 0) + 1
        age = _age_s(e, now)
        if age is not None:
            ages.append(age)
        t = (f"{e.measured_s * 1e6:.0f}us measured"
             if e.measured_s is not None else
             f"{e.model_s * 1e6:.0f}us modeled"
             if e.model_s is not None else "unscored")
        tag = f"{e.source}/{e.problem}"
        if e.schedule is not None:
            n_sched += 1
            tag += "/sched"
        print(f"{key}\n    [{tag}] {t}, {_fmt_age(age)}")
    print(f"{len(w)} entries"
          + (f" in {path}" if os.path.exists(path) else " (file missing)"))
    print("  by mode:    " + (", ".join(
        f"{k}={v}" for k, v in sorted(by_source.items())) or "-"))
    print("  by problem: " + (", ".join(
        f"{k}={v}" for k, v in sorted(by_problem.items())) or "-"))
    print(f"  searched:   {n_sched} schedule-keyed "
          f"entr{'y' if n_sched == 1 else 'ies'}")
    if ages:
        ages.sort()
        print(f"  staleness:  newest {_fmt_age(ages[0])}, median "
              f"{_fmt_age(ages[len(ages) // 2])}, oldest {_fmt_age(ages[-1])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
