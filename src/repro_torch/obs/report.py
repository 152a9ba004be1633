"""Attribution report: join traced timings against the analytic model.

    python -m repro_torch.obs.report trace.json [--json]

Port of ``repro/obs/report.py``, a copy of that pure-Python module: a
trace reads the same in either report.  Reads a Chrome-trace JSON
produced by :mod:`repro_torch.obs.tracer` (the ``metadata.attribution``
entries that :func:`repro_torch.obs.instrument.trace_forward` attaches
carry the per-stage measured/model rows) and
prints, per plan, a model-vs-measured table:

  * measured wall / fft-leg / collective-leg seconds per stage,
  * the model's predicted compute/collective split for the same stage
    (``tuning.cost_model.per_stage_costs``),
  * the **overlap efficiency** — fraction of collective time hidden
    under compute — measured vs modeled, per stage and overall (the
    paper's 42-51% claim, per stage).

Traces without attribution metadata (e.g. a serve run) still get a
per-category wall-time rollup from the raw span stream.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    if v >= 0.1:
        return f"{v:8.3f}s"
    if v >= 1e-4:
        return f"{v * 1e3:7.3f}ms"
    return f"{v * 1e6:7.3f}us"


def _fmt_pct(v) -> str:
    return "-" if v is None else f"{100.0 * v:5.1f}%"


def category_rollup(events) -> dict:
    """Total wall microseconds per span category ("X" events only)."""
    out: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "?")
        out[cat] = out.get(cat, 0.0) + float(ev.get("dur", 0.0))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def render_plan(summary) -> str:
    shape = "x".join(str(n) for n in summary.get("shape", []))
    lines = [f"plan {summary['plan']}  shape {shape}  "
             f"transpose={summary.get('transpose_impl')} "
             f"K={summary.get('overlap_k')}  e2e {_fmt_s(summary['e2e_s'])}"]
    if summary.get("note"):
        lines.append(f"  note: {summary['note']}")
    stages = summary.get("stages") or []
    if stages:
        hdr = (f"  {'stage':<14} {'cat':<10} {'k':>2} {'wall':>10} "
               f"{'fft':>10} {'comm':>10} {'mdl comp':>10} {'mdl coll':>10} "
               f"{'eff meas':>8} {'eff mdl':>8}")
        lines.append(hdr)
        lines.append("  " + "-" * (len(hdr) - 2))
    for row in stages:
        model = row.get("model") or {}
        lines.append(
            f"  {row['name']:<14} {row['category']:<10} {row['k_eff']:>2} "
            f"{_fmt_s(row.get('wall_s')):>10} {_fmt_s(row.get('fft_s')):>10} "
            f"{_fmt_s(row.get('comm_s')):>10} "
            f"{_fmt_s(model.get('compute_s')):>10} "
            f"{_fmt_s(model.get('collective_s')):>10} "
            f"{_fmt_pct(row.get('measured_efficiency')):>8} "
            f"{_fmt_pct(model.get('predicted_efficiency')):>8}")
    overall = summary.get("overall")
    if overall:
        model_rows = [r.get("model") or {} for r in stages]
        mc = sum(m.get("collective_s") or 0.0 for m in model_rows)
        mh = sum(m.get("hidden_s") or 0.0 for m in model_rows)
        lines.append(
            f"  overall: collective {_fmt_s(overall['collective_s'])}, "
            f"hidden {_fmt_s(overall['hidden_s'])}, "
            f"overlap efficiency {_fmt_pct(overall['efficiency'])} measured"
            f" vs {_fmt_pct(mh / mc if mc else None)} modeled")
    return "\n".join(lines)


def build_report(doc: dict) -> dict:
    meta = doc.get("metadata") or {}
    events = doc.get("traceEvents") or []
    return {
        "plans": meta.get("attribution") or [],
        "categories_us": category_rollup(events),
        "n_events": len(events),
        "dropped_events": meta.get("dropped_events", 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="model-vs-measured attribution from a repro_torch trace")
    ap.add_argument("trace", help="Chrome-trace JSON written by repro_torch.obs")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of a table")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        doc = json.load(f)
    report = build_report(doc)

    if args.json:
        json.dump(report, sys.stdout, indent=2, default=str)
        print()
        return 0

    for summary in report["plans"]:
        print(render_plan(summary))
        print()
    if not report["plans"]:
        print("no attribution metadata in trace (raw span rollup only)")
    print(f"span categories ({report['n_events']} events, "
          f"{report['dropped_events']} dropped):")
    for cat, us in report["categories_us"].items():
        print(f"  {cat:<12} {_fmt_s(us / 1e6):>10}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
