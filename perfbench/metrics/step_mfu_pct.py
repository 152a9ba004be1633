"""step_mfu_pct: the whole step's share of the card's roofline, in %:
the least time of a step (``harness/work.py``: the larger of its
transforms' operations, 5 N log2 N a c2c and 2.5 N log2 N an r2c or
c2r, over 67 TFLOP/s, and their bytes, each transform's input read once
and output written once, over 3.35 TB/s; a rank's share on several
ranks) over the traced window's time per step.  It still bounds a gain
once a kernel is taken off the path.  The lowest rank's.  Layer: the
whole step.  Moves ``step_ms``."""

COMBINE = "min"


def read(ctx):
    if not ctx.on_card():
        return None
    return 100.0 * ctx.work.step_least_s() / ctx.step_s
