"""device_idle_pct: the share of the traced window in which no device op
runs, from the union of every op's interval (not a sum of op times),
in %.  The largest rank's.  Layer: Device (one H100).  Moves
``step_ms``."""

COMBINE = "max"


def read(ctx):
    if not ctx.on_card():
        return None
    tl = ctx.timeline
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
