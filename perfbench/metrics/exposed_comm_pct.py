"""exposed_comm_pct: the share of the traced window during which an
NCCL kernel runs and no other device op does, from the union of the
timeline's intervals, in %: the transposes the K-chunk overlap did not
hide.  The largest rank's.  Layer: Transpose / reshard, the paper's
K-chunk overlap.  Moves ``step_ms``."""

COMBINE = "max"


def read(ctx):
    if not ctx.on_card():
        return None
    nccl = ctx.nccl_ops()
    if not nccl:
        return None
    return 100.0 * ctx.timeline.exposed_s(nccl) / ctx.timeline.window_s
