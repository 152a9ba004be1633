"""plan_s: host seconds of the plan's set-up, the slowest rank's: the
constructor ``Croft3D(...)`` on the harness's clock, plus the first
call's excess over a warm step (the first warm-up step less the median
of the others), where the plan makes its buffers and twiddles, its
kernels load and, on a mesh, NCCL makes its communicators.  Layer:
Plan / API (``core/api.py:Croft3D``).  Moves ``setup_s``."""

COMBINE = "max"


def read(ctx):
    return ctx.plan_s
