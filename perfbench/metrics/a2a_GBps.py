"""a2a_GBps: the bytes a rank's collectives put on the wire per step, as
``core/mesh.py:Mesh.counting()`` counts them, over the device time per
step of the rank's NCCL kernels, in GB/s (1e9 B/s).  An NCCL kernel's
time includes its wait for the peer.  The slowest rank's.  Layer:
Transpose / reshard (``core/mesh.py`` all_to_all, the transpose stages
of ``core/distributed.py``).  Moves ``step_ms``."""

COMBINE = "min"


def read(ctx):
    if not ctx.on_card() or not ctx.comm_bytes_per_step:
        return None
    t = ctx.timeline.time_s(ctx.nccl_ops()) / ctx.steps
    if t <= 0:
        return None
    return ctx.comm_bytes_per_step / t / 1e9
