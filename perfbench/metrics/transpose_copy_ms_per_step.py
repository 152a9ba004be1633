"""transpose_copy_ms_per_step: device milliseconds per step of the
copies around the transposes, from the timing events of the port's
spans ``transpose:pack`` (the send buffer: ``Mesh.all_to_all``'s
reorder and ``contiguous()``, the ring's rotated pack),
``transpose:unpack`` (the received chunks laid out, after the wait) and
``stage:cat`` (``run_stage``'s ``cat`` of the K chunks).  NCCL's own
kernels run on their stream and are not in these spans; stream idle
inside them counts (``harness/spans.py``).  The largest rank's.  Layer: Transpose / reshard (``core/mesh.py``,
``core/schedule.py``).  Moves ``step_ms``.  Nothing to read where the
program records no such span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "max"

SPANS = ("transpose:pack", "transpose:unpack", "stage:cat")


def read(ctx):
    return device_ms_per_step(ctx, SPANS)
