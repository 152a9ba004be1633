"""glue_ms_per_step: device milliseconds per step of every op launched
inside a call into the port that is neither a hand-written kernel of
``kernels/csrc/`` nor an NCCL kernel: copies, ``cat``, elementwise
PyTorch ops (the inverse's 1/N scale, ``poisson_solve``'s multiplier
built on every call).  An op whose launch the trace does not tie to a
range counts too.  The largest rank's.  Layer: Executor
(``core/schedule.py``, ``core/distributed.py``, the glue of
``core/api.py``).  Moves ``step_ms``."""

from perfbench.harness.timeline import is_nccl

COMBINE = "max"


def read(ctx):
    if not ctx.on_card():
        return None
    ops = ctx.timeline.select(
        lambda op: (op[3] is None or op[3] in ctx.port_ranges)
        and not is_nccl(op[0]) and not ctx.is_handwritten(op[0]))
    return ctx.timeline.time_s(ops) / ctx.steps * 1e3
