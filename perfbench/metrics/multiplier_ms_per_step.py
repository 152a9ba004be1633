"""multiplier_ms_per_step: device milliseconds per step of the port's
``poisson:multiplier`` span (``core/api.py:poisson_solve``: the
wavenumbers, k^2, the two ``where``s, the reciprocal and the cast to
the plan's complex dtype, built on every call), from its timing events.
The span opens each step right after the harness's synchronize, so the
reading also holds the stream's idle while the host launches the
multiplier's first ops (``harness/spans.py``).  The largest rank's.
Layer: Executor.  Moves ``step_ms``.  Nothing to read where the program
records no such span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "max"


def read(ctx):
    return device_ms_per_step(ctx, ["poisson:multiplier"])
