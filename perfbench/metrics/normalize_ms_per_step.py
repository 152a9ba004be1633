"""normalize_ms_per_step: device milliseconds per step of the port's
``inverse:normalize`` spans, the inverse's 1/N pass
(``core/local_fft.py:apply_norm``, ``grad/vjp.py:_scaled``,
``real/__init__.py:_irfft_packed``: an elementwise PyTorch op, no
kernel of ``csrc/``), from their timing events.  Stream idle inside
the spans counts (``harness/spans.py``).  The largest rank's.  Layer:
Executor.  Moves ``step_ms``.  Nothing to read where the program
records no such span."""

from perfbench.harness.spans import device_ms_per_step

COMBINE = "max"


def read(ctx):
    return device_ms_per_step(ctx, ["inverse:normalize"])
