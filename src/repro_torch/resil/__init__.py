"""repro_torch.resil — seeded fault injection (port of ``repro.resil``).

:mod:`repro_torch.resil.inject` is a copy of the reference's scripted,
seeded fault-injection plane: named sites fire exactly at the scripted
invocations, and do nothing when no plan is armed.  The tuner fires
``tune.measure`` and ``wisdom.write.crash``.
"""

from repro_torch.resil import inject  # noqa: F401
from repro_torch.resil.inject import (CrashMidWrite, FaultPlan,  # noqa: F401
                                      FaultSpec, InjectedFault,
                                      TransientFault, injection,
                                      seeded_times)

__all__ = [
    "CrashMidWrite", "FaultPlan", "FaultSpec", "InjectedFault",
    "TransientFault", "inject", "injection", "seeded_times",
]
