"""repro_torch.resil — seeded fault injection and degradation ladders
(port of ``repro.resil``).

  * :mod:`repro_torch.resil.inject` is a copy of the reference's
    scripted, seeded fault-injection plane: named sites fire exactly at
    the scripted invocations, and do nothing when no plan is armed.  The
    tuner fires ``tune.measure`` and ``wisdom.write.crash``, the serving
    plan cache ``plan.build`` and ``plan.upgrade``, the transform service
    ``serve.dispatch``, and the executor poisons its output at
    ``exec.output``.
  * :mod:`repro_torch.resil.degrade` is the plan degradation ladder
    (searched schedule -> fixed tuned -> default/alltoall/K1; packed r2c
    -> embed) that ``serve.PlanCache`` walks when a plan's build fails
    or its dispatches keep failing (quarantine).
"""

from repro_torch.resil import degrade, inject  # noqa: F401
from repro_torch.resil.inject import (CrashMidWrite, FaultPlan,  # noqa: F401
                                      FaultSpec, InjectedFault,
                                      TransientFault, injection,
                                      seeded_times)

__all__ = [
    "CrashMidWrite", "FaultPlan", "FaultSpec", "InjectedFault",
    "TransientFault", "degrade", "inject", "injection", "seeded_times",
]
