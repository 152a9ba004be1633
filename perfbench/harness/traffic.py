"""The one general generator: a traffic file says what a step does, and
this module turns it into calls into the port.

A traffic file (``perfbench/traffic/<name>.json``) holds ``step``: the
calls a step makes, in order, each on the result of the one before:
``["forward", "inverse"]``, a c2c round trip, or ``["poisson_solve"]``,
a real-field solve (``box``: the periodic box's side; ``strategy``: the
r2c plan's).  The step sets the problem it runs.  Every mix is a closed
loop with one caller: the next step starts when the last one's result
is on the host.

Every step of a run reuses the seeded input, as a solver's time loop
calls the same transform on fields of the same size.  Each call runs
inside a ``perfbench.<call>`` range, which the trace reading uses.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import record_function

STEPS = {
    # step: the problem it runs, and the answers it hands back, each
    # (name, layout it lies in)
    ("forward", "inverse"): ("c2c", (("spectrum", "output"),
                                     ("field", "input"))),
    ("poisson_solve",): ("r2c", (("solution", "input"),)),
}


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    step: tuple
    strategy: str = None
    box: float = None
    # the harness's, not a file's: the steps run in set-up, the fewest
    # steps a window holds, and the points of every step's answers kept
    # for the check
    warmup_steps: int = 3
    min_steps: int = 20
    sample_points: int = 256

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        doc = json.loads(Path(path).read_text())
        doc["step"] = tuple(doc["step"])
        t = cls(name=Path(path).stem, **doc)
        if t.step not in STEPS:
            raise ValueError(f"traffic {t.name}: no step {t.step}; one of "
                             f"{sorted(STEPS)}")
        return t

    @property
    def problem(self) -> str:
        return STEPS[self.step][0]

    def answers(self) -> tuple:
        return STEPS[self.step][1]

    def input_dtype(self, spectrum_dtype: torch.dtype) -> torch.dtype:
        if self.problem == "r2c":
            return torch.float64 if spectrum_dtype == torch.complex128 \
                else torch.float32
        return spectrum_dtype

    def transforms(self) -> list:
        """The kinds of the two 3-D transforms a step runs."""
        return ["c2c", "c2c"] if self.problem == "c2c" else ["r2c", "c2r"]

    def uses_real_pipeline(self) -> bool:
        return self.problem == "r2c" and self.strategy == "packed"

    def plan_kwargs(self) -> dict:
        kw = {"problem": self.problem}
        if self.strategy is not None:
            kw["strategy"] = self.strategy
        return kw

    def step_fn(self, plan, poisson_solve: Callable) -> Callable:
        """``step(x)`` -> {answer name: tensor}: one step of this traffic
        through ``plan``."""
        if self.step == ("poisson_solve",):
            box = self.box

            def step(x):
                with record_function("perfbench.poisson_solve"):
                    u = poisson_solve(x, plan, box=box)
                return {"solution": u}
            return step

        def step(x):
            with record_function("perfbench.forward"):
                y = plan.forward(x)
            with record_function("perfbench.inverse"):
                x2 = plan.inverse(y)
            return {"spectrum": y, "field": x2}
        return step
