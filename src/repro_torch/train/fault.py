"""Fault tolerance: preemption handling, straggler detection, elastic
re-meshing.

Port of ``repro/train/fault.py``.  Three failure classes:
  * planned preemption  -> SIGTERM handler flips a flag; the train loop
    (``launch/train.py``) checkpoints and exits at the next step
    boundary, and the transform service (``serve.TransformService``'s
    ``preemption=``) drains what is pending and stops;
  * node loss           -> restart picks up the latest checkpoint, onto
    the mesh :func:`elastic_mesh` builds from the ranks that are alive
    (checkpoints store logical shapes only);
  * stragglers          -> per-step wall times feed an EMA z-score monitor
    (:class:`StragglerMonitor`); flagged steps are logged through a
    policy hook.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful drain-and-exit flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._installed = False
        self._signals = signals
        self._group = None

    def install(self):
        if self._installed:
            return
        for sig in self._signals:
            try:
                signal.signal(sig, self._handle)
            except ValueError:
                pass  # non-main thread (tests)
        self._installed = True

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preemption_requested(self) -> bool:
        return self._requested

    def agreed(self) -> bool:
        """Whether any rank of the ``torch.distributed`` world has been
        asked to stop, as every rank sees it: a MAX all-reduce of one int,
        so every rank must call this at the same point, and all of them
        act on a signal at the same step (saving a sharded state is a
        collective; ranks that disagreed would pair its gathers with the
        next step's collectives).  The int lives in host memory on a gloo
        group (the world's, or one made on the first call when the world
        is NCCL), so the host never waits on the card.  Without a world,
        :attr:`preemption_requested`."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self._requested
        if self._group is None:
            self._group = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
        flag = torch.tensor([int(self._requested)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
        return bool(flag.item())


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    z_score: float
    is_straggler: bool


class StragglerMonitor:
    """EMA mean/variance of step wall time; flags outliers.

    The single-process monitor of the global step, with the reference's
    policy hook (``on_straggler``); a multi-host deployment would gather
    every host's step time first (one float each).
    """

    def __init__(self, z_threshold: float = 4.0, ema: float = 0.95,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[StepStats], None]] = None):
        self.z = z_threshold
        self.ema = ema
        self.warmup = warmup_steps
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged: list[StepStats] = []
        self.on_straggler = on_straggler
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> StepStats:
        dt = time.monotonic() - (self._t0 or time.monotonic())
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else \
                (self.mean * (self.n - 1) + dt) / self.n
            self.var = max(self.var, (dt - self.mean) ** 2)
            return StepStats(step, dt, 0.0, False)
        sd = math.sqrt(self.var) if self.var > 0 else max(self.mean * 0.05, 1e-9)
        z = (dt - self.mean) / sd
        is_straggler = z > self.z
        self.mean = self.ema * self.mean + (1 - self.ema) * dt
        self.var = self.ema * self.var + (1 - self.ema) * (dt - self.mean) ** 2
        stats = StepStats(step, dt, z, is_straggler)
        if is_straggler:
            self.flagged.append(stats)
            if self.on_straggler:
                self.on_straggler(stats)
        return stats


def elastic_mesh(axis_names=("data", "model"), prefer_model: int = 16,
                 device=None):
    """The largest valid (data, model) mesh over the ranks that are
    alive: the process group's world size, or meshless the CUDA device
    count.  Keeps the model axis at ``prefer_model`` when divisible,
    shrinking the data axis (the reference's gcd rule).  Returns
    ``((data, model), mesh)``: the port's ``Mesh`` (blocks on ``device``)
    over the process group when one exists, else None."""
    if dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = max(1, torch.cuda.device_count())
    model = math.gcd(n, prefer_model)
    shape = (n // model, model)
    mesh = None
    if dist.is_initialized():
        from repro_torch.core.mesh import make_mesh
        mesh = make_mesh(shape, axis_names, device=device)
    return shape, mesh
