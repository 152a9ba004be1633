"""The least work a step needs, counted from the problem's shapes.

The peaks are a frozen copy of ``repro_torch/launch/roofline.py``'s: one
NVIDIA H100 SXM from NVIDIA's data sheet, dense rates, at its 700 W power
limit.  ``bound_s`` is the bound arithmetic of ``chip_smoke.py``'s
``bound_ms``.  The counts depend only on the grid, the problem and the
number of ranks that share it, never on what the program launches, so a
later change to the program cannot move them.

- A 1-D FFT pass over an array of E complex elements along an axis of
  length n reads and writes the array once (2 * E * 8 bytes) and does
  5 * E * log2(n) operations.  A 3-D transform is 3 such passes, over the
  field (c2c) or over the half-size complex array of the packed real
  transform (E = N/2).
- A whole transform reads its input once and writes its output once;
  its operations are 5 * N * log2(N) (c2c) or 2.5 * N * log2(N)
  (r2c and c2r), N the grid's points.
- The real pipeline's streaming steps: the split of the packed spectrum
  and the Hermitian extension each read and write N/2 complex elements;
  the k-space multiply reads and writes the half spectrum (Nx * Ny *
  (Nz/2 + 1) complex) and reads a float32 multiplier.
- On several ranks, each count is a rank's share: divided by the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

HBM_BYTES_S = 3.35e12      # HBM3
FP32_FLOP_S = 67e12        # float32 outside the tensor cores
BF16_FLOP_S = 989e12       # bf16 dense, tensor cores
C64 = 8                    # bytes of a complex64 element
F32 = 4


def bound_s(nbytes: float, flops: float,
            flop_s: float = FP32_FLOP_S) -> tuple[float, str]:
    """The least time of ``nbytes`` and ``flops``, and which bounds it."""
    tb, tf = nbytes / HBM_BYTES_S, flops / flop_s
    return (tb, "bytes") if tb >= tf else (tf, "operations")


@dataclasses.dataclass(frozen=True)
class Transform:
    """One 3-D transform of the step: ``kind`` "c2c", "r2c" or "c2r"."""
    kind: str
    grid: tuple
    ranks: int = 1

    @property
    def points(self) -> int:
        return math.prod(self.grid)

    def half_points(self) -> int:
        nx, ny, nz = self.grid
        return nx * ny * (nz // 2 + 1)

    def fft_passes_s(self) -> float:
        """Least time of its three 1-D FFT passes on one rank."""
        e = self.points / self.ranks
        if self.kind != "c2c":
            e /= 2
        return sum(bound_s(2 * e * C64, 5 * e * math.log2(n))[0]
                   for n in self.grid)

    def flops(self) -> float:
        per = 5.0 if self.kind == "c2c" else 2.5
        return per * self.points * math.log2(self.points) / self.ranks

    def io_bytes(self) -> float:
        real, half = self.points * F32, self.half_points() * C64
        total = {"c2c": 2 * self.points * C64, "r2c": real + half,
                 "c2r": half + real}[self.kind]
        return total / self.ranks


def realpipe_bytes(grid: Sequence[int], ranks: int = 1) -> float:
    """Least bytes of one packed split, one Hermitian extension and one
    k-space multiply (a real-field solve's share of the real pipeline)."""
    nx, ny, nz = grid
    packed = nx * ny * nz // 2 * C64
    split = extend = 2 * packed
    multiply = nx * ny * (nz // 2 + 1) * (2 * C64 + F32)
    return (split + extend + multiply) / ranks


@dataclasses.dataclass
class StepWork:
    """What one step of a cell needs on one rank."""
    transforms: list
    realpipe_bytes: float = 0.0

    def fft_least_s(self) -> float:
        return sum(t.fft_passes_s() for t in self.transforms)

    def realpipe_least_s(self) -> float:
        return bound_s(self.realpipe_bytes, 0.0)[0]

    def step_least_s(self) -> float:
        flops = sum(t.flops() for t in self.transforms)
        nbytes = sum(t.io_bytes() for t in self.transforms)
        return bound_s(nbytes, flops)[0]
