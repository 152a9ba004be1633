"""Public CROFT API: plan-style handle over the distributed 3-D FFT.

Port of ``repro/core/api.py`` (the complex transform).  ``Croft3D`` is the
analogue of ``croft_parallel3d`` plus FFTW's plan object: it binds (grid
shape, mesh, decomposition, options) once, validates, and exposes the
forward/inverse transforms.  With a mesh, every rank holds a ``Croft3D``
and calls it with its own local block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import distributed
from repro_torch.core.decomposition import Decomposition
from repro_torch.core.distributed import FFTOptions
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Croft3D:
    """A planned distributed 3-D FFT.

    >>> plan = Croft3D((1024, 1024, 1024), mesh,
    ...                Decomposition("pencil", ("data", "model")))
    >>> y = plan.forward(x)        # x: this rank's block, plan.input_sharding
    >>> x2 = plan.inverse(y)       # == x up to dtype tolerance

    Meshless plans run on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``); with a mesh, on the mesh's device.
    """

    shape: tuple[int, int, int]
    mesh: Optional[object] = None
    decomp: Optional[Decomposition] = None
    opts: FFTOptions = dataclasses.field(default_factory=FFTOptions)
    dtype: torch.dtype = torch.complex64
    #: problem class; only "c2c" is ported so far
    problem: str = "c2c"
    device: Optional[object] = None

    def __post_init__(self):
        if self.problem != "c2c":
            if self.problem == "r2c":
                raise NotImplementedError("problem='r2c' is not ported yet")
            raise ValueError(f"problem must be 'c2c' or 'r2c', got "
                             f"{self.problem!r}")
        self.shape = tuple(self.shape)
        if self.mesh is not None:
            if self.decomp is None:
                raise ValueError("a mesh requires a Decomposition")
            self.decomp.validate(self.shape, self.mesh,
                                 self.opts.overlap_k,
                                 self.opts.transpose_impl)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(self.device)

    @classmethod
    def from_tokens(cls, shape: Sequence[int], decomp_token: str,
                    opts_token: str, mesh, **kw) -> "Croft3D":
        """The plan named by the reference's ``Decomposition.to_token()``
        and ``FFTOptions.to_token()`` strings (the wisdom store's and the
        plan cache's plan identity)."""
        return cls(tuple(shape), mesh, Decomposition.from_token(decomp_token),
                   FFTOptions.from_token(opts_token), **kw)

    # -- layouts -------------------------------------------------------------
    def _slices(self, layout: str, coords=None) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return self.decomp.slices(self.shape, self.mesh,
                                  self.mesh.coords if coords is None
                                  else coords, layout)

    @property
    def input_sharding(self) -> Optional[tuple]:
        """The global index ranges of this rank's input block (None when
        meshless)."""
        return self._slices("natural")

    @property
    def output_sharding(self) -> Optional[tuple]:
        """The global index ranges of this rank's output block."""
        return self._slices(self.opts.output_layout)

    def local_shape(self) -> tuple[int, ...]:
        if self.mesh is None:
            return self.shape
        return self.decomp.local_shape(self.shape, self.mesh)

    def _check(self, x: torch.Tensor, layout: str) -> None:
        if self.mesh is None:
            want = self.shape
        else:
            want = tuple(s.stop - s.start for s in self._slices(layout))
        if tuple(x.shape[-3:]) != want:
            raise ValueError(f"expected a block of shape {want} (leading "
                             f"batch dims allowed), got {tuple(x.shape)}")

    # -- transforms ----------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, "natural")
        return distributed.fft3d(x, self.mesh, self.decomp, self.opts,
                                 device=self.device)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        self._check(y, self.opts.output_layout)
        return distributed.ifft3d(y, self.mesh, self.decomp, self.opts,
                                  device=self.device)

    def forward_batched(self, x: torch.Tensor) -> torch.Tensor:
        """``forward`` over a (B, Nx, Ny, Nz) stack: the executor carries
        the batch axis through every stage, so the collective count is
        B=1's and each field's result equals its own ``forward``."""
        return self.forward(x)

    def inverse_batched(self, y: torch.Tensor) -> torch.Tensor:
        """``inverse`` over a (B, ...) spectrum stack."""
        return self.inverse(y)

    def release(self) -> None:
        """The reference drops its compiled executables here; the port runs
        eagerly and holds none, so there is nothing to drop."""

    # -- models --------------------------------------------------------------
    def flops_model(self) -> float:
        """Analytic 5 N log2 N FLOP count for the full 3-D transform,
        summed over the schedule's local-FFT events."""
        if self.mesh is None or self.decomp is None:
            n_total = math.prod(self.shape)
            return 5.0 * n_total * sum(math.log2(s) for s in self.shape)
        sched = distributed.build_schedule(self.decomp, self.opts, -1)
        sizes = dict(self.mesh.shape)
        per_device = sum(5.0 * elems * math.log2(n) for _, elems, n
                         in sched.fft_events(self.shape, sizes))
        return per_device * self.decomp.n_procs(sizes)


def auto_pencil(shape: Sequence[int], mesh,
                axes: Sequence[str] = ("data", "model")) -> Decomposition:
    """Pencil decomposition over the given mesh axes (fig. 5 virtual grid)."""
    return Decomposition("pencil", tuple(axes))
