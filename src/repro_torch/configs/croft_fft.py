"""The paper's own workload configs: 3-D FFT grids and option matrix.

Port of ``repro/configs/croft_fft.py``.  ``croft-<N>`` names select a
grid; options mirror §5.1 of the paper.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.distributed import FFTOptions


@dataclasses.dataclass(frozen=True)
class CroftConfig:
    name: str
    grid: tuple[int, int, int]
    decomposition: str = "pencil"       # "pencil" | "slab" | "cell"
    opts: FFTOptions = dataclasses.field(default_factory=FFTOptions)
    dtype: str = "complex64"            # paper uses c128; c64 is the
                                        # default, c128 selectable


def croft_128(**kw) -> CroftConfig:
    return CroftConfig("croft-128", (128, 128, 128), **kw)


def croft_1024(**kw) -> CroftConfig:
    return CroftConfig("croft-1024", (1024, 1024, 1024), **kw)


def croft_4096(**kw) -> CroftConfig:
    return CroftConfig("croft-4096", (4096, 4096, 4096), **kw)


def paper_option(cfg: CroftConfig, opt: int) -> CroftConfig:
    return dataclasses.replace(cfg, opts=FFTOptions.paper_option(opt))
