"""The paper's FFT grid shapes (port of the ``FFT_SHAPES`` part of
``repro/configs/shapes.py``; its LM input shapes come with the LM
substrate's training and long-context ports)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FFTShape:
    name: str
    grid: tuple[int, int, int]
    dtype: str = "complex64"


FFT_SHAPES = {
    # the paper's two benchmark grids (tables 1-3) + a scale-up cell
    "fft_128": FFTShape("fft_128", (128, 128, 128)),
    "fft_1024": FFTShape("fft_1024", (1024, 1024, 1024)),
    "fft_4096": FFTShape("fft_4096", (4096, 4096, 4096)),
}
