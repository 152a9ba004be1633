"""The assigned LM input-shape set (the same four cells for every arch)
plus the paper's own FFT grid shapes.  Port of
``repro/configs/shapes.py`` (a copy)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def lowers_serve_step(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


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


def shape_supported(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Skip rules (long_500k needs sub-quadratic attention; decode needs a
    decoder)."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, ("pure full-attention arch: 500k dense decode "
                       "out of scope (DESIGN.md §5 skip list)")
    return True, ""
