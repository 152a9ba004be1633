"""Config registry: ``get_config("<arch>")`` / ``--arch`` lookup.

Port of ``repro/configs/__init__.py``: the ten assigned architectures
and the bonus spectral LM, each module a copy of the reference's with
``full()`` and ``smoke()``; the paper's FFT workloads live in
``croft_fft.py`` and ``shapes.py``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (FFT_SHAPES, SHAPES, FFTShape,
                                        ShapeSpec, shape_supported)

ARCHS = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    # bonus (beyond the assigned pool)
    "fnet-350m": "repro_torch.configs.fnet_350m",
}

ASSIGNED = [a for a in ARCHS if a != "fnet-350m"]


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke() if smoke else mod.full()


__all__ = ["ARCHS", "ASSIGNED", "FFT_SHAPES", "SHAPES", "FFTShape",
           "ShapeSpec", "get_config", "shape_supported"]
