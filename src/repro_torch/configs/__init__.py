"""Config registry: ``get_config("<arch>")`` / ``--arch`` lookup.

Port of ``repro/configs/__init__.py``.  The registry knows every arch of
the reference; the port runs the dense GQA models, the MoE models (MLA
and GQA attention), the recurrent models (RG-LRU with local attention,
RWKV-6) and the FNet spectral encoder.  The encoder-decoder and the
vision-prefix models (whisper-base, paligemma-3b) raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
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
    "whisper-base": None,
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "paligemma-3b": None,
    # bonus (beyond the assigned pool)
    "fnet-350m": "repro_torch.configs.fnet_350m",
}

ASSIGNED = [a for a in ARCHS if a != "fnet-350m"]


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if ARCHS[arch] is None:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP.md queue 1 item 8c: the "
            "encoder and the modality frontends)")
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke() if smoke else mod.full()


__all__ = ["ARCHS", "ASSIGNED", "FFT_SHAPES", "SHAPES", "FFTShape",
           "ShapeSpec", "get_config", "shape_supported"]
