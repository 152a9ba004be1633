"""LM substrate: configs, layers, and the staged model (port of
``repro/models``: dense GQA, MLA, MoE, FNet and the recurrent mixers)."""

from repro_torch.models.config import (AttentionSpec, EncoderConfig,
                                       LayerSpec, ModelConfig, MoESpec,
                                       RecurrentSpec, Stage, pattern_stack,
                                       simple_stack)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model, forward, init_caches, init_params

__all__ = [
    "AttentionSpec", "EncoderConfig", "LayerSpec", "Model", "ModelConfig",
    "MoESpec", "RecurrentSpec", "Stage", "forward", "init_caches",
    "init_params", "params_from_numpy", "pattern_stack", "simple_stack",
]
