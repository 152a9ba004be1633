"""LM substrate: configs, layers, and the staged model (port of
``repro/models``: dense GQA, MLA, MoE, FNet, the recurrent mixers and
the encoder-decoder)."""

from repro_torch.models.config import (AttentionSpec, EncoderConfig,
                                       LayerSpec, ModelConfig, MoESpec,
                                       RecurrentSpec, Stage, pattern_stack,
                                       simple_stack)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import (Model, encode, forward, init_caches,
                                      init_params)

__all__ = [
    "AttentionSpec", "EncoderConfig", "LayerSpec", "Model", "ModelConfig",
    "MoESpec", "RecurrentSpec", "Stage", "encode", "forward", "init_caches",
    "init_params", "params_from_numpy", "pattern_stack", "simple_stack",
]
