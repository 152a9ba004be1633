"""Cases shared by the sharded train and serve test workers (not a test
module): the smoke configs in float32, MoE at a capacity factor where no
(token, choice) pair drops (``moe_fwd_sharded`` sizes its capacity by
the rank's tokens, the meshless dispatch by all of them), and a seeded
batch with its stub frontend inputs."""

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs import get_config

NO_DROP = 16.0      # capacity factor: no pair drops at smoke size
GRAD_TOL = 1e-4     # x max|ref|, as tests/test_grad.py:110
# every arch but yi-9b (the reference's own case, on (2, 4)), and two
# variants: ":tp", mixtral with 3 experts (they do not divide the model
# axis: the "tp" dispatch over the gathered sequence), and ":odd", a
# sequence that does not divide the sequence axis (kept whole)
ARCHS_2x2 = ["deepseek-v2-236b", "fnet-350m", "gemma3-4b", "h2o-danube-3-4b",
             "mixtral-8x22b", "mixtral-8x22b:tp", "paligemma-3b",
             "recurrentgemma-9b", "rwkv6-3b", "whisper-base", "yi-34b",
             "yi-9b:odd"]


def config(case: str, dtype: str = "float32"):
    """A case's config: ``arch`` or ``arch:variant``."""
    arch, _, variant = case.partition(":")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    experts = {"n_experts": 3} if variant == "tp" else {}
    stages = tuple(dataclasses.replace(st, pattern=tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=NO_DROP, **experts)) if sp.moe else sp
        for sp in st.pattern)) for st in cfg.stages)
    return dataclasses.replace(cfg, stages=stages)


def stub_inputs(cfg, batch: int, seed: int = 0) -> dict:
    """Whisper's frames or paligemma's patch embeddings, (B, T, D)."""
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.n_frontend_tokens, cfg.d_model)
    if cfg.encoder is not None:
        return {"frames": rng.standard_normal(shape).astype(np.float32)}
    if cfg.frontend == "vision":
        return {"prefix_embeds": rng.standard_normal(shape).astype(
            np.float32)}
    return {}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    scale = float(want.abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                 1e-30)


def max_err(errs) -> float:
    return max([0.0] + [e for e in errs if not math.isnan(e)]
               + [math.inf for e in errs if math.isnan(e)])
