"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

A copy of ``repro/configs/h2o_danube3_4b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec,
                                       ModelConfig, simple_stack)


def full() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=32, n_kv_heads=8,
                           head_dim=120, window=4096),
        ffn="swiglu",
    )
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        d_model=3840, d_ff=10240, vocab=32000,
        stages=simple_stack(24, spec),
        supports_long=True,  # SWA
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
                           window=32),
        ffn="swiglu",
    )
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, spec),
        supports_long=True,
    )
