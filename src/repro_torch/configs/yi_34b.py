"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-architecture GQA.  [arXiv:2403.04652; hf]

A copy of ``repro/configs/yi_34b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec, ModelConfig,
                                       simple_stack)


def full() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=56, n_kv_heads=8,
                           head_dim=128, rope_theta=5_000_000.0),
        ffn="swiglu",
    )
    return ModelConfig(
        name="yi-34b", family="dense",
        d_model=7168, d_ff=20480, vocab=64000,
        stages=simple_stack(60, spec),
        supports_long=False,  # pure full attention: long_500k skipped
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16),
        ffn="swiglu",
    )
    return ModelConfig(
        name="yi-34b-smoke", family="dense",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, spec),
        supports_long=False,
    )
