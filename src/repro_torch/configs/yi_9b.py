"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-architecture GQA.  [arXiv:2403.04652; hf]

A copy of ``repro/configs/yi_9b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec, ModelConfig,
                                       simple_stack)


def full() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=32, n_kv_heads=4,
                           head_dim=128, rope_theta=10_000.0),
        ffn="swiglu",
    )
    return ModelConfig(
        name="yi-9b", family="dense",
        d_model=4096, d_ff=11008, vocab=64000,
        stages=simple_stack(48, spec),
        supports_long=False,
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=1, head_dim=16),
        ffn="swiglu",
    )
    return ModelConfig(
        name="yi-9b-smoke", family="dense",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, spec),
        supports_long=False,
    )
