"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

A copy of ``repro/configs/mixtral_8x22b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec,
                                       ModelConfig, MoESpec,
                                       simple_stack)

SWA_WINDOW = 4096  # Mixtral-family sliding window


def full() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=48, n_kv_heads=8,
                           head_dim=128, window=SWA_WINDOW,
                           rope_theta=1_000_000.0),
        ffn="moe",
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384),
    )
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        d_model=6144, d_ff=16384, vocab=32768,
        stages=simple_stack(56, spec),
        supports_long=True,   # SWA => sub-quadratic long decode
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
                           window=32),
        ffn="moe",
        moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=64,
                    capacity_factor=2.0),
    )
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        d_model=64, d_ff=64, vocab=256,
        stages=simple_stack(2, spec),
        supports_long=True,
    )
