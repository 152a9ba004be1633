"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — Griffin: RG-LRU + local attention, 2 recurrent : 1 attention.
[arXiv:2402.19427; unverified]

A copy of ``repro/configs/recurrentgemma_9b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec, ModelConfig,
                                       RecurrentSpec, pattern_stack)

LOCAL_WINDOW = 2048


def full() -> ModelConfig:
    rec = LayerSpec(
        mixer="rglru",
        recurrent=RecurrentSpec(kind="rglru", d_state=4096, conv_width=4),
        ffn="geglu",
    )
    att = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=16, n_kv_heads=1,
                           head_dim=256, window=LOCAL_WINDOW),
        ffn="geglu",
    )
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        d_model=4096, d_ff=12288, vocab=256000,
        stages=pattern_stack(38, [rec, rec, att]),
        tie_embeddings=True, emb_scale_by_dim=True,
        supports_long=True,
    )


def smoke() -> ModelConfig:
    rec = LayerSpec(
        mixer="rglru",
        recurrent=RecurrentSpec(kind="rglru", d_state=64, conv_width=4,
                                chunk=16),
        ffn="geglu",
    )
    att = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=1, head_dim=16,
                           window=16),
        ffn="geglu",
    )
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        d_model=64, d_ff=128, vocab=256,
        stages=pattern_stack(4, [rec, rec, att]),
        tie_embeddings=True, emb_scale_by_dim=True,
        supports_long=True,
    )
