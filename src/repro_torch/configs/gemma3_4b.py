"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5 local (window 1024) : 1 global pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

A copy of ``repro/configs/gemma3_4b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec, ModelConfig,
                                       pattern_stack)

LOCAL_WINDOW = 1024


def full() -> ModelConfig:
    local = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=4, head_dim=256,
                           window=LOCAL_WINDOW, rope_theta=10_000.0),
        ffn="geglu",
    )
    glob = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=4, head_dim=256,
                           window=None, rope_theta=1_000_000.0),
        ffn="geglu",
    )
    return ModelConfig(
        name="gemma3-4b", family="dense",
        d_model=2560, d_ff=10240, vocab=262144,
        stages=pattern_stack(34, [local] * 5 + [glob]),
        tie_embeddings=True, emb_scale_by_dim=True,
        supports_long=True,  # dominated by local layers; global layers are
                             # O(S) per decoded token with a seq-sharded cache
    )


def smoke() -> ModelConfig:
    local = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
                           window=16),
        ffn="geglu",
    )
    glob = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16),
        ffn="geglu",
    )
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        d_model=64, d_ff=128, vocab=256,
        stages=pattern_stack(4, [local, local, glob]),
        tie_embeddings=True, emb_scale_by_dim=True,
        supports_long=True,
    )
