"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP patch embeddings (STUB) + gemma decoder, prefix-LM
attention over the image tokens.  [arXiv:2407.07726; hf]

A copy of ``repro/configs/paligemma_3b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec, ModelConfig,
                                       simple_stack)

N_PATCHES = 256  # 224px / 14 squared — SigLIP-So400m stub token count


def full() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=1,
                           head_dim=256),
        ffn="geglu",
    )
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        d_model=2048, d_ff=16384, vocab=257216,
        stages=simple_stack(18, spec),
        tie_embeddings=True, emb_scale_by_dim=True,
        frontend="vision", n_frontend_tokens=N_PATCHES, prefix_lm=True,
        supports_long=False,
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=1, head_dim=16),
        ffn="geglu",
    )
    return ModelConfig(
        name="paligemma-3b-smoke", family="vlm",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, spec),
        tie_embeddings=True, emb_scale_by_dim=True,
        frontend="vision", n_frontend_tokens=8, prefix_lm=True,
        supports_long=False,
    )
