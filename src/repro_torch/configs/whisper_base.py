"""whisper-base [audio] — 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865, encoder-decoder with conv frontend STUB (``input_specs``
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]

Backbone-only per the assignment: the mel-spectrogram conv stem is stubbed;
decoder self-attention uses RoPE in place of Whisper's learned positions
(documented hardware-era substitution — the assignment pins the transformer
backbone dims, not the positional scheme).

A copy of ``repro/configs/whisper_base.py``.
"""

from repro_torch.models.config import (AttentionSpec, EncoderConfig,
                                       LayerSpec, ModelConfig, simple_stack)

N_FRAMES = 1500  # whisper 30 s window after 2x conv downsampling


def full() -> ModelConfig:
    dec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=8, head_dim=64),
        ffn="gelu",
        cross_attn=True,
    )
    enc = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=8, head_dim=64,
                           causal=False, use_rope=False),
        ffn="gelu",
    )
    return ModelConfig(
        name="whisper-base", family="audio",
        d_model=512, d_ff=2048, vocab=51865,
        stages=simple_stack(6, dec),
        norm="layernorm",
        encoder=EncoderConfig(n_layers=6, layer=enc, max_positions=N_FRAMES),
        frontend="audio", n_frontend_tokens=N_FRAMES,
        supports_long=False,
    )


def smoke() -> ModelConfig:
    dec = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
        ffn="gelu",
        cross_attn=True,
    )
    enc = LayerSpec(
        mixer="attn",
        attn=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16,
                           causal=False, use_rope=False),
        ffn="gelu",
    )
    return ModelConfig(
        name="whisper-base-smoke", family="audio",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, dec),
        norm="layernorm",
        encoder=EncoderConfig(n_layers=2, layer=enc, max_positions=32),
        frontend="audio", n_frontend_tokens=32,
        supports_long=False,
    )
