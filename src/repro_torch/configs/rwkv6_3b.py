"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch: data-dependent decay, token-shift LoRAs, matrix-valued state.
[arXiv:2404.05892; hf]

A copy of ``repro/configs/rwkv6_3b.py``.
"""

from repro_torch.models.config import (LayerSpec, ModelConfig, RecurrentSpec,
                                       simple_stack)


def full() -> ModelConfig:
    spec = LayerSpec(
        mixer="rwkv6",
        recurrent=RecurrentSpec(kind="rwkv6", n_heads=40, chunk=64),
        ffn="rwkv_cm",
    )
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        d_model=2560, d_ff=8960, vocab=65536,
        stages=simple_stack(32, spec),
        norm="layernorm",
        supports_long=True,  # O(1) state decode
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(
        mixer="rwkv6",
        recurrent=RecurrentSpec(kind="rwkv6", n_heads=4, chunk=8),
        ffn="rwkv_cm",
    )
    return ModelConfig(
        name="rwkv6-3b-smoke", family="ssm",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, spec),
        norm="layernorm",
        supports_long=True,
    )
