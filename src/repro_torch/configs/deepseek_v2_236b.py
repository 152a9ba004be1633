"""deepseek-v2-236b [moe] — 60L d_model=5120 128H (MLA kv_lora=512)
d_ff(expert)=1536 vocab=102400, MoE 2 shared + 160 routed top-6; first
layer dense.  [arXiv:2405.04434; hf]

A copy of ``repro/configs/deepseek_v2_236b.py``.
"""

from repro_torch.models.config import (AttentionSpec, LayerSpec,
                                       ModelConfig, MoESpec, Stage)

MLA = dict(kind="mla", n_heads=128, n_kv_heads=128, head_dim=192,
           q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
           qk_rope_dim=64, v_head_dim=128)


def full() -> ModelConfig:
    attn = AttentionSpec(**MLA)
    dense = LayerSpec(mixer="attn", attn=attn, ffn="swiglu")
    moe = LayerSpec(
        mixer="attn", attn=attn, ffn="moe",
        moe=MoESpec(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    )
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        d_model=5120, d_ff=12288, vocab=102400,  # d_ff: dense layer 0
        stages=(Stage((dense,), 1), Stage((moe,), 59)),
        supports_long=False,  # full attention (MLA): skip long_500k
    )


def smoke() -> ModelConfig:
    attn = AttentionSpec(kind="mla", n_heads=4, n_kv_heads=4, head_dim=24,
                         q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16)
    dense = LayerSpec(mixer="attn", attn=attn, ffn="swiglu")
    moe = LayerSpec(mixer="attn", attn=attn, ffn="moe",
                    moe=MoESpec(n_experts=8, top_k=2, n_shared=1,
                                d_ff_expert=32, capacity_factor=2.0))
    return ModelConfig(
        name="deepseek-v2-236b-smoke", family="moe",
        d_model=64, d_ff=128, vocab=256,
        stages=(Stage((dense,), 1), Stage((moe,), 2)),
        supports_long=False,
    )
