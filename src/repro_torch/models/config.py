"""Model configuration schema covering all assigned architecture families.

A copy of ``repro/models/config.py`` (plain dataclasses, no JAX), kept in
the port so that ``repro_torch`` imports nothing of ``repro``.

A model is a list of **stages**; a stage is a repeated **pattern** of layer
specs scanned with stacked parameters (HLO size stays O(pattern), not
O(n_layers)).  Heterogeneous stacks (gemma3's 5 local : 1 global, Griffin's
2 RG-LRU : 1 local-attn) become multi-layer patterns; stacks with a odd
prefix (DeepSeek's dense layer 0) become an extra stage.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    kind: str = "gqa"            # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    window: Optional[int] = None  # sliding-window size; None = full
    causal: bool = True
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # MLA (DeepSeek-V2) dims
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MLA W_uk/W_uv absorption: "always" | "never" | "decode" (serve-style:
    # absorbed for 1-token reads, decompressed for multi-token passes)
    mla_absorb: str = "always"
    # softmax scale override (MLA uses qk_nope+qk_rope dims)
    scale: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0            # DeepSeek shared experts
    d_ff_expert: int = 0         # per-expert hidden dim
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class RecurrentSpec:
    kind: str = "rglru"          # "rglru" | "rwkv6"
    d_state: int = 0             # rglru recurrent width (0 -> d_model)
    n_heads: int = 0             # rwkv6 heads (head k/v dim = d/heads)
    conv_width: int = 4          # rglru temporal conv
    chunk: int = 128             # chunked-scan length


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of a pattern: a token mixer + a channel mixer."""
    mixer: str = "attn"          # "attn" | "rglru" | "rwkv6"
    attn: Optional[AttentionSpec] = None
    recurrent: Optional[RecurrentSpec] = None
    ffn: str = "swiglu"          # "swiglu" | "geglu" | "gelu" | "rwkv_cm" | "moe"
    moe: Optional[MoESpec] = None
    cross_attn: bool = False     # decoder cross-attention (enc-dec)


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: tuple[LayerSpec, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    d_ff: int
    vocab: int
    stages: tuple[Stage, ...]
    norm: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    emb_scale_by_dim: bool = False   # gemma-style sqrt(d) embedding scale
    # encoder-decoder (whisper)
    encoder: Optional["EncoderConfig"] = None
    # modality frontend stub: extra embedded tokens prepended to text
    frontend: str = "none"       # "none" | "audio" | "vision"
    n_frontend_tokens: int = 0   # patches / frames per example
    prefix_lm: bool = False      # bidirectional attention over the prefix
    dtype: str = "bfloat16"
    # which shapes this arch supports (skip rules per DESIGN §5)
    supports_decode: bool = True
    supports_long: bool = False
    # family tag from the assignment ([moe] [dense] [audio] ...)
    family: str = "dense"

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer)."""
        d, total = self.d_model, 0
        total += self.vocab * d                      # tok embedding
        if not self.tie_embeddings:
            total += self.vocab * d                  # lm head
        for stage in self.stages:
            for spec in stage.pattern:
                total += stage.repeat * _layer_params(self, spec)
        if self.encoder is not None:
            e = self.encoder
            per = _layer_params(self, e.layer)
            total += e.n_layers * per + e.max_positions * d
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (6*N_active*D convention)."""
        d, total = self.d_model, 0
        total += self.vocab * d
        if not self.tie_embeddings:
            total += self.vocab * d
        for stage in self.stages:
            for spec in stage.pattern:
                total += stage.repeat * _layer_params(self, spec, active=True)
        if self.encoder is not None:
            e = self.encoder
            total += e.n_layers * _layer_params(self, e.layer) \
                + e.max_positions * d
        return total


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    layer: LayerSpec
    max_positions: int = 1500    # whisper-base frame positions


def _attn_params(d: int, a: AttentionSpec) -> int:
    if a.kind == "mla":
        qd = a.qk_nope_dim + a.qk_rope_dim
        n = 0
        if a.q_lora_rank:
            n += d * a.q_lora_rank + a.q_lora_rank * a.n_heads * qd
        else:
            n += d * a.n_heads * qd
        n += d * (a.kv_lora_rank + a.qk_rope_dim)
        n += a.kv_lora_rank * a.n_heads * (a.qk_nope_dim + a.v_head_dim)
        n += a.n_heads * a.v_head_dim * d
        return n
    hd = a.head_dim
    return (d * a.n_heads * hd + 2 * d * a.n_kv_heads * hd
            + a.n_heads * hd * d)


def _ffn_params(cfg: "ModelConfig", spec: LayerSpec, active: bool) -> int:
    d = cfg.d_model
    if spec.ffn == "moe":
        m = spec.moe
        e_count = (m.top_k + m.n_shared) if active else (m.n_experts + m.n_shared)
        return e_count * 3 * d * m.d_ff_expert + d * m.n_experts  # + router
    if spec.ffn in ("swiglu", "geglu"):
        return 3 * d * cfg.d_ff
    if spec.ffn == "gelu":
        return 2 * d * cfg.d_ff
    if spec.ffn == "rwkv_cm":
        return 2 * d * cfg.d_ff + d * d + 2 * d
    raise ValueError(spec.ffn)


def _mixer_params(cfg: "ModelConfig", spec: LayerSpec) -> int:
    d = cfg.d_model
    if spec.mixer == "attn":
        return _attn_params(d, spec.attn)
    if spec.mixer == "spectral":
        return 0  # parameter-free Fourier mixing
    r = spec.recurrent
    if r.kind == "rglru":
        ds = r.d_state or d
        return 2 * d * ds + ds * d + 2 * ds + r.conv_width * ds + 2 * d * ds
    if r.kind == "rwkv6":
        # r,k,v,g,o projections + token-shift/decay LoRAs + per-head params
        return 5 * d * d + (160 + 160 + 64 + 64) * d + 8 * d
    raise ValueError(r.kind)


def _layer_params(cfg: "ModelConfig", spec: LayerSpec, active: bool = False) -> int:
    n = _mixer_params(cfg, spec) + _ffn_params(cfg, spec, active)
    if spec.cross_attn:
        n += _attn_params(cfg.d_model, spec.attn)
    n += 2 * cfg.d_model  # two norms
    return n


def simple_stack(n_layers: int, spec: LayerSpec) -> tuple[Stage, ...]:
    return (Stage(pattern=(spec,), repeat=n_layers),)


def pattern_stack(n_layers: int, pattern: Sequence[LayerSpec]) -> tuple[Stage, ...]:
    """Repeat ``pattern`` as far as it divides, put the remainder in a tail
    stage (e.g. 34 layers of 5:1 local:global -> 5 full groups + 4 tail)."""
    p = len(pattern)
    groups, tail = divmod(n_layers, p)
    stages = []
    if groups:
        stages.append(Stage(pattern=tuple(pattern), repeat=groups))
    if tail:
        stages.append(Stage(pattern=tuple(pattern[:tail]), repeat=1))
    return tuple(stages)
