"""fnet-350m [bonus, spectral] — 24L d_model=1024 d_ff=4096 vocab=32768.

Port of ``repro/configs/fnet_350m.py`` (a copy).

Not part of the assigned pool: this is the LM-side consumer of the paper's
technique (DESIGN.md §5) — token mixing by Fourier transform (FNet,
arXiv:2105.03824), with the sequence-axis FFT running CROFT's distributed
transpose machinery when the sequence is sharded.
"""

from repro_torch.models.config import LayerSpec, ModelConfig, simple_stack


def full() -> ModelConfig:
    spec = LayerSpec(mixer="spectral", ffn="gelu")
    return ModelConfig(
        name="fnet-350m", family="spectral",
        d_model=1024, d_ff=4096, vocab=32768,
        stages=simple_stack(24, spec),
        norm="layernorm",
        supports_decode=False,  # FNet mixing is not causal: encoder-only
        supports_long=False,
    )


def smoke() -> ModelConfig:
    spec = LayerSpec(mixer="spectral", ffn="gelu")
    return ModelConfig(
        name="fnet-350m-smoke", family="spectral",
        d_model=64, d_ff=128, vocab=256,
        stages=simple_stack(2, spec),
        norm="layernorm",
        supports_decode=False,
        supports_long=False,
    )
