"""Spectral token mixer (FNet-style): the LM-side consumer of CROFT.

Port of ``repro/models/spectral.py``.

y = Re( FFT_seq( FFT_model(x) ) )   (FNet, arXiv:2105.03824)

The model-dim FFT is always local.  The sequence-dim FFT, when the sequence
axis is sharded over a mesh axis (context parallelism), runs the paper's
transpose pattern: all-to-all the hidden axis out / sequence axis in,
local FFT, all-to-all back: one round of CROFT's pencil machinery with the
same K-chunked overlap knob (differentiable: a training pass on a mesh
runs it).  Both FFTs are ``local_fft.fft_matmul``, DFT
products as in the reference (no Pallas kernel there, so none here).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import local_fft
from repro_torch.core.distributed import FFTOptions, transpose_stage


def _fft(x: torch.Tensor, axis: int) -> torch.Tensor:
    return local_fft.fft_matmul(x, sign=-1, axis=axis)


def spectral_mixer(x: torch.Tensor, *, seq_axis_name: Optional[str] = None,
                   mesh=None, batch_spec=None,
                   overlap_k: int = 2) -> torch.Tensor:
    """x (B, S, D) real -> (B, S, D) real.

    ``seq_axis_name``: the mesh axis the sequence is sharded over (None =
    local); ``x`` is then this rank's (B_local, S/P, D) block.
    """
    xc = x.to(torch.complex64)
    xc = _fft(xc, -1)                       # hidden-dim FFT, always local
    if seq_axis_name is None:
        y = _fft(xc, 1)
    else:
        y = distributed_seq_fft(xc, seq_axis_name, mesh, batch_spec,
                                overlap_k)
    return y.real.to(x.dtype)


def distributed_seq_fft(xc: torch.Tensor, axis_name: str, mesh, batch_spec,
                        overlap_k: int = 2) -> torch.Tensor:
    """FFT along a sharded sequence axis via the CROFT transpose pattern,
    on this rank's block; every rank of ``axis_name`` calls it.

    local (B, S/P, D) --a2a--> (B, S, D/P) --fft(S)--> --a2a--> (B, S/P, D)

    ``batch_spec`` names the mesh axis the batch is sharded over (the
    reference's ``shard_map`` spec); each rank holds its own batch block,
    so the computation does not read it.
    """
    del batch_spec
    opts = FFTOptions(overlap_k=overlap_k)
    blk = transpose_stage(xc, comm_axis=axis_name, split_axis=2,
                          concat_axis=1, chunk_axis=0, opts=opts, mesh=mesh)
    blk = _fft(blk, 1)
    return transpose_stage(blk, comm_axis=axis_name, split_axis=1,
                           concat_axis=2, chunk_axis=0, opts=opts, mesh=mesh)


# --------------------------------------------------------------------------
# Learned spectral filter — the CROFT-side training workload
# --------------------------------------------------------------------------
#
# A two-parameter "spectral layer" over a distributed 3-D field:
#
#     y_hat(theta; x) = F( gate . x ) . filter
#
# with a learnable real-space gate (full grid) and a learnable k-space
# filter (half spectrum for r2c plans, full for c2c).  The transform is
# a planned Croft3D: the k-space multiply fuses as the plan's spectral
# epilogue (``forward_filtered``), and gradients replay the adjoint
# schedule (``repro_torch.grad``).  Its training step comes with the
# port of ``train/train_step.py``.


def spectral_filter_shapes(plan) -> tuple:
    """(gate shape, filter shape) for a plan's learned spectral layer."""
    return tuple(plan.shape), tuple(plan.spectrum_shape)


def init_spectral_filter_params(generator, plan, scale: float = 0.0,
                                dtype=torch.float32) -> dict:
    """Near-identity init: gate = 1 + scale*eps, filter = 1 + scale*eps,
    eps drawn from ``generator`` (a ``torch.Generator``, or None for the
    default one) on its device; the result lies on ``plan.device``.

    Real parameters in both domains (a real filter is the common
    physical case: attenuation per mode); ``scale=0`` gives the exact
    identity layer, useful as a deterministic oracle start.
    """
    gshape, fshape = spectral_filter_shapes(plan)
    draw = generator.device if generator is not None else "cpu"

    def one(shape):
        eps = torch.randn(shape, dtype=dtype, device=draw,
                          generator=generator)
        return (torch.ones(shape, dtype=dtype, device=draw)
                + scale * eps).to(plan.device)
    return {"gate": one(gshape), "filter": one(fshape)}


def place_spectral_filter_params(plan, params) -> dict:
    """The layer's params as the plan wants its operands: this rank's
    block of the gate as of the input field, of the filter as of the
    output spectrum (the whole arrays, on the plan's device, when
    meshless)."""
    if plan.mesh is None:
        return {k: v.to(plan.device) for k, v in params.items()}
    return {
        "gate": params["gate"][plan.input_sharding].contiguous().to(
            plan.device),
        "filter": params["filter"][plan.output_sharding].contiguous().to(
            plan.device),
    }


def spectral_filter_apply(plan, params, x: torch.Tensor) -> torch.Tensor:
    """``F(gate . x) . filter`` through the plan's fused epilogue."""
    gated = (params["gate"] * x).to(plan.input_dtype)
    h = params["filter"].to(plan.dtype)
    return plan.forward_filtered(gated, h)
