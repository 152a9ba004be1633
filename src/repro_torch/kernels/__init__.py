"""Hand-written Hopper kernels for the FFT hot spots and the LM's
attention, with their plain PyTorch versions (port of ``repro/kernels``).

fft_matmul      four-step (Bailey) 1-D FFT along any axis, in place
                (``csrc/fft4step.cu``)
transpose_pack  rotated-block pack/unpack of the ring and pairwise
                transposes (``csrc/rotate_blocks.cu``)
hermitian       two-for-one Hermitian split and extend of the packed real
                transforms (``csrc/hermitian.cu``)
spectral_scale  fused k-space multiply, the spectral epilogue, and the
                Poisson solve's multiply with -1/k^2 computed in the pass
                (``csrc/spectral_scale.cu``)
flash_attention fused causal/windowed GQA attention, the LM prefill:
                bf16 on the tensor cores, float32 in FFMA
                (``csrc/flash_attention.cu``)
dft_rows        the matmul local FFT's contiguous axis in one pass: both
                dense DFT products and the twiddle, float32 in FFMA
                (``csrc/dft_rows.cu``)
ops             complex-in/complex-out entry points
ref             plain oracles for the tests
_build          nvcc build, ctypes loading and launch counters
"""

from repro_torch.kernels._build import (KernelError, launch_counts,
                                       reset_launch_counts)
from repro_torch.kernels.ops import fft_matmul_1d, spectral_scale_op

__all__ = ["KernelError", "fft_matmul_1d", "launch_counts",
           "reset_launch_counts", "spectral_scale_op"]
