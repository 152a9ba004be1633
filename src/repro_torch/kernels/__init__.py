"""Hand-written Hopper kernels for the FFT hot spots, with their plain
PyTorch versions (port of ``repro/kernels``).

fft_matmul      four-step (Bailey) batched 1-D FFT (``csrc/fft4step.cu``)
transpose_pack  rotated-block pack/unpack of the ring and pairwise
                transposes (``csrc/rotate_blocks.cu``)
ops             complex-in/complex-out entry points
ref             plain oracles for the tests
_build          nvcc build, ctypes loading and launch counters
"""

from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.ops import fft_matmul_1d

__all__ = ["fft_matmul_1d", "launch_counts", "reset_launch_counts"]
