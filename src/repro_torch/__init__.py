"""repro_torch: the CROFT distributed 3-D FFT on PyTorch and CUDA.

The port of ``repro`` (the JAX package, kept as the reference) to an
NVIDIA H100: plain tensor code in PyTorch, the TPU kernels rewritten by
hand for Hopper (``repro_torch/kernels/csrc``), ``torch.distributed``
process groups in place of JAX mesh axes.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
