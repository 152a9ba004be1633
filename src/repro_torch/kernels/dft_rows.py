"""The contiguous axis of the matmul local FFT in one pass: the Hopper
kernel ``csrc/dft_rows.cu`` and its plain PyTorch version.

Replaces no Pallas TPU kernel: the reference leaves these DFT products to
XLA (``repro/core/local_fft.py:fft_matmul``).  For rows of N = n1·n2
points (the plan's two-level split, n1, n2 <= 64) it computes the three
steps of :func:`repro_torch.core.local_fft._dft_axis` on a contiguous
axis, ``Y = F1 @ X``, ``Y *= T``, ``out = F2 @ Y^T``, with the plan's own
tables: dense float32 products (no TF32, no butterflies), so each output
has the same terms as the cuBLAS path, summed in another order.

Bound on an H100: operations.  Two products of 32 complex multiply-adds
an output over 2^20 rows of 1024 points are 5.5e11 flop, 8.2 ms at 67
TFLOP/s FP32, against 5.1 ms for the bytes of one read and one write of
the rows.  The three-step path moved those bytes three times, in two
cuBLAS ``cgemm`` and a twiddle pass; the kernel keeps both products and
the twiddle in registers and shared memory (``csrc/dft_rows.cu`` says
how).

:func:`dft_rows` launches the kernel for a CUDA tensor and runs
:func:`dft_rows_plain`, the three steps in tensor ops, for a CPU tensor
(also a fake one: the dry run's); on ``meta`` it only allocates the
output.  It never falls back: a CUDA tensor it does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "dft_rows"
# the (n1, n2) splits the kernel is built for: every two-level split of
# 128 to 4096 points (core/plan.py:split_factors)
SPLITS = frozenset({(16, 8), (16, 16), (32, 16), (32, 32), (64, 32),
                    (64, 64)})
# x, out, w1, w2, tw_t, rows, stride, n1, n2, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def takes(dtype: torch.dtype, n1: int, n2: int) -> bool:
    """Whether the kernel computes an axis of ``dtype`` split as
    ``(n1, n2)``: complex64, one of :data:`SPLITS`."""
    return dtype == torch.complex64 and (n1, n2) in SPLITS


def dft_rows(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
             tw_t: torch.Tensor) -> torch.Tensor:
    """The DFT of each row of ``x`` (A, n1·n2): ``x[a, n2·j1 + j2]`` in,
    ``out[a, k1 + n1·k2]`` out, a new contiguous (A, n1·n2) tensor.
    ``w1`` (n1, n1) and ``w2`` (n2, n2) are the plan's DFT matrices,
    ``tw_t`` (n1, n2) its twiddles transposed (``tw_t[k1, j2]``); the sign
    is theirs.  Rows may lie any stride of at least n1·n2 apart; the
    points of a row lie next to each other."""
    n1, n2 = w1.shape[0], w2.shape[0]
    a, n = x.shape
    if n != n1 * n2:
        raise ValueError(f"rows of {n} points for a {n1} x {n2} split")
    if x.device.type == "meta":
        return x.new_empty((a, n))
    if x.device.type == "cpu":
        return dft_rows_plain(x, w1, w2, tw_t)
    x = _build.memory(x)
    for t, what in ((x, "x"), (w1, "w1"), (w2, "w2"), (tw_t, "tw_t")):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{NAME} runs on one cuda device; {what} is on "
                             f"{t.device}")
        if t.dtype != torch.complex64:
            raise TypeError(f"{NAME} takes complex64, got {what} {t.dtype}")
    if (n1, n2) not in SPLITS:
        raise ValueError(f"{NAME} takes the splits {sorted(SPLITS)}, not "
                         f"{(n1, n2)}")
    stride = x.stride(0) if a > 1 else n
    if x.stride(1) != 1 or stride < n:
        raise ValueError(f"{NAME} takes rows of unit stride at least {n} "
                         f"apart, got strides {x.stride()}")
    w1, w2, tw_t = (_build.memory(t) for t in (w1, w2, tw_t))
    if not (w1.is_contiguous() and w2.is_contiguous()
            and tw_t.is_contiguous() and tw_t.shape == (n1, n2)):
        raise ValueError(f"{NAME} takes contiguous tables, tw_t ({n1}, {n2})")
    out = torch.empty((a, n), dtype=x.dtype, device=x.device)
    fn = _build.function(NAME, "dft_rows_launch", _ARGTYPES)
    status = _build.call(fn, x.device, x.data_ptr(), out.data_ptr(),
                         w1.data_ptr(), w2.data_ptr(), tw_t.data_ptr(), a,
                         stride, n1, n2)
    _build.check(status, NAME)
    _build.count_launch(NAME)
    return out


def left(w: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """``out[i] = w @ b[i]`` over the batch dim, one cuBLAS call: a GEMM
    reads ``b`` and writes ``out`` where they lie (each matrix needs one
    unit stride), ``w`` broadcast with batch stride 0.  The matmul local
    FFT's batched product (``core/local_fft.py``)."""
    if b.shape[0] == 1:
        torch.mm(w, b[0], out=out[0])
    else:
        torch.bmm(w.expand(b.shape[0], -1, -1), b, out=out)


def dft_rows_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   tw_t: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`dft_rows` in tensor ops: the three steps the kernel fuses,
    ``Y = F1 @ X``, ``Y *= T``, ``out = F2 @ Y^T``, three passes.  The
    matmul local FFT runs them so where the kernel does not take the
    dtype or split (complex128: cuBLAS ``zgemm``).  ``out``, a contiguous
    (A, n1·n2) tensor, takes the result where given: ``x`` itself may,
    as nothing reads ``x`` after the first product."""
    n1, n2 = w1.shape[0], w2.shape[0]
    a = x.shape[0]
    y = x.new_empty((a, n1, n2))                    # (a, k1, j2)
    left(w1, x.unflatten(1, (n1, n2)), y)
    y.mul_(tw_t)
    if out is None:
        out = x.new_empty((a, n1 * n2))
    left(w2, y.transpose(1, 2), out.view(a, n2, n1))   # (a, k2, k1)
    return out
