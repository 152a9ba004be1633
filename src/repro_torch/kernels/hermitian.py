"""Two-for-one Hermitian split and its inverse: the Hopper kernels of
``csrc/hermitian.cu`` and their plain PyTorch versions.

Port of ``repro/kernels/hermitian.py``.  The CUDA kernels replace the
Pallas TPU kernels ``unpack_two_for_one_planes`` (``_unpack_kernel``) and
``hermitian_extend_planes`` (``_extend_kernel``):

  unpack  :func:`unpack_two_for_one`  C = FFT(a + i*b) of two packed
          real pencils -> the two folded half spectra A, B (the real
          Nyquist bin rides in the imaginary slot of the real DC bin),
          written straight into the two halves of the pair axis
  extend  :func:`hermitian_extend`    the exact inverse: folded A, B ->
          the full packed spectrum C[k] = A[k] + i*B[k],
          C[n-k] = conj(A[k] - i*B[k])

Bound on an H100: bytes — one read of every input byte and one write of
every output byte, a few adds per element.  The TPU kernels work on
real/imaginary float32 planes of (rows, n), and the reference's dispatch
(``repro/real/packing.py``) pays a split, a merge and a concatenate
around them; the CUDA kernels read and write interleaved complex64 and
address the pair axis themselves (``csrc/hermitian.cu`` says how), so
each is a single pass.

Both take a contiguous tensor: the packed stage hands them a fresh FFT
output, and the caller (``repro_torch/real/packing.py``) makes a strided
chunk contiguous before the launch.  A tensor on the CPU goes to the
plain version, which repeats the TPU kernel's arithmetic operation by
operation; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "hermitian"
UNPACK = "unpack_two_for_one"
EXTEND = "hermitian_extend"
# src, dst, rows, rows per pair half, n, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

# elements of the plain versions' temporaries per block (bounds their memory
# on a full-size spectrum; rows are independent)
_PLAIN_ELEMS = 1 << 24


def _view(shape, pair_axis: int) -> tuple[int, int, int]:
    """(outer, rows per pair half, n) of a (..., pair, ..., n) tensor."""
    if not 0 <= pair_axis < len(shape) - 1:
        raise ValueError(f"pair axis {pair_axis} must precede the transform "
                         f"axis of a rank-{len(shape)} tensor")
    outer = math.prod(shape[:pair_axis])
    return outer, math.prod(shape[pair_axis:-1]), shape[-1]


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"{what} takes complex64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")


def _launch(symbol: str, src: torch.Tensor, dst: torch.Tensor, rows: int,
            rows_per_half: int, n: int, count: str) -> None:
    fn = _build.function(NAME, symbol, _ARGTYPES)
    status = _build.call(fn, src.device, src.data_ptr(), dst.data_ptr(),
                         rows, rows_per_half, n)
    _build.check(status, count)
    _build.count_launch(count)


def unpack_two_for_one(c: torch.Tensor, pair_axis: int) -> torch.Tensor:
    """The packed z spectrum ``c`` (..., M/2, ..., n), n even, -> the
    folded half spectra (..., M, ..., n/2): A in the first half of the
    pair axis, B in the second (the reference's
    ``unpack_two(fold=True)``)."""
    pair_axis %= c.ndim
    outer, half_rows, n = _view(c.shape, pair_axis)
    if n % 2:
        raise ValueError(f"two-for-one fold needs even n, got {n}")
    if c.device.type == "cpu":
        return unpack_two_for_one_plain(c, pair_axis)
    c = _build.memory(c)
    _check_cuda(c, UNPACK)
    shape = list(c.shape)
    shape[pair_axis] *= 2
    shape[-1] //= 2
    out = torch.empty(shape, dtype=c.dtype, device=c.device)
    _launch("unpack_launch", c, out, outer * half_rows, half_rows, n, UNPACK)
    return out


def hermitian_extend(s: torch.Tensor, pair_axis: int, n: int) -> torch.Tensor:
    """Folded half spectra ``s`` (..., M, ..., n/2) -> the full packed
    spectrum (..., M/2, ..., n) (the reference's
    ``repack_halves(folded=True)``)."""
    pair_axis %= s.ndim
    outer, rows2, nh = _view(s.shape, pair_axis)
    if s.shape[pair_axis] % 2 or n != 2 * nh:
        raise ValueError(f"cannot extend {tuple(s.shape)} along pair axis "
                         f"{pair_axis} to n={n}")
    if s.device.type == "cpu":
        return hermitian_extend_plain(s, pair_axis, n)
    s = _build.memory(s)
    _check_cuda(s, EXTEND)
    shape = list(s.shape)
    shape[pair_axis] //= 2
    shape[-1] = n
    out = torch.empty(shape, dtype=s.dtype, device=s.device)
    _launch("extend_launch", s, out, outer * rows2 // 2, rows2 // 2, n, EXTEND)
    return out


def _negate_freq(a: torch.Tensor) -> torch.Tensor:
    """a[..., (-k) mod n]: [0, n-1, ..., 1]."""
    return torch.roll(torch.flip(a, [-1]), 1, -1)


def _blocks(outer: int, per_outer: int):
    """Slices of the outer index bounding each block's temporaries."""
    step = max(1, _PLAIN_ELEMS // max(1, per_outer))
    return [slice(o, min(outer, o + step)) for o in range(0, outer, step)]


def unpack_two_for_one_plain(c: torch.Tensor, pair_axis: int) -> torch.Tensor:
    """:func:`unpack_two_for_one` with the TPU kernel's float32 plane
    arithmetic (``_unpack_kernel``), block by block."""
    pair_axis %= c.ndim
    outer, half_rows, n = _view(c.shape, pair_axis)
    nz2 = n // 2
    v = c.reshape(outer, half_rows, n)
    out = torch.empty(outer, 2, half_rows, nz2, dtype=c.dtype, device=c.device)
    for blk in _blocks(outer, half_rows * n):
        cr, ci = v[blk].real, v[blk].imag
        rr, ri = _negate_freq(cr), _negate_freq(ci)
        a_r = 0.5 * (cr + rr)          # A = (C + conj(Crev)) / 2
        a_i = 0.5 * (ci - ri)
        b_r = 0.5 * (ci + ri)          # B = (C - conj(Crev)) / 2i
        b_i = -0.5 * (cr - rr)
        out[blk, 0] = torch.complex(
            a_r[..., :nz2],
            torch.cat([a_r[..., nz2:nz2 + 1], a_i[..., 1:nz2]], -1))
        out[blk, 1] = torch.complex(
            b_r[..., :nz2],
            torch.cat([b_r[..., nz2:nz2 + 1], b_i[..., 1:nz2]], -1))
    shape = list(c.shape)
    shape[pair_axis] *= 2
    shape[-1] = nz2
    return out.reshape(shape)


def hermitian_extend_plain(s: torch.Tensor, pair_axis: int,
                           n: int) -> torch.Tensor:
    """:func:`hermitian_extend` with the TPU kernel's float32 plane
    arithmetic (``_extend_kernel``), block by block."""
    pair_axis %= s.ndim
    outer, rows2, nh = _view(s.shape, pair_axis)
    v = s.reshape(outer, 2, rows2 // 2, nh)
    out = torch.empty(outer, rows2 // 2, n, dtype=s.dtype, device=s.device)
    for blk in _blocks(outer, rows2 * nh):
        sar, sai = v[blk, 0].real, v[blk, 0].imag
        sbr, sbi = v[blk, 1].real, v[blk, 1].imag
        # C[0] = A[0] + i B[0];  C[nyq] = A[nyq] + i B[nyq]  (folded in bin 0)
        body_r = sar[..., 1:] - sbi[..., 1:]
        body_i = sai[..., 1:] + sbr[..., 1:]
        tail_r = torch.flip(sar[..., 1:] + sbi[..., 1:], [-1])
        tail_i = torch.flip(-(sai[..., 1:] - sbr[..., 1:]), [-1])
        out[blk] = torch.complex(
            torch.cat([sar[..., :1], body_r, sai[..., :1], tail_r], -1),
            torch.cat([sbr[..., :1], body_i, sbi[..., :1], tail_i], -1))
    shape = list(s.shape)
    shape[pair_axis] //= 2
    shape[-1] = n
    return out.reshape(shape)
