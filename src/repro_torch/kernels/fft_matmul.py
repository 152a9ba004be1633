"""Batched 1-D FFT by the four-step (Bailey) factorization: the Hopper
kernel ``csrc/fft4step.cu`` and its plain PyTorch version.

Port of ``repro/kernels/fft_matmul.py``.  The CUDA kernel replaces the
Pallas TPU kernel ``fft4step_planes`` (``_fft4step_kernel``): a DFT over
n1, the twiddle multiply, a DFT over n2 and the transposed write
k = k1 + n1·k2, for power-of-two N <= 4096.

Bound on an H100: memory — one pass over a complex64 tensor reads and
writes 16 bytes a point, while the 5·N·log2 N FFT count is ~6x below the
FP32 roofline at N = 1024.  The kernel runs both sub-DFTs as radix-2
FFTs held in registers, so it does that count and has only the bytes to
move; ``csrc/fft4step.cu`` says how it is laid out.

Two entry points: :func:`fft4step_axis` transforms any axis of a
tensor where it lies (the kernel reads a contiguous (outer, N, inner)
view), and :func:`fft4step`, the reference-shaped one, takes (B, N)
rows, the inner = 1 case.  A tensor on the CPU goes to the plain version
(:func:`fft4step_axis_plain`, :func:`fft4step_plain`), which repeats
the TPU kernel's arithmetic (stacked-real products in float32); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.device import full_fp32_matmul
from repro_torch.kernels import _build

NAME = "fft4step"
# x, y, twiddles, outer, inner, n1, n2, sign, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _checked_plan(n: int, sign: int) -> plan_lib.FFTPlan:
    plan = plan_lib.make_plan(n, sign, "complex64")
    if plan.n2 > plan_lib.MAX_RADIX:
        raise ValueError(
            f"N={n} exceeds the two-level kernel limit "
            f"{plan_lib.MAX_TWO_LEVEL}; use the matmul six-step path")
    return plan


def fft4step(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Batched FFT over the rows of a contiguous (B, N) complex64 tensor;
    N a power of two <= ``MAX_TWO_LEVEL``.  Unnormalized, ``sign`` -1
    forward."""
    if x.ndim != 2:
        raise ValueError(f"fft4step takes (B, N) rows, got shape {tuple(x.shape)}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("fft4step takes a contiguous tensor")
    return fft4step_axis(x, -1, sign)


def fft4step_axis(x: torch.Tensor, axis: int, sign: int = -1) -> torch.Tensor:
    """FFT along ``axis`` of a complex64 tensor of any rank, N =
    ``x.shape[axis]`` a power of two <= ``MAX_TWO_LEVEL``; the output has
    x's shape and layout.  A non-contiguous input is copied once to a
    contiguous one first.  Unnormalized, ``sign`` -1 forward."""
    if x.ndim == 0:
        raise ValueError("fft4step_axis takes a tensor with an axis")
    axis = axis % x.ndim
    n = x.shape[axis]
    plan = _checked_plan(n, sign)
    if x.device.type == "cpu":
        return fft4step_axis_plain(x, axis, sign)
    if x.device.type != "cuda":
        raise ValueError(f"fft4step runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"fft4step takes complex64, got {x.dtype}")
    x = _build.memory(x.contiguous())
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    # n2 == 1 reads no twiddles: any valid pointer will do
    tw = x if plan.tw is None else plan.twiddles_t_torch(x.device)
    y = torch.empty_like(x)
    fn = _build.function(NAME, "fft4step_launch", _ARGTYPES)
    status = _build.call(fn, x.device, x.data_ptr(), y.data_ptr(),
                         tw.data_ptr(), outer, inner, plan.n1, plan.n2, sign)
    _build.check(status, NAME)
    _build.count_launch(NAME)
    return y


def fft4step_axis_plain(x: torch.Tensor, axis: int,
                        sign: int = -1) -> torch.Tensor:
    """:func:`fft4step_axis` in plain tensor ops: the axis moved last, the
    rows through :func:`fft4step_plain`, the axis moved back."""
    axis = axis % x.ndim
    rows = x.movedim(axis, -1)
    shape = rows.shape
    y = fft4step_plain(rows.reshape(-1, shape[-1]), sign)
    return y.reshape(shape).movedim(-1, axis)


def _complex_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def fft4step_plain(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """The kernel's function in plain tensor ops: the TPU kernel's
    stacked-real float32 products, ``[xr xi] @ [[Wr, Wi], [-Wi, Wr]]``,
    row block by row block (rows are independent; the blocks bound the
    temporaries on a full-size batch)."""
    b, n = x.shape
    plan = _checked_plan(n, sign)
    full_fp32_matmul(x.device)
    n1, n2 = plan.n1, plan.n2
    w1 = torch.from_numpy(plan.w1_stacked).to(x.device)
    if n2 > 1:
        w2 = torch.from_numpy(plan.w2_stacked).to(x.device)
        twr = torch.from_numpy(plan.tw.real.copy()).to(x.device)
        twi = torch.from_numpy(plan.tw.imag.copy()).to(x.device)
    out = torch.empty(b, n, dtype=torch.complex64, device=x.device)
    step = max(1, (1 << 24) // n)
    for r0 in range(0, b, step):
        xb = x[r0:r0 + step]
        bb = xb.shape[0]
        xr, xi = xb.real.float(), xb.imag.float()
        if n2 == 1:
            # single DFT product: (Bb, 2N) @ (2N, 2N)
            ys = torch.cat([xr, xi], dim=1) @ w1
            out[r0:r0 + bb] = torch.complex(ys[:, :n], ys[:, n:])
            continue
        # stage 1: DFT over j1.  x[b, j1*n2 + j2] -> rows (b, j2), cols j1
        xr3 = xr.reshape(bb, n1, n2).transpose(1, 2).reshape(bb * n2, n1)
        xi3 = xi.reshape(bb, n1, n2).transpose(1, 2).reshape(bb * n2, n1)
        ys = torch.cat([xr3, xi3], dim=1) @ w1             # (Bb*n2, 2*n1)
        yr = ys[:, :n1].reshape(bb, n2, n1)                # [b, j2, k1]
        yi = ys[:, n1:].reshape(bb, n2, n1)
        # stage 2: twiddles T[j2, k1]
        zr, zi = _complex_mul(yr, yi, twr, twi)
        # stage 3: DFT over j2.  rows (b, k1), cols j2
        zr2 = zr.transpose(1, 2).reshape(bb * n1, n2)
        zi2 = zi.transpose(1, 2).reshape(bb * n1, n2)
        ws = torch.cat([zr2, zi2], dim=1) @ w2             # (Bb*n1, 2*n2)
        wr = ws[:, :n2].reshape(bb, n1, n2)                # [b, k1, k2]
        wi = ws[:, n2:].reshape(bb, n1, n2)
        # output index k = k1 + n1*k2  ->  lay out (b, k2, k1), ravel
        out[r0:r0 + bb] = torch.complex(wr.transpose(1, 2).reshape(bb, n),
                                        wi.transpose(1, 2).reshape(bb, n))
    return out
