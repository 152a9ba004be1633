"""Local (single-device) 1-D FFT building blocks.

Port of ``repro/core/local_fft.py``.  CROFT calls FFTW's 1-D routine along
each axis; here four interchangeable implementations:

- ``fft_matmul``   four-step via complex products (full FP32; the
                   six-step recursion above ``MAX_TWO_LEVEL``)
- ``fft_stockham`` radix-2 decimation-in-time, vectorized
- ``fft_xla``      ``torch.fft`` (the library transform; the name is the
                   reference's, kept so plan tokens match)
- ``"pallas"``     the hand-written Hopper kernel (``kernels/fft_matmul``);
                   the name is the reference's, kept so tokens match

All but ``"pallas"`` operate along the *last* axis and ``fft_1d`` moves
the axis for them; the kernel transforms any axis in place.  Forward
sign=-1, inverse sign=+1 unnormalized (normalization applied at the 3-D
level, eq. (2) of the paper).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.device import full_fp32_matmul
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs.tracer import span

DFT_PRODUCTS = "matmul_dft_products"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def fft_xla(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    return torch.fft.fft(x) if sign == -1 else torch.fft.ifft(x) * x.shape[-1]


def _dft_product(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One DFT product of :func:`fft_matmul` (a ``matmul:dft`` span, the
    copies ``einsum`` makes around its GEMM included); each adds one to
    the ``matmul_dft_products`` counter."""
    metrics_lib.get_registry().counter(
        DFT_PRODUCTS, "DFT products issued by the matmul local FFT").inc()
    with span("matmul:dft", "fft", x.device):
        return torch.einsum(eq, x, w)


def fft_matmul(x: torch.Tensor, sign: int = -1, *, plan_cache: bool = True,
               max_radix: int = plan_lib.MAX_RADIX) -> torch.Tensor:
    """Four-step FFT along the last axis.  Supports any power-of-two size.

    n <= max_radix           : single DFT product
    n <= max_radix**2        : reshape (n1, n2); DFT(n1); twiddle;
                               DFT(n2); transpose  (the kernel computes
                               exactly this path)
    larger                   : six-step recursion on the n2 axis

    Spans: ``matmul:dft`` a product, ``matmul:twiddle`` the twiddle
    multiply, ``matmul:relayout`` the output's transposed copy.
    """
    full_fp32_matmul(x.device)
    n = x.shape[-1]
    plan = plan_lib.make_plan(n, sign, _dtype_name(x.dtype), max_radix)
    w1, w2, tw = plan.constants_torch(x.device, rematerialize=not plan_cache)
    if plan.n2 == 1:
        # x (..., n), w (n, k): contraction over the last axis
        return _dft_product("...n,nk->...k", x, w1)

    batch = tuple(x.shape[:-1])
    n1, n2 = plan.n1, plan.n2
    # n = n2*j1 + j2  (row-major reshape)
    xr = x.reshape(batch + (n1, n2))
    # stage 1: DFT over j1 -> (..., n2, k1)
    y = _dft_product("...jt,jk->...tk", xr, w1)
    # stage 2: twiddles T[j2, k1]
    with span("matmul:twiddle", "epilogue", x.device):
        y = y * tw
    if n2 <= max_radix:
        # stage 3: DFT over j2 -> (..., k1, k2): contract the t axis
        z = _dft_product("...tk,ts->...ks", y, w2)
    else:
        # six-step: recurse along the n2 axis (currently axis -2); move it
        # last, recurse, move back
        y = y.transpose(-1, -2)  # (..., k1, n2)
        z = fft_matmul(y, sign, plan_cache=plan_cache, max_radix=max_radix)
        # z[..., k1, k2] already
    # output index k = k1 + n1*k2  -> lay out (..., k2, k1) then ravel
    with span("matmul:relayout", "unpack", x.device):
        return z.transpose(-1, -2).reshape(batch + (n,))


def fft_stockham(x: torch.Tensor, sign: int = -1, *,
                 plan_cache: bool = True) -> torch.Tensor:
    """Radix-2 DIT FFT along the last axis (power-of-two sizes).

    Vectorized butterflies; the per-stage twiddles are plan constants.
    This is the "CPU-shaped" algorithm kept for contrast with the matmul
    path.
    """
    n = x.shape[-1]
    if not plan_lib._is_pow2(n):
        raise ValueError(f"power-of-two sizes only, got {n}")
    stages = int(math.log2(n))
    # bit-reversal permutation as a static gather
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(stages):
        rev |= ((idx >> b) & 1) << (stages - 1 - b)
    y = x[..., torch.from_numpy(rev).to(x.device)]
    for s in range(stages):
        m = 1 << (s + 1)  # butterfly span
        half = m // 2
        if plan_cache:
            tw_np = np.exp(sign * 2j * np.pi * np.arange(half) / m).astype(
                np.dtype(_dtype_name(x.dtype)))
            tw = torch.from_numpy(tw_np).to(x.device)
        else:
            k = torch.arange(half, dtype=torch.float32, device=x.device)
            ang = (sign * 2.0 * math.pi / m) * k
            tw = torch.complex(torch.cos(ang), torch.sin(ang)).to(x.dtype)
        yr = y.reshape(y.shape[:-1] + (n // m, m))
        even, odd = yr[..., :half], yr[..., half:]
        t = odd * tw
        y = torch.cat([even + t, even - t], dim=-1).reshape(y.shape)
    return y


_IMPLS = {"matmul": fft_matmul, "stockham": fft_stockham, "xla": fft_xla}


def fft_1d(x: torch.Tensor, axis: int, sign: int = -1, *,
           impl: str = "matmul", plan_cache: bool = True) -> torch.Tensor:
    """1-D FFT along ``axis`` with the chosen implementation."""
    if impl == "pallas":
        # the Hopper kernel reads the transform axis where it lies
        from repro_torch.kernels import fft_matmul
        return fft_matmul.fft4step_axis(x, axis, sign)
    if impl == "xla":
        fn = lambda v: fft_xla(v, sign)
    else:
        base = _IMPLS[impl]
        fn = lambda v: base(v, sign, plan_cache=plan_cache)
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def fft3d_local(x: torch.Tensor, sign: int = -1, *, impl="matmul",
                plan_cache: bool = True,
                norm: Optional[str] = None) -> torch.Tensor:
    """Single-device 3-D FFT over the last three axes (x, y, z order).

    ``impl`` may be a 3-tuple of implementations, one per axis in
    transform order (x, y, z) — the per-stage form of
    ``FFTOptions.local_impl``.
    """
    if x.ndim < 3:
        raise ValueError(f"fft3d_local needs >= 3 dims, got {x.ndim}")
    if torch.is_grad_enabled() and x.requires_grad:
        from repro_torch.grad import vjp
        return vjp.Linear.apply(x, _Local3D(sign, impl, plan_cache, norm))
    return _fft3d(x, sign, impl, plan_cache, norm)


def _fft3d(x, sign, impl, plan_cache, norm):
    for stage, ax in enumerate((-3, -2, -1)):
        stage_impl = impl[stage] if isinstance(impl, (tuple, list)) else impl
        with span("stage:fft", "fft"):
            x = fft_1d(x, ax, sign, impl=stage_impl, plan_cache=plan_cache)
    return apply_norm(x, sign, norm)


class _Local3D:
    """:func:`fft3d_local` as a linear plan (``grad.vjp.Linear``).
    ``y = c F_s x`` with a real norm factor c, so ``x.grad = c F_{-s} g``:
    the same kernels with the sign flipped and the same factor
    (``apply_norm`` with the forward's sign)."""

    def __init__(self, sign, impl, plan_cache, norm):
        self.sign, self.impl, self.plan_cache, self.norm = (sign, impl,
                                                            plan_cache, norm)

    def run(self, x):
        return _fft3d(x, self.sign, self.impl, self.plan_cache, self.norm)

    def adjoint(self, g):
        return apply_norm(_fft3d(g, -self.sign, self.impl, self.plan_cache,
                                 "none"), self.sign, self.norm)


def apply_norm(x: torch.Tensor, sign: int, norm: Optional[str]) -> torch.Tensor:
    """Paper convention (eq. 2): forward unnormalized, inverse 1/(NxNyNz).
    A scale is an ``inverse:normalize`` span."""
    nxyz = x.shape[-3] * x.shape[-2] * x.shape[-1]
    if norm is None or norm == "backward":
        if sign != +1:
            return x
        with span("inverse:normalize", "epilogue", x.device):
            return x / nxyz
    if norm == "ortho":
        with span("inverse:normalize", "epilogue", x.device):
            return x / math.sqrt(nxyz)
    if norm == "none":
        return x
    raise ValueError(f"unknown norm {norm!r}")
