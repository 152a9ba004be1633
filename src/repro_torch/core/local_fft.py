"""Local (single-device) 1-D FFTs: the executor's per-stage transform.

Port of ``repro/core/local_fft.py``'s 1-D FFTs.  CROFT calls FFTW's 1-D
routine along each axis; here four interchangeable implementations:

- ``fft_matmul``   four-step via complex products (full FP32; the
                   six-step recursion above ``MAX_TWO_LEVEL``)
- ``fft_stockham`` radix-2 decimation-in-time, vectorized
- ``fft_xla``      ``torch.fft`` (the library transform; the name is the
                   reference's, kept so plan tokens match)
- ``"pallas"``     the hand-written Hopper kernel (``kernels/fft_matmul``);
                   the name is the reference's, kept so tokens match

``stockham`` and ``xla`` operate along the *last* axis and ``fft_1d``
moves the axis for them; ``matmul`` and the kernel read the transform
axis where it lies.  Forward sign=-1, inverse sign=+1 unnormalized: a
3-D transform, one device's too, is a schedule of these
(``core/schedule.py``), scaled by ``schedule.normalize``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.device import full_fp32_matmul
from repro_torch.kernels import dft_rows
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs.tracer import span

DFT_PRODUCTS = "matmul_dft_products"
LAYOUT_COPIES = "matmul_layout_copies"
FUSED_AXES = "matmul_fused_axes"
PLAIN_AXES = "matmul_plain_axes"
DONATED_OUTPUTS = "matmul_donated_outputs"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def fft_xla(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    return torch.fft.fft(x) if sign == -1 else torch.fft.ifft(x) * x.shape[-1]


def _product(device, products: int = 1, name: str = "matmul:dft"):
    """Open ``products`` DFT products of :func:`fft_matmul`: a span
    ``name`` around all of their calls, and as many more on the
    ``matmul_dft_products`` counter."""
    metrics_lib.get_registry().counter(
        DFT_PRODUCTS, "DFT products issued by the matmul local FFT").inc(
            products)
    return span(name, "fft", device)


def _fused(device):
    """Open the fused kernel's run of a contiguous axis
    (``kernels/dft_rows``): its two products under one ``matmul:dft``
    span, and one more on the ``matmul_fused_axes`` counter."""
    metrics_lib.get_registry().counter(
        FUSED_AXES, "contiguous axes run by the fused DFT kernel").inc()
    return _product(device, 2)


def _plain(device):
    """Open the plain version's run of a contiguous axis the fused
    kernel does not take (complex128): its two products and the twiddle
    under one ``matmul:plain`` span, and one more on the
    ``matmul_plain_axes`` counter."""
    metrics_lib.get_registry().counter(
        PLAIN_AXES, "contiguous axes run by the fused DFT kernel's plain "
        "version").inc()
    return _product(device, 2, "matmul:plain")


def _donated() -> None:
    metrics_lib.get_registry().counter(
        DONATED_OUTPUTS, "axis outputs of the matmul local FFT written into "
        "the axis's own dead input").inc()


def _donatable(x: torch.Tensor) -> bool:
    """Whether ``x`` may take its own axis output: contiguous, the whole
    of the tensor it views (no K-chunk or other slice of a larger
    block), and not followed by autograd."""
    base = x if x._base is None else x._base
    return (x.is_contiguous() and x.storage_offset() == 0
            and base.numel() == x.numel() and not x.requires_grad)


def _merged_stride(shape, strides) -> Optional[int]:
    """The stride of ``shape``'s dims merged into one (1 for none), or
    None where they do not merge; a dim of size 1 takes any stride."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    if any(s0 != n1 * s1 for (_, s0), (n1, s1) in zip(dims, dims[1:])):
        return None
    return dims[-1][1] if dims else 1


def _axis_view(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` as ``(A, N, C)`` around ``axis``, a view the products read
    where it lies: the dims after the axis (or the axis itself when
    ``C == 1``) of unit stride.  Where no such view exists (a K-chunk
    slice across the merged dims, a ``movedim``) one ``contiguous()``,
    counted by ``matmul_layout_copies`` under ``matmul:relayout``."""
    a, n = math.prod(x.shape[:axis]), x.shape[axis]
    c = math.prod(x.shape[axis + 1:])
    sa = _merged_stride(x.shape[:axis], x.stride()[:axis])
    sc = _merged_stride(x.shape[axis + 1:], x.stride()[axis + 1:])
    sn = x.stride(axis)
    if sa is not None and sc is not None and (
            (c > 1 and sc == 1 and (n == 1 or sn >= c))
            or (c == 1 and (n == 1 or sn == 1) and (a == 1 or sa >= n))):
        return x.view(a, n, c)
    metrics_lib.get_registry().counter(
        LAYOUT_COPIES, "inputs of the matmul local FFT copied to a "
        "contiguous layout first").inc()
    with span("matmul:relayout", "unpack", x.device):
        return x.contiguous().view(a, n, c)


def _dft_axis(v: torch.Tensor, sign: int, plan_cache: bool,
              max_radix: int, donate: bool = False) -> torch.Tensor:
    """The DFT along the middle dim of an ``(A, N, C)`` view, into a new
    contiguous ``(A, N, C)`` tensor, or with ``donate`` (``v`` is a
    contiguous block no one else reads) into ``v`` itself where the axis
    runs two products outside the fused kernel: the second product of a
    strided axis, and of the plain version's contiguous axis, writes
    into ``v``, dead once the first product is queued
    (``matmul_donated_outputs``).  ``n = n2*j1 + j2`` in, ``k = k1 +
    n1*k2`` out, so the input reads as ``(A, j1, j2, C)`` and the output
    is written as ``(A, k2, k1, C)``: every product a GEMM on the
    operands where they lie, no copy between them.

    C > 1 (a strided axis): ``Y[:, j2] = H[j2] @ X[:, :, j2, :]`` with
    the twiddles folded into ``H`` (``FFTPlan.folded_torch``), then
    ``Z[a] = F2 @ Y[a]`` as ``(n2, n1*C)``: two passes.
    C = 1 (the contiguous axis): ``Y[a] = F1 @ X[a]``, the twiddle,
    ``Z[a] = F2 @ Y[a]^T``: ``kernels/dft_rows``, one pass where its
    kernel takes the dtype and split (complex64, 128 to 4096 points),
    else three (its plain version, ``matmul:plain``).
    Above ``max_radix**2`` the second stage is this function again on
    ``Y`` as ``(A, n2, n1*C)`` (six-step); on the contiguous axis the
    twiddle pass then writes ``Y`` transposed, ``(A, j2, k1)``, for it.
    """
    a, n, c = v.shape
    dev = v.device
    plan = plan_lib.make_plan(n, sign, _dtype_name(v.dtype), max_radix)
    w1, w2, tw = plan.constants_torch(dev, rematerialize=not plan_cache)
    if plan.n2 == 1:
        out = v.new_empty((a, n, c))
        with _product(dev):
            if c == 1:
                # w1 is symmetric: rows of X times w1, one GEMM
                torch.mm(v[:, :, 0], w1, out=out[:, :, 0])
            else:
                dft_rows.left(w1, v, out)
        return out
    n1, n2 = plan.n1, plan.n2
    if c == 1 and plan.two_level:
        tw_t = (plan.twiddles_t_torch(dev) if plan_cache
                else tw.t().contiguous())
        if dft_rows.takes(v.dtype, n1, n2):
            with _fused(dev):
                z = dft_rows.dft_rows(v[:, :, 0], w1, w2, tw_t)
        else:
            with _plain(dev):
                z = dft_rows.dft_rows_plain(v[:, :, 0], w1, w2, tw_t,
                                            v[:, :, 0] if donate else None)
            if donate:
                _donated()
        return z.view(a, n, 1)
    x4 = v.unflatten(1, (n1, n2))                   # (a, j1, j2, c)
    if c == 1:
        y = v.new_empty((a, n1, n2))                # (a, k1, j2)
        with _product(dev):
            dft_rows.left(w1, x4[..., 0], y)
        yt = v.new_empty((a, n2, n1))               # (a, j2, k1)
        with span("matmul:twiddle", "epilogue", dev):
            torch.mul(y.transpose(1, 2), tw, out=yt)
        return _dft_axis(yt, sign, plan_cache, max_radix).view(a, n, 1)
    h = plan.folded_torch(dev, rematerialize=not plan_cache)
    y = v.new_empty((a, n2, n1, c))                 # (a, j2, k1, c)
    with _product(dev):
        if a <= n2:     # a call per a, batched over j2
            for i in range(a):
                torch.bmm(h, x4[i].transpose(0, 1), out=y[i])
        else:           # a call per j2, batched over a
            for j in range(n2):
                torch.bmm(h[j].expand(a, -1, -1), x4[:, :, j], out=y[:, j])
    y = y.view(a, n2, n1 * c)
    if not plan.two_level:
        return _dft_axis(y, sign, plan_cache, max_radix).view(a, n, c)
    out = v if donate else v.new_empty((a, n, c))   # (a, k2, k1, c)
    with _product(dev):
        dft_rows.left(w2, y, out.view(a, n2, n1 * c))
    if donate:
        _donated()
    return out


class _AxisDFT:
    """:func:`fft_matmul` as a linear plan (``grad.vjp.Linear``): the
    products write into ``out=`` tensors, which autograd cannot follow.
    The DFT matrix is symmetric, so ``F_s^H = F_{-s}``: the adjoint is
    the same transform with the sign flipped."""

    def __init__(self, sign, axis, plan_cache, max_radix):
        self.sign, self.axis = sign, axis
        self.plan_cache, self.max_radix = plan_cache, max_radix

    def run(self, x):
        return _fft_matmul(x, self.sign, self.axis, self.plan_cache,
                           self.max_radix)

    def adjoint(self, g):
        return fft_matmul(g, -self.sign, axis=self.axis,
                          plan_cache=self.plan_cache,
                          max_radix=self.max_radix)


def fft_matmul(x: torch.Tensor, sign: int = -1, *, axis: int = -1,
               plan_cache: bool = True,
               max_radix: int = plan_lib.MAX_RADIX,
               donate: bool = False) -> torch.Tensor:
    """Four-step FFT along ``axis``, read where it lies (any power-of-two
    size; :func:`_dft_axis` says how).

    n <= max_radix           : single DFT product
    n <= max_radix**2        : (n1, n2) split: two products, the
                               contiguous axis a twiddle pass between
                               (complex64: one pass of kernels/dft_rows)
    larger                   : six-step recursion on the n2 axis

    Spans: ``matmul:dft`` a product (both of a two-level contiguous
    axis, its twiddle too; ``matmul_fused_axes`` counts those the fused
    kernel runs; ``matmul:plain`` instead where its plain version runs,
    counted by ``matmul_plain_axes``), ``matmul:twiddle`` a six-step
    level's twiddle pass, ``matmul:relayout`` the input's copy where it
    has no ``(A, N, C)`` view (``matmul_layout_copies``).
    Differentiable through ``grad.vjp.Linear``.

    ``donate``: the caller made ``x`` and reads it no more, so the axis
    output may take its storage (:func:`_dft_axis` says where); taken
    only where ``x`` is a contiguous whole block that autograd does not
    follow.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        from repro_torch.grad import vjp
        return vjp.Linear.apply(x, _AxisDFT(sign, axis, plan_cache,
                                            max_radix))
    return _fft_matmul(x, sign, axis, plan_cache, max_radix,
                       donate and _donatable(x))


def _fft_matmul(x, sign, axis, plan_cache, max_radix, donate=False):
    full_fp32_matmul(x.device)
    axis = axis % x.ndim
    v = _axis_view(x, axis)
    return _dft_axis(v, sign, plan_cache, max_radix,
                     donate).view(x.shape)


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


def fft_1d(x: torch.Tensor, axis: int, sign: int = -1, *,
           impl: str = "matmul", plan_cache: bool = True,
           donate: bool = False) -> torch.Tensor:
    """1-D FFT along ``axis`` with the chosen implementation;
    ``donate`` (``fft_matmul``'s) is taken by ``matmul`` alone."""
    if impl == "pallas":
        # the Hopper kernel reads the transform axis where it lies
        from repro_torch.kernels import fft_matmul as kernel
        return kernel.fft4step_axis(x, axis, sign)
    if impl == "matmul":
        return fft_matmul(x, sign, axis=axis, plan_cache=plan_cache,
                          donate=donate)
    if impl == "xla":
        fn = lambda v: fft_xla(v, sign)
    elif impl == "stockham":
        fn = lambda v: fft_stockham(v, sign, plan_cache=plan_cache)
    else:
        raise KeyError(impl)
    return fn(x.movedim(axis, -1)).movedim(-1, axis)
