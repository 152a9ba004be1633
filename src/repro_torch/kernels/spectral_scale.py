"""Fused complex multiply-scale in frequency space, y = (alpha x) h: the
Hopper kernel ``csrc/spectral_scale.cu`` and its plain PyTorch version.

Port of ``repro/kernels/spectral_scale.py``.  The CUDA kernel replaces
both Pallas TPU kernels of that module, which share one body
(``_scale_kernel``):

  :func:`spectral_scale_planes`       h of shape (N,) broadcast over the
                                      rows of x (B, N)
  :func:`spectral_scale_planes_full`  h of the shape of x (the full 3-D
                                      k-space filter of a spectral solver)

The names are the reference's; the port takes interleaved complex64, not
real/imaginary planes, so no split or merge pass surrounds the kernel.

Bound on an H100: bytes — x read once, y written once, h read once
(full) or from L1/L2 (broadcast); ~8 flop per element.  The kernel
streams 16-byte vectors, two complex values each, four loads in flight
per thread, one span per block (``csrc/spectral_scale.cu``).  It scales x by alpha *before* the product,
as the TPU kernel does, and rounds every product and sum on its own; the
plain version repeats that order, so the two agree to the bit.

:func:`spectral_scale` is the schedule-epilogue dispatcher with the
reference's rule: complex64 with ``h.shape == x.shape`` goes to the
kernel (on a CUDA tensor) or its plain version (on a CPU tensor);
anything else takes the reference's plain expression ``x * h``, then
``* alpha``.

:func:`poisson_scale` is the Poisson solve's multiply: the multiplier
``h = -1/k²`` is computed inside the pass from the three 1-D wavenumber
vectors (``poisson_kernel`` of the same file on a CUDA tensor, or
:func:`poisson_scale_plain`), so no tensor of the spectrum's shape holds
it; its bound is x read once and y written once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "spectral_scale"
BROADCAST = "spectral_scale"
FULL = "spectral_scale_full"
POISSON = "spectral_scale_poisson"

# elements of the plain version's temporaries per block
_PLAIN_ELEMS = 1 << 24
# x, h, y, rows, n, h's row stride, alpha, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_void_p]
# x, kx, ky, kz, y, rows, ny, nz, alpha, stream
_POISSON_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
    ctypes.c_float, ctypes.c_void_p]


def _like_aligned(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor like contiguous ``x`` whose base has x's address
    mod 16 bytes, so the kernel's 16-byte vectors line up on both: a base
    8 bytes past a 16-byte boundary (x a view one element in) gets a
    buffer one element longer, viewed from its second element."""
    if x.data_ptr() % 16 == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape)


def _launch(x: torch.Tensor, h: torch.Tensor, alpha: float, full: bool,
            count: str) -> torch.Tensor:
    x, h = _build.memory(x), _build.memory(h)
    for t, what in ((x, "x"), (h, "h")):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{count} runs on one cuda device; {what} is on "
                             f"{t.device}")
        if t.dtype != torch.complex64:
            raise TypeError(f"{count} takes complex64, got {what} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{count} takes contiguous tensors ({what})")
    rows, n = x.shape
    y = _like_aligned(x)
    fn = _build.function(NAME, "spectral_scale_launch", _ARGTYPES)
    status = _build.call(fn, x.device, x.data_ptr(), h.data_ptr(),
                         y.data_ptr(), rows, n, n if full else 0,
                         float(alpha))
    _build.check(status, count)
    _build.count_launch(count)
    return y


def spectral_scale_planes(x: torch.Tensor, h: torch.Tensor,
                          alpha: float = 1.0) -> torch.Tensor:
    """(B, N) complex64 times the (N,) filter ``h`` broadcast over rows,
    x scaled by ``alpha`` first."""
    if x.ndim != 2 or h.shape != (x.shape[1],):
        raise ValueError(f"expected x (B, N) and h (N,), got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    if x.device.type == "cpu":
        return spectral_scale_plain(x, h, alpha)
    return _launch(x, h, alpha, False, BROADCAST)


def spectral_scale_planes_full(x: torch.Tensor, h: torch.Tensor,
                               alpha: float = 1.0) -> torch.Tensor:
    """(B, N) complex64 times the same-shape filter ``h``, x scaled by
    ``alpha`` first."""
    if x.ndim != 2 or h.shape != x.shape:
        raise ValueError(f"expected x and h of one (B, N) shape, got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    if x.device.type == "cpu":
        return spectral_scale_plain(x, h, alpha)
    return _launch(x, h, alpha, True, FULL)


def _scale_block(xb: torch.Tensor, hr, hi, alpha: float) -> torch.Tensor:
    """The TPU kernel's float32 plane arithmetic on one block."""
    xr = xb.real * alpha
    xi = xb.imag * alpha
    return torch.complex(xr * hr - xi * hi, xr * hi + xi * hr)


def spectral_scale_plain(x: torch.Tensor, h: torch.Tensor,
                         alpha: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain tensor ops, with the TPU kernel's
    float32 plane arithmetic: ``xr = x.re * alpha``, ``xi = x.im *
    alpha``, ``y = (xr hr - xi hi, xr hi + xi hr)``; ``h`` is (N,) or the
    shape of ``x`` (B, N).  Row block by row block."""
    rows, n = x.shape
    y = torch.empty_like(x)
    step = max(1, _PLAIN_ELEMS // max(1, n))
    for r0 in range(0, rows, step):
        hb = h if h.ndim == 1 else h[r0:r0 + step]
        y[r0:r0 + step] = _scale_block(x[r0:r0 + step], hb.real, hb.imag,
                                       alpha)
    return y


def _poisson_launch(x: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor,
                    kz: torch.Tensor, alpha: float) -> torch.Tensor:
    x = _build.memory(x)
    if x.dtype != torch.complex64:
        raise TypeError(f"{POISSON} takes complex64, got x {x.dtype}")
    for t, what in ((kx, "kx"), (ky, "ky"), (kz, "kz")):
        if t.device != x.device:
            raise ValueError(f"{POISSON} runs on one cuda device; {what} is "
                             f"on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{POISSON} takes float32 wavenumbers, got "
                            f"{what} {t.dtype}")
    kx, ky, kz = (_build.memory(t).contiguous() for t in (kx, ky, kz))
    rows, ny, nz = x.shape
    y = _like_aligned(x)
    fn = _build.function(NAME, "spectral_scale_poisson_launch",
                         _POISSON_ARGTYPES)
    status = _build.call(fn, x.device, x.data_ptr(), kx.data_ptr(),
                         ky.data_ptr(), kz.data_ptr(), y.data_ptr(), rows,
                         ny, nz, float(alpha))
    _build.check(status, POISSON)
    _build.count_launch(POISSON)
    return y


def poisson_scale(x: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor,
                  kz: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``alpha * x * h`` with the Poisson multiplier ``h = -1/k²`` of an
    (X, Y, Z) block ``x``: ``k² = (kx[i]² + ky[j]²) + kz[l]²`` from the
    vectors ``kx`` (X,), ``ky`` (Y,), ``kz`` (Z,), and ``h = 0`` where
    ``k² = 0``.  Complex64 on a CUDA tensor runs the kernel, anything
    else :func:`poisson_scale_plain`; the output is a new tensor."""
    if x.ndim != 3:
        raise ValueError(f"expected an (X, Y, Z) block, got {tuple(x.shape)}")
    nx, ny, nz = x.shape
    if (kx.shape, ky.shape, kz.shape) != ((nx,), (ny,), (nz,)):
        raise ValueError(f"expected kx ({nx},), ky ({ny},) and kz ({nz},), "
                         f"got {tuple(kx.shape)}, {tuple(ky.shape)} and "
                         f"{tuple(kz.shape)}")
    x = x.contiguous()
    if x.dtype == torch.complex64 and x.device.type == "cuda":
        return _poisson_launch(x, kx, ky, kz, alpha)
    return poisson_scale_plain(x, kx, ky, kz, alpha)


def poisson_scale_plain(x: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor,
                        kz: torch.Tensor, alpha: float = 1.0
                        ) -> torch.Tensor:
    """The Poisson kernel's function in plain tensor ops on an (X, Y, Z)
    ``x``, row block by row block of its (X Y, Z) rows: each block's
    ``k²`` and ``h`` as the expression the solve once built at full shape
    (``torch.where(k2 == 0, 0.0, -1.0 / torch.where(k2 == 0, 1.0, k2))``),
    then, complex64, :func:`spectral_scale_plain`'s arithmetic with ``h``
    real; another dtype ``x * h`` in x's dtype, then ``* alpha``."""
    nz = x.shape[-1]
    rows = x.reshape(-1, nz)
    kxy = ((kx * kx)[:, None] + (ky * ky)[None, :]).reshape(-1)
    kz2 = kz * kz
    y = torch.empty_like(rows)
    step = max(1, _PLAIN_ELEMS // max(1, nz))
    for r0 in range(0, rows.shape[0], step):
        k2 = kxy[r0:r0 + step, None] + kz2
        h = torch.where(k2 == 0, 0.0, -1.0 / torch.where(k2 == 0, 1.0, k2))
        xb = rows[r0:r0 + step]
        if x.dtype == torch.complex64:
            y[r0:r0 + step] = _scale_block(xb, h.to(torch.float32), 0.0,
                                           alpha)
        else:
            yb = xb * h.to(x.dtype)
            y[r0:r0 + step] = yb * alpha if alpha != 1.0 else yb
    return y.view(x.shape)


def spectral_scale(x: torch.Tensor, h: torch.Tensor,
                   alpha: float = 1.0) -> torch.Tensor:
    """Fused ``alpha * x * h`` on complex tensors (the schedule-epilogue
    op); ``h`` must broadcast against ``x``."""
    if x.dtype == torch.complex64 and h.shape == x.shape:
        n = x.shape[-1]
        y = spectral_scale_planes_full(x.contiguous().reshape(-1, n),
                                       h.contiguous().reshape(-1, n), alpha)
        return y.reshape(x.shape)
    y = x * h
    if alpha != 1.0:
        y = y * alpha
    return y
