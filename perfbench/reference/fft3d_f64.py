"""Plain 3-D DFT and its inverse in double precision: the reference of a
configuration that states complex128.

The interface and the slab-wise structure are ``fft3d.py``'s (``Arith``,
``spectrum``, ``transform``, ``layout_block``; its layout rule and its
two dtype-free helpers are shared).  Every axis is one dense DFT
product, computed from first principles: ``W[k, j] = exp(sign * 2*pi*i
* k*j / n)``, its phase taken from ``k*j mod n`` in integers and
float64.  No FFT routine of any library is called.  A complex product
runs as one real matrix product on the interleaved (re, im) view, so
that the precision of the products is the precision of ``torch.matmul``
on the real dtype and nothing else.  The field arrives in x-slabs from a
``source(x0, x1)`` callable: z, then y, then the x sum accumulated over
the slabs, sized for 16-byte elements.

Precision.  The harness (``check.numbers``) and the control
(``control.py``) name precisions in the float32 reference's words, so
here ``"fp32"`` is the precision the configuration states, float64
products (complex128 answers), and ``"tf32"`` the step below it, used as
the control: float32 products with TF32 off (complex64 answers).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch

from perfbench.reference.fft3d import _last_axis, _left_operand
from perfbench.reference.fft3d import layout_block  # noqa: F401

PRECISIONS = ("fp32", "tf32")
SLAB_BYTES = 1 << 30            # complex planes handed over at a time


class Arith:
    """Matrix products in one precision on one device: float64 for
    ``"fp32"``, float32 with TF32 off for ``"tf32"``."""

    def __init__(self, precision: str, device: torch.device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.device = torch.device(device)
        lower = precision == "tf32"
        self.real = torch.float32 if lower else torch.float64
        self.complex = torch.complex64 if lower else torch.complex128

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)

    def addmm_(self, out: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> None:
        out.addmm_(a, b)

    @contextlib.contextmanager
    def active(self):
        """Turn the card's TF32 switch off for the products inside, and
        put back what was there."""
        if self.device.type != "cuda":
            yield
            return
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def dft_rows(n: int, rows: slice, sign: int,
             arith: Arith) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary parts of rows ``rows`` of the n-point DFT
    matrix ``exp(sign * 2*pi*i * k*j / n)``, (K, n) in the real dtype."""
    dev = arith.device
    k = torch.arange(rows.start, rows.stop, dtype=torch.int64, device=dev)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    phase = torch.remainder(k[:, None] * j[None, :], n).to(torch.float64)
    ang = phase * (sign * 2.0 * math.pi / n)
    return torch.cos(ang).to(arith.real), torch.sin(ang).to(arith.real)


def _right_matrix(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """The real (2n, 2K) matrix that applies W (K, n) along the last
    axis of an interleaved (re, im) row."""
    k, n = wr.shape
    m = torch.empty(2 * n, 2 * k, dtype=wr.dtype, device=wr.device)
    m[0::2, 0::2] = wr.T
    m[0::2, 1::2] = wi.T
    m[1::2, 0::2] = -wi.T
    m[1::2, 1::2] = wr.T
    return m


def slab_planes(ny: int, nz: int) -> int:
    return max(1, SLAB_BYTES // (ny * nz * 16))


def transform(source: Callable, shape: Sequence[int], out: Sequence[slice],
              sign: int, arith: Arith,
              planes: Optional[int] = None) -> torch.Tensor:
    """The 3-D DFT (``sign`` -1: unnormalized forward; +1: inverse, with
    1/(Nx Ny Nz)) of the global field of ``shape`` that ``source(x0,
    x1)`` hands over in x-slabs, at the output indices ``out`` (one slice
    a dim).  Returns the block in ``arith``'s complex dtype."""
    nx, ny, nz = shape
    sx, sy, sz = (slice(*s.indices(n)[:2]) for s, n in zip(out, shape))
    kx, ky, kz = sx.stop - sx.start, sy.stop - sy.start, sz.stop - sz.start
    dev = arith.device
    mz = _right_matrix(*dft_rows(nz, sz, sign, arith))
    ay = torch.cat(dft_rows(ny, sy, sign, arith), dim=1)
    wxr, wxi = dft_rows(nx, sx, sign, arith)
    acc = torch.zeros(kx, ky, kz, dtype=arith.complex, device=dev)
    acc_r = torch.view_as_real(acc).view(kx, 2 * ky * kz)
    step = planes or slab_planes(ny, nz)
    with arith.active():
        for x0 in range(0, nx, step):
            x1 = min(nx, x0 + step)
            a = source(x0, x1).to(device=dev, dtype=arith.complex)
            a = _last_axis(a, mz, arith)                     # (S, ny, kz)
            a = arith.mm(ay, _left_operand(a))               # (S, ky, 2kz)
            a = torch.view_as_complex(a.view(x1 - x0, ky, kz, 2))
            ax = torch.cat([wxr[:, x0:x1], wxi[:, x0:x1]], dim=1)
            arith.addmm_(acc_r, ax, _left_operand(a.reshape(x1 - x0, -1)))
            del a
    if sign > 0:
        acc /= nx * ny * nz
    return acc


def spectrum(source: Callable, shape: Sequence[int], out: Sequence[slice],
             arith: Arith) -> torch.Tensor:
    """The forward transform's block ``out``."""
    return transform(source, shape, out, -1, arith)
