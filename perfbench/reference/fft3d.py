"""Plain 3-D DFT, its inverse, and the spectral Poisson solve.

Every axis is one dense DFT product, computed from first principles:
``W[k, j] = exp(sign * 2*pi*i * k*j / n)``, its phase taken from
``k*j mod n`` in integers and float64 before the float32 cast.  No FFT
routine of any library is called.  A complex product runs as one real
matrix product on the interleaved (re, im) view, so that the precision of
the products is the precision of ``torch.matmul`` and nothing else.

The field arrives in x-slabs from a ``source(x0, x1)`` callable (complex
or real planes ``[x0, x1)``, all of y and z), so a transform of a field
that does not fit beside the program's outputs is computed slab by slab:
z, then y, then the x sum accumulated over the slabs.  Only the output
indices asked for are computed.

Precision: ``"fp32"`` is float32 with TF32 off, the precision the
configurations state; ``"tf32"`` is the step below it, used as the
control: TF32 products on the card, and on the CPU (which has no TF32)
products whose operands are rounded to TF32's 10-bit mantissa first.

Layouts: :func:`layout_block` works out which global block a rank holds
in a layout, from the decomposition and the mesh that the configuration
states, with ranks laid out row-major over the mesh axes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch

PRECISIONS = ("fp32", "tf32")
SLAB_BYTES = 1 << 30            # complex planes handed over at a time


class Arith:
    """Matrix products in one precision on one device."""

    def __init__(self, precision: str, device: torch.device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self._round = self.tf32 and self.device.type != "cuda"

    def _op(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self._round else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._op(a), self._op(b))

    def addmm_(self, out: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> None:
        out.addmm_(self._op(a), self._op(b))

    @contextlib.contextmanager
    def active(self):
        """Set the card's TF32 switch for the products inside, and put
        back what was there."""
        if self.device.type != "cuda":
            yield
            return
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest with TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def dft_rows(n: int, rows: slice, sign: int,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary parts of rows ``rows`` of the n-point DFT
    matrix ``exp(sign * 2*pi*i * k*j / n)``, as float32 (K, n)."""
    k = torch.arange(rows.start, rows.stop, dtype=torch.int64, device=device)
    j = torch.arange(n, dtype=torch.int64, device=device)
    phase = torch.remainder(k[:, None] * j[None, :], n).to(torch.float64)
    ang = phase * (sign * 2.0 * math.pi / n)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _right_matrix(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """The real (2n, 2K) matrix that applies W (K, n) along the last
    axis of an interleaved (re, im) row."""
    k, n = wr.shape
    m = torch.empty(2 * n, 2 * k, dtype=torch.float32, device=wr.device)
    m[0::2, 0::2] = wr.T
    m[0::2, 1::2] = wi.T
    m[1::2, 0::2] = -wi.T
    m[1::2, 1::2] = wr.T
    return m


def _last_axis(x: torch.Tensor, m: torch.Tensor, arith: Arith) -> torch.Tensor:
    """W applied along the last axis of complex ``x`` (..., n)."""
    out = arith.mm(torch.view_as_real(x.contiguous()).reshape(-1, m.shape[0]),
                   m)
    return torch.view_as_complex(out.view(*x.shape[:-1], m.shape[1] // 2, 2))


def _left_operand(b: torch.Tensor) -> torch.Tensor:
    """Complex (..., n, M) as the real (..., 2n, 2M) operand [b; i*b]:
    ``[Wr Wi] @ [b; i*b]`` is ``W @ b`` in interleaved (re, im) form."""
    re = torch.view_as_real(b.contiguous()).flatten(-2)
    im = torch.view_as_real(b * 1j).flatten(-2)
    return torch.cat([re, im], dim=-2)


def slab_planes(ny: int, nz: int) -> int:
    return max(1, SLAB_BYTES // (ny * nz * 8))


def transform(source: Callable, shape: Sequence[int], out: Sequence[slice],
              sign: int, arith: Arith,
              planes: Optional[int] = None) -> torch.Tensor:
    """The 3-D DFT (``sign`` -1: unnormalized forward; +1: inverse, with
    1/(Nx Ny Nz)) of the global field of ``shape`` that ``source(x0,
    x1)`` hands over in x-slabs, at the output indices ``out`` (one slice
    a dim).  Returns the complex64 block."""
    nx, ny, nz = shape
    sx, sy, sz = (slice(*s.indices(n)[:2]) for s, n in zip(out, shape))
    kx, ky, kz = sx.stop - sx.start, sy.stop - sy.start, sz.stop - sz.start
    dev = arith.device
    mz = _right_matrix(*dft_rows(nz, sz, sign, dev))
    ay = torch.cat(dft_rows(ny, sy, sign, dev), dim=1)
    wxr, wxi = dft_rows(nx, sx, sign, dev)
    acc = torch.zeros(kx, ky, kz, dtype=torch.complex64, device=dev)
    acc_r = torch.view_as_real(acc).view(kx, 2 * ky * kz)
    step = planes or slab_planes(ny, nz)
    with arith.active():
        for x0 in range(0, nx, step):
            x1 = min(nx, x0 + step)
            a = source(x0, x1).to(device=dev, dtype=torch.complex64)
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


def wavenumbers(n: int, box: float, device) -> torch.Tensor:
    """Angular wavenumbers of an n-point periodic axis of length ``box``,
    in the DFT's index order: 0, 1, ..., then the negative ones."""
    j = torch.arange(n, dtype=torch.float64, device=device)
    j = torch.where(j < (n + 1) // 2, j, j - n)
    return j * (2.0 * math.pi / box)


def poisson(source: Callable, shape: Sequence[int], arith: Arith,
            box: float) -> torch.Tensor:
    """u with ``laplacian(u) = f`` on the periodic box of side ``box``,
    the mean mode set to 0: ``u = IDFT(-DFT(f) / |k|^2)``, with the
    whole field on this device.  Returns u as the real part of a complex
    field (a strided view)."""
    full = tuple(slice(0, n) for n in shape)
    f_hat = transform(source, shape, full, -1, arith)
    ky = wavenumbers(shape[1], box, arith.device)
    kz = wavenumbers(shape[2], box, arith.device)
    kyz = ky[:, None] ** 2 + kz[None, :] ** 2
    kx = wavenumbers(shape[0], box, arith.device)
    for i in range(shape[0]):
        k2 = kx[i] ** 2 + kyz
        m = torch.where(k2 == 0, 0.0, -1.0 / torch.where(k2 == 0, 1.0, k2))
        f_hat[i] *= m.to(torch.float32)
    u = transform(lambda a, b: f_hat[a:b], shape, full, +1, arith)
    del f_hat
    return u.real


def _spec(decomposition: Optional[dict], layout: str) -> tuple:
    if decomposition is None:
        return (None, None, None)
    kind, axes = decomposition["kind"], tuple(decomposition["axes"])
    if kind == "pencil":
        ay, az = axes
        return (None, ay, az) if layout == "natural" else (ay, az, None)
    if kind == "slab":
        (az,) = axes
        return (None, None, az) if layout == "natural" else (az, None, None)
    raise ValueError(f"no layout rule for a {kind} decomposition")


def layout_block(shape: Sequence[int], decomposition: Optional[dict],
                 mesh: Optional[dict], rank: int, layout: str) -> tuple:
    """The global block (a slice a dim) that ``rank`` holds in ``layout``
    ("natural": x-pencils; "spectral": z-pencils), the ranks laid out
    row-major over ``mesh["axes"]``.  The whole grid without a mesh."""
    if mesh is None:
        return tuple(slice(0, n) for n in shape)
    sizes = dict(zip(mesh["axes"], mesh["shape"]))
    coords, r = {}, rank
    for axis, size in reversed(list(zip(mesh["axes"], mesh["shape"]))):
        coords[axis] = r % size
        r //= size
    out = []
    for axis, n in zip(_spec(decomposition, layout), shape):
        if axis is None:
            out.append(slice(0, n))
            continue
        ext = n // sizes[axis]
        out.append(slice(coords[axis] * ext, (coords[axis] + 1) * ext))
    return tuple(out)
