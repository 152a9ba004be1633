"""FFT plans: precomputed DFT matrices and twiddle factors.

Port of ``repro/core/plan.py``.  CROFT's "option 2/4 — single FFTW3 plan"
amortizes plan creation across all 1-D transforms.  Here the plan is the
set of *constants* a transform needs — DFT matrices for the four-step
(Bailey) factorization and twiddle factors — plus the static
factorization decision itself.  A cached :class:`FFTPlan` keeps these as
device tensors (planned once, reused for every 1-D FFT of the 3-D
transform); ``plan_cache=False`` reproduces CROFT's "multiple plans"
options 1/3 by rebuilding the constants with tensor ops on every call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import has_values

# Largest DFT applied as a single matmul (the radix of the four-step split).
MAX_RADIX = 64
# Largest 1-D size handled by a single two-level four-step plan (the
# kernel path).  Larger sizes recurse (six-step) on the matmul path.
MAX_TWO_LEVEL = MAX_RADIX * MAX_RADIX


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def split_factors(n: int, max_radix: int = MAX_RADIX) -> tuple[int, int]:
    """Balanced n = n1 * n2 split with n1 <= max_radix, n1 >= n2 bias.

    Power-of-two sizes only (the paper's own restriction: N = 2^n).
    """
    if not _is_pow2(n):
        raise ValueError(f"CROFT requires power-of-two sizes, got {n}")
    if n <= max_radix:
        return n, 1
    p = int(math.log2(n))
    p1 = min(int(math.log2(max_radix)), (p + 1) // 2)
    # bias n1 up to max_radix so the first DFT stays as wide as allowed
    p1 = min(int(math.log2(max_radix)), max(p1, p - int(math.log2(max_radix))))
    # ensure n2 = n / n1 also recursable
    return 2 ** p1, 2 ** (p - p1)


def dft_matrix(n: int, sign: int, dtype=np.complex64) -> np.ndarray:
    """Dense DFT matrix W[j, k] = exp(sign * 2πi * j * k / n)."""
    jk = np.outer(np.arange(n), np.arange(n))
    return np.exp(sign * 2j * np.pi * jk / n).astype(dtype)


def twiddle_matrix(n1: int, n2: int, sign: int, dtype=np.complex64) -> np.ndarray:
    """Four-step inter-stage twiddles T[n2, k1] = exp(sign*2πi*k1*n2/(n1*n2)).

    Laid out (n2, k1) to match the post-stage-1 operand layout.
    """
    k1 = np.arange(n1)
    j2 = np.arange(n2)
    return np.exp(sign * 2j * np.pi * np.outer(j2, k1) / (n1 * n2)).astype(dtype)


def stacked_real(w: np.ndarray) -> np.ndarray:
    """Complex (n, n) matrix -> stacked-real (2n, 2n) for one-dot complex matmul.

    [xr xi] @ [[Wr, Wi], [-Wi, Wr]] == [Re(x@W), Im(x@W)].
    """
    wr, wi = w.real.astype(np.float32), w.imag.astype(np.float32)
    top = np.concatenate([wr, wi], axis=1)
    bot = np.concatenate([-wi, wr], axis=1)
    return np.concatenate([top, bot], axis=0)


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Plan for a 1-D FFT of power-of-two size ``n`` (four-step factorized).

    Holds numpy constants; :meth:`constants_torch` hands them out as
    device tensors (cached per device) or rebuilds them with tensor ops
    when the plan cache is disabled.
    """

    n: int
    n1: int
    n2: int
    sign: int  # -1 forward, +1 inverse
    dtype: np.dtype
    w1: np.ndarray  # (n1, n1) complex DFT matrix
    w2: Optional[np.ndarray]  # (n2, n2) or None when n2 == 1
    tw: Optional[np.ndarray]  # (n2, n1) twiddles or None when n2 == 1
    w1_stacked: np.ndarray  # (2*n1, 2*n1) float32
    w2_stacked: Optional[np.ndarray]
    # device tensors of (w1, w2, tw), filled per device on first use
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    @property
    def two_level(self) -> bool:
        return self.n2 <= MAX_RADIX

    def constants_torch(self, device, rematerialize: bool = False):
        """Return (w1, w2, tw) as complex tensors on ``device``.

        The planned path returns tensors cached per ``(n, sign, dtype,
        device)``.  With ``rematerialize=True`` ("multiple plans" mode,
        CROFT options 1/3) the constants are recomputed with tensor ops
        on every call instead.
        """
        device = torch.device(device)
        if not rematerialize:
            consts = self._on_device.get(device)
            if consts is None:
                consts = tuple(None if a is None
                               else torch.from_numpy(a).to(device)
                               for a in (self.w1, self.w2, self.tw))
                if has_values(consts[0]):
                    self._on_device[device] = consts
            return consts
        cdtype = _torch_dtype(self.dtype)
        sign = self.sign

        def _dft(n):
            j = torch.arange(n, dtype=torch.float32, device=device)
            ang = (sign * 2.0 * math.pi / n) * torch.outer(j, j)
            return torch.complex(torch.cos(ang), torch.sin(ang)).to(cdtype)

        w1 = _dft(self.n1)
        w2 = _dft(self.n2) if self.n2 > 1 else None
        if self.n2 > 1:
            k1 = torch.arange(self.n1, dtype=torch.float32, device=device)
            j2 = torch.arange(self.n2, dtype=torch.float32, device=device)
            ang = (sign * 2.0 * math.pi / self.n) * torch.outer(j2, k1)
            tw = torch.complex(torch.cos(ang), torch.sin(ang)).to(cdtype)
        else:
            tw = None
        return w1, w2, tw

    def folded_torch(self, device, rematerialize: bool = False):
        """The first stage's DFT with the twiddles folded in, as
        ``(n2, n1, n1)`` complex: ``H[j2] = diag(T[j2, :]) @ w1``, i.e.
        ``H[j2, k1, j1] = exp(sign*2πi*k1*(n2*j1 + j2)/n)``, for an axis
        whose first stage can batch over ``j2``.  Cached per device like
        :meth:`constants_torch`; rebuilt with tensor ops on every call
        with ``rematerialize=True``."""
        device = torch.device(device)
        n, n1, n2 = self.n, self.n1, self.n2
        if not rematerialize:
            key = ("fold", device)
            h = self._on_device.get(key)
            if h is None:
                j2, k1, j1 = np.ogrid[:n2, :n1, :n1]
                e = (k1 * (n2 * j1 + j2)) % n
                h = torch.from_numpy(np.exp(self.sign * 2j * np.pi * e / n)
                                     .astype(self.dtype)).to(device)
                if has_values(h):
                    self._on_device[key] = h
            return h
        j2, k1, j1 = (torch.arange(m, device=device) for m in (n2, n1, n1))
        e = (k1[None, :, None] * (n2 * j1[None, None, :] + j2[:, None, None])
             ) % n
        ang = (self.sign * 2.0 * math.pi / n) * e.to(torch.float32)
        return torch.complex(torch.cos(ang), torch.sin(ang)).to(
            _torch_dtype(self.dtype))

    def twiddles_t_torch(self, device) -> torch.Tensor:
        """The (n2, n1) twiddle table transposed to (n1, n2) on the host,
        as the Hopper kernel reads it, on ``device`` (cached)."""
        key = ("tw_t", torch.device(device))
        tw_t = self._on_device.get(key)
        if tw_t is None:
            tw_t = torch.from_numpy(np.ascontiguousarray(self.tw.T)).to(device)
            if has_values(tw_t):
                self._on_device[key] = tw_t
        return tw_t


def _torch_dtype(dtype) -> torch.dtype:
    return {np.dtype("complex64"): torch.complex64,
            np.dtype("complex128"): torch.complex128}[np.dtype(dtype)]


@functools.lru_cache(maxsize=256)
def make_plan(n: int, sign: int = -1, dtype_name: str = "complex64",
              max_radix: int = MAX_RADIX) -> FFTPlan:
    """The cached planner — CROFT's "single plan" path."""
    dtype = np.dtype(dtype_name)
    n1, n2 = split_factors(n, max_radix)
    w1 = dft_matrix(n1, sign, dtype)
    if n2 > 1:
        # w2 used only on the two-level path; recursion re-plans for n2>MAX
        w2 = dft_matrix(n2, sign, dtype) if n2 <= max_radix else None
        tw = twiddle_matrix(n1, n2, sign, dtype)
    else:
        w2, tw = None, None
    return FFTPlan(
        n=n, n1=n1, n2=n2, sign=sign, dtype=dtype,
        w1=w1, w2=w2, tw=tw,
        w1_stacked=stacked_real(w1),
        w2_stacked=None if w2 is None else stacked_real(w2),
    )


def plan_cache_info():
    return make_plan.cache_info()


def clear_plan_cache():
    make_plan.cache_clear()
