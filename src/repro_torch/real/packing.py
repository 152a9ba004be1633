"""Two-for-one pack/unpack primitives for real 3-D transforms.

Port of ``repro/real/packing.py``.  Two real sequences a, b of length n
cost ONE complex FFT.  Pack c = a + i*b, transform C = FFT(c), and split
with Hermitian symmetry:

    A[k] = (C[k] + conj(C[-k mod n])) / 2
    B[k] = (C[k] - conj(C[-k mod n])) / (2i)
    C[k] = A[k] + i*B[k]                      (the exact inverse)

The two sequences are two real z-pencils of the local block, paired
along a local axis, so the pipeline runs half as many z transforms and
every later stage moves half the bytes.

For even n the half spectrum is carried in the packed ("halfcomplex")
layout: the DC and Nyquist bins of a real transform are real, so the
Nyquist value rides in the imaginary slot of bin 0 and the spectrum is
exactly n/2 complex bins — shard-aligned through the y/x transposes.  The
folded bin is unfolded once, at the end, by one (Nx, Ny)-plane Hermitian
reconstruction (``pipeline.unfold_dc_plane``).

The spectrum axis is always the last axis and the pair axis an explicit
(batch-offset) index, so leading batch axes ride through every function.
``use_pallas=True`` (the ``"pallas"`` local impl) sends the folded
unpack and Hermitian extend of complex64 blocks to the Hopper kernels of
``repro_torch.kernels.hermitian`` — on a CPU tensor, to their plain
versions.  Each primitive is one ``real:<name>`` span
(``repro_torch.obs.tracer.span``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.tracer import span


def complex_dtype_for(real_dtype) -> torch.dtype:
    """Spectrum dtype for a real input dtype (f32 -> c64, f64 -> c128)."""
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def real_dtype_for(complex_dtype) -> torch.dtype:
    return torch.float64 if complex_dtype == torch.complex128 else torch.float32


def negate_freq(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Index map k -> (-k) mod N along ``axis``: [0, N-1, N-2, ..., 1]."""
    return torch.roll(torch.flip(a, [axis]), 1, axis)


def pack_two(x: torch.Tensor, pair_axis: int) -> torch.Tensor:
    """Real block -> complex block, halved along ``pair_axis``: the first
    half becomes the real part, the second half the imaginary part
    (contiguous halves, so the unpacked spectra land back at their
    original positions)."""
    with span("real:pack_two", "pack", x.device):
        m = x.shape[pair_axis]
        if m % 2:
            raise ValueError(f"pair axis extent {m} must be even to pack "
                             "two-for-one")
        a = x.narrow(pair_axis, 0, m // 2)
        b = x.narrow(pair_axis, m // 2, m // 2)
        return torch.complex(a, b)


def unpack_two(C: torch.Tensor, pair_axis: int, *, nh: Optional[int] = None,
               fold: bool = False, use_pallas: bool = False) -> torch.Tensor:
    """Split the FFT of a packed block into the two half spectra.

    ``C`` is the z-transform of ``pack_two(x)``; the result restores the
    original extent along ``pair_axis`` with the A spectra in the first
    half and the B spectra in the second (mirroring ``pack_two``).

    fold=False  keep ``nh`` bins per spectrum (n//2 + 1; works for odd n)
    fold=True   even n only: keep n//2 bins with the (real) Nyquist bin
                folded into the imaginary slot of the (real) DC bin —
                the shard-aligned layout the distributed pipeline carries.
    """
    with span("real:unpack_two", "unpack"):
        n = C.shape[-1]
        if fold:
            if n % 2:
                raise ValueError("fold=True needs an even transform size")
            if use_pallas and C.dtype == torch.complex64:
                from repro_torch.kernels import hermitian
                # a K-chunk of a strided stage arrives as a view: the kernel
                # takes it contiguous
                return hermitian.unpack_two_for_one(C.contiguous(),
                                                    pair_axis % C.ndim)
        rev = torch.conj(negate_freq(C, -1))
        A = 0.5 * (C + rev)
        B = -0.5j * (C - rev)
        if fold:
            nz2 = n // 2

            def folded(S):
                # DC and Nyquist of a real transform are real; stash Nyquist
                # in DC's imaginary slot -> exactly nz2 bins, no bin lost
                s0 = torch.complex(S[..., 0].real, S[..., nz2].real)
                return torch.cat([s0[..., None], S[..., 1:nz2]], dim=-1)

            A, B = folded(A), folded(B)
        else:
            if nh is None:
                nh = n // 2 + 1
            A, B = A[..., :nh], B[..., :nh]
        return torch.cat([A, B], dim=pair_axis)


def repack_halves(S: torch.Tensor, pair_axis: int, nz: int, *,
                  folded: bool = False,
                  use_pallas: bool = False) -> torch.Tensor:
    """Inverse of :func:`unpack_two`: rebuild the full packed z-spectrum
    C[k] = A[k] + i*B[k], C[nz-k] = conj(A[k] - i*B[k]) from the two half
    spectra stacked along ``pair_axis``, ready for one complex inverse
    FFT whose real/imaginary parts are the two real pencils."""
    with span("real:repack_halves", "pack"):
        m = S.shape[pair_axis]
        if folded and use_pallas and S.dtype == torch.complex64:
            from repro_torch.kernels import hermitian
            return hermitian.hermitian_extend(S.contiguous(),
                                              pair_axis % S.ndim, nz)
        SA = S.narrow(pair_axis, 0, m // 2)
        SB = S.narrow(pair_axis, m // 2, m - m // 2)
        if folded:
            # bin 0 carries (DC, Nyquist) of each spectrum in (real, imag)
            a0, b0 = SA[..., 0], SB[..., 0]
            c0 = torch.complex(a0.real, b0.real)              # A[0] + i B[0]
            cn = torch.complex(a0.imag, b0.imag)              # A[ny] + i B[ny]
            body = SA[..., 1:] + 1j * SB[..., 1:]             # bins 1..nz/2-1
            tail = torch.flip(torch.conj(SA[..., 1:] - 1j * SB[..., 1:]),
                              [-1])
            return torch.cat([c0[..., None], body, cn[..., None], tail],
                             dim=-1)
        # DC (and, for even nz, Nyquist) bins of a real transform are real;
        # keep only their real parts — numpy's irfft applies exactly this
        # projection, and it is the identity for valid real-field spectra.
        nh = SA.shape[-1]
        c0 = torch.complex(SA[..., 0].real, SB[..., 0].real)
        parts = [c0[..., None]]
        has_nyq = nz % 2 == 0 and nh - 1 == nz // 2
        body_hi = nh - 1 if has_nyq else nh
        parts.append(SA[..., 1:body_hi] + 1j * SB[..., 1:body_hi])
        if has_nyq:
            cn = torch.complex(SA[..., -1].real, SB[..., -1].real)
            parts.append(cn[..., None])
        ntail = nz - nh
        t = SA[..., 1:1 + ntail] - 1j * SB[..., 1:1 + ntail]
        parts.append(torch.flip(torch.conj(t), [-1]))
        return torch.cat(parts, dim=-1)


def split_pairs(c: torch.Tensor, pair_axis: int) -> torch.Tensor:
    """Complex block -> real block, doubled along ``pair_axis`` (inverse
    of :func:`pack_two`: real parts first, imaginary parts second)."""
    with span("real:split_pairs", "unpack", c.device):
        return torch.cat([c.real, c.imag], dim=pair_axis)
