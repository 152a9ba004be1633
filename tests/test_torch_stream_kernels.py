"""The streaming kernels' host-side rules and plain versions, on the CPU.

``rotate_blocks`` picks its CUDA kernel's vector width in Python
(``transpose_pack.rotate_path``: 16 or 8 bytes), and
the spectral scale allocates its output with its input's alignment; both
rules are held here.  The plain versions are held against the reference
Pallas kernels in interpret mode at the odd shapes the CUDA kernels treat
apart (odd runs, runs of one element, odd n, n = 1).  The kernels
themselves are held against the plain versions, to the bit, on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spectral_scale as ref_ss
from repro.kernels import transpose_pack as ref_tp
from repro_torch.kernels import spectral_scale
from repro_torch.kernels import transpose_pack as tp

SCALE_TOL = 1e-5    # tests/test_kernels_fft.py:68


def _cplx(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _rotate_oracle(x, outer, p, unit, shift, spm, dpm):
    """Destination block (o, i) = source block (o, (i + shift) % p), each
    side (outer, p, unit) or piece-major (p, outer, unit), in numpy."""
    src = x.reshape(p, outer, unit) if spm else x.reshape(outer, p, unit)
    out = np.empty((p, outer, unit) if dpm else (outer, p, unit), x.dtype)
    for o in range(outer):
        for i in range(p):
            j = (i + shift) % p
            block = src[j, o] if spm else src[o, j]
            if dpm:
                out[i, o] = block
            else:
                out[o, i] = block
    return out.reshape(-1)


# (unit, src address, dst address) -> vector bytes: odd runs or an 8-byte
# aligned base take 8-byte vectors, the rest 16-byte vectors, at any run
# length
PATH_CASES = [
    (1, 0, 0, tp.VEC8), (3, 0, 0, tp.VEC8), (129, 256, 512, tp.VEC8),
    (2, 0, 0, tp.VEC16), (16, 512, 4096, tp.VEC16), (126, 0, 0, tp.VEC16),
    (128, 0, 0, tp.VEC16), (1024, 512, 1024, tp.VEC16),
    (1 << 27, 0, 0, tp.VEC16),
    (128, 8, 0, tp.VEC8), (128, 0, 24, tp.VEC8), (2, 520, 0, tp.VEC8),
]


@pytest.mark.parametrize("p", [1, 2, 3, 8])
@pytest.mark.parametrize("spm", [False, True])
@pytest.mark.parametrize("dpm", [False, True])
def test_rotate_path_and_plain_rotation(p, spm, dpm):
    """The width depends on the run length and the bases alone; the plain
    rotation it is held against on the card is right for every P, shift
    and layout, at runs of 1, an odd length and an even one."""
    for unit, src, dst, path in PATH_CASES:
        assert tp.rotate_path(unit, src, dst) == path, (unit, src, dst)
    for outer, unit in ((3, 1), (2, 7), (2, 128)):
        x = _cplx((outer * p * unit,), seed=unit + p)
        for shift in range(-1, p + 1):
            got = tp.rotate_block_rows(torch.from_numpy(x), outer, p, unit,
                                       shift, spm, dpm)
            np.testing.assert_array_equal(
                got.numpy(), _rotate_oracle(x, outer, p, unit, shift % p,
                                            spm, dpm))


@pytest.mark.parametrize("shape,axis,p", [((3, 8, 1), 1, 8),    # unit 1
                                          ((2, 6, 7), 1, 3),    # unit 14
                                          ((5, 9, 1), 1, 3),    # unit 3
                                          ((7, 3), 0, 7)])      # unit 3
@pytest.mark.parametrize("shift", [1, 2, -1])
def test_rotate_blocks_odd_runs_match_reference(shape, axis, p, shift):
    x = _cplx(shape, seed=p)
    got = tp.rotate_blocks(torch.from_numpy(x), axis, shift, p).numpy()
    kernel = np.asarray(ref_tp.rotate_blocks(jnp.asarray(x), axis, shift, p,
                                             use_pallas=True, interpret=True))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(
        got, np.asarray(ref_tp.rotate_blocks(jnp.asarray(x), axis, shift, p,
                                             use_pallas=False)))


@pytest.mark.parametrize("rows,n", [(7, 1), (5, 3), (3, 513), (1, 1)])
@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_spectral_scale_odd_n_matches_reference(rows, n, alpha):
    x = _cplx((rows, n), seed=n)
    hb = _cplx((n,), seed=n + 1)
    hf = _cplx((rows, n), seed=n + 2)
    planes = lambda a: (jnp.asarray(a.real), jnp.asarray(a.imag))
    for h, ref_fn, fn in (
            (hb, ref_ss.spectral_scale_planes,
             spectral_scale.spectral_scale_planes),
            (hf, ref_ss.spectral_scale_planes_full,
             spectral_scale.spectral_scale_planes_full)):
        yr, yi = ref_fn(*planes(x), *planes(h), alpha, interpret=True)
        want = np.asarray(yr) + 1j * np.asarray(yi)
        got = fn(torch.from_numpy(x), torch.from_numpy(h), alpha).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=SCALE_TOL * np.abs(want).max())


def test_spectral_scale_output_keeps_the_input_alignment():
    """The kernel's 16-byte vectors need x and y at one address mod 16:
    an input one element in gets an output one element in."""
    buf = torch.zeros(65, dtype=torch.complex64)
    for x in (buf[:64].view(8, 8), buf[1:].view(8, 8)):
        y = spectral_scale._like_aligned(x)
        assert y.shape == x.shape and y.is_contiguous()
        assert y.data_ptr() % 16 == x.data_ptr() % 16
