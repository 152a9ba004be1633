"""The port's kernels (``repro_torch.kernels``): the plain versions against
the reference Pallas kernels (interpret mode) and their jnp forms.  The
Hopper kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import fft_matmul_1d as ref_fft_matmul_1d
from repro.kernels import transpose_pack as ref_tp
from repro.kernels.fft_matmul import fft4step_planes
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import fft_matmul, fft_matmul_1d, ref
from repro_torch.kernels import transpose_pack as tp

KERNEL_TOL = 3e-4   # tests/test_kernels_fft.py:18


def _field(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [1, 2, 16, 64, 128, 256, 1024, 4096])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fft4step_plain_matches_pallas(n, sign):
    x = _field((3, n), seed=n)
    yr, yi = fft4step_planes(jnp.asarray(x.real), jnp.asarray(x.imag), sign,
                             interpret=True)
    want = np.asarray(yr) + 1j * np.asarray(yi)
    got = fft_matmul.fft4step(torch.from_numpy(x), sign).numpy()
    atol = KERNEL_TOL * max(1, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, ref.ref_fft_1d_naive(x, sign), atol=atol)


def test_fft4step_too_large_raises():
    n = plan_lib.MAX_TWO_LEVEL * 2
    with pytest.raises(ValueError, match="two-level kernel limit"):
        fft_matmul.fft4step(torch.zeros(1, n, dtype=torch.complex64))
    with pytest.raises(ValueError):
        fft4step_planes(jnp.zeros((1, n), jnp.float32),
                        jnp.zeros((1, n), jnp.float32))


def test_fft_matmul_1d_matches_reference():
    x = _field((2, 5, 128), seed=3)
    got = fft_matmul_1d(torch.from_numpy(x), device="cpu").numpy()
    want = np.asarray(ref_fft_matmul_1d(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=KERNEL_TOL * np.abs(want).max())
    inv = ref.ref_fft_1d(torch.from_numpy(x), +1).numpy()
    np.testing.assert_allclose(
        fft_matmul_1d(torch.from_numpy(x), +1, device="cpu").numpy(), inv,
        atol=KERNEL_TOL * np.abs(inv).max())


# --- pack/unpack: the cases of tests/test_schedule.py:455-493, bitwise ------

X = _field((4, 24, 5), seed=0)
P = 8


@pytest.mark.parametrize("shift", [0, 1, 3, -2, 11])
def test_rotate_blocks_matches_reference(shift):
    got = tp.rotate_blocks(torch.from_numpy(X), 1, shift, P).numpy()
    want = np.asarray(ref_tp.rotate_blocks(jnp.asarray(X), 1, shift, P,
                                           use_pallas=False))
    np.testing.assert_array_equal(got, want)
    kernel = np.asarray(ref_tp.rotate_blocks(jnp.asarray(X), 1, shift, P,
                                             use_pallas=True, interpret=True))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, np.roll(X, -(shift % P) * 3, axis=1))


@pytest.mark.parametrize("idx", [0, 2, 7])
def test_pack_unpack_match_reference(idx):
    pieces = tp.pack_pieces(torch.from_numpy(X), 1, idx, P)
    want = ref_tp.pack_pieces(jnp.asarray(X), 1, idx, P, use_pallas=False)
    assert len(pieces) == len(want) == P
    for ours, theirs in zip(pieces, want):
        assert ours.is_contiguous()
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # unpack: result block i = pieces[(i + shift) % p]
    got = tp.unpack_pieces(torch.stack(pieces), 1, -idx).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_tp.unpack_pieces(want, 1, -idx, use_pallas=False)))
    np.testing.assert_array_equal(got, X)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pack_unpack_every_axis(axis):
    x = _field((4, 6, 8), seed=axis)
    p = 2
    for idx in range(p):
        pieces = tp.pack_pieces(torch.from_numpy(x), axis, idx, p)
        want = ref_tp.pack_pieces(jnp.asarray(x), axis, idx, p,
                                  use_pallas=False)
        for ours, theirs in zip(pieces, want):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        back = tp.unpack_pieces(torch.stack(pieces), axis, -idx).numpy()
        np.testing.assert_array_equal(back, x)


def test_rotate_blocks_indivisible_raises():
    with pytest.raises(ValueError, match="not divisible"):
        tp.rotate_blocks(torch.from_numpy(X), 1, 1, 7)  # 24 % 7 != 0
    with pytest.raises(ValueError):
        ref_tp.rotate_blocks(jnp.asarray(X), 1, 1, 7)
