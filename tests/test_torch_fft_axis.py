"""The axis form of the four-step FFT kernel's plain version, and
``fft_1d(..., impl="pallas")``, against the JAX package on the CPU.

``repro_torch.kernels.fft_matmul.fft4step_axis`` transforms any axis of a
tensor where it lies; on the card the kernel reads a contiguous
(outer, N, inner) view (``tests/test_torch_cuda_kernels.py`` holds it
against :func:`fft4step_axis_plain` there).  Here, on CPU tensors, the
same numpy inputs go through the reference's Pallas kernel
``fft4step_planes`` in interpret mode (the axis moved last, as its own
tests run it) and ``repro.core.local_fft.fft_1d(impl="pallas")``, held
at ``3e-4·max|ref|`` (``tests/test_kernels_fft.py:18``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import local_fft as ref_local_fft
from repro.kernels.fft_matmul import fft4step_planes
from repro_torch.core import fft3d_local, fft_1d
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import fft_matmul

KERNEL_TOL = 3e-4   # tests/test_kernels_fft.py:18
FFT3_TOL = 5e-4     # tests/test_kernels_fft.py:78


def _field(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _pallas_along(x: np.ndarray, axis: int, sign: int) -> np.ndarray:
    """The reference kernel along ``axis``: rows of the moved axis."""
    rows = np.moveaxis(x, axis, -1)
    shape = rows.shape
    rows = rows.reshape(-1, shape[-1])
    yr, yi = fft4step_planes(jnp.asarray(rows.real), jnp.asarray(rows.imag),
                             sign, interpret=True)
    y = (np.asarray(yr) + 1j * np.asarray(yi)).reshape(shape)
    return np.moveaxis(y, -1, axis)


def _close(got, want, tol=KERNEL_TOL):
    np.testing.assert_allclose(got, want, atol=tol * max(1, np.abs(want).max()))


@pytest.mark.parametrize("shape,axis", [
    ((16, 3, 5), 0), ((3, 16, 5), 1), ((3, 5, 16), 2), ((3, 5, 16), -1),
    ((64, 2, 2, 3), 0), ((2, 128, 3, 2), 1), ((2, 3, 256, 2), 2),
    ((2, 3, 2, 64), 3), ((3, 1024, 2), -2), ((4096, 2), 0),
])
@pytest.mark.parametrize("sign", [-1, +1])
def test_axis_plain_matches_pallas_kernel(shape, axis, sign):
    x = _field(shape, seed=shape[axis] + len(shape))
    want = _pallas_along(x, axis, sign)
    got = fft_matmul.fft4step_axis_plain(torch.from_numpy(x), axis, sign)
    assert got.shape == x.shape
    _close(got.numpy(), want)
    # a CPU tensor takes the plain version
    assert torch.equal(fft_matmul.fft4step_axis(torch.from_numpy(x), axis,
                                                sign), got)


@pytest.mark.parametrize("axis", [0, 1, 2, -1, -2, -3])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fft_1d_pallas_matches_reference(axis, sign):
    x = _field((16, 32, 64), seed=7)
    want = np.asarray(ref_local_fft.fft_1d(jnp.asarray(x), axis, sign,
                                           impl="pallas"))
    got = fft_1d(torch.from_numpy(x), axis, sign, impl="pallas")
    assert got.shape == x.shape
    _close(got.numpy(), want)
    _close(got.numpy(), np.fft.fft(x, axis=axis) if sign == -1
           else np.fft.ifft(x, axis=axis) * x.shape[axis])


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_fft3d_local_pallas_matches_reference(norm):
    x = _field((8, 16, 32), seed=8)
    want = np.asarray(ref_local_fft.fft3d_local(jnp.asarray(x), -1,
                                                impl="pallas", norm=norm))
    got = fft3d_local(torch.from_numpy(x), -1, impl="pallas", norm=norm)
    _close(got.numpy(), want, FFT3_TOL)


def test_axis_form_takes_non_contiguous_input():
    x = torch.from_numpy(_field((32, 8, 16), seed=9)).transpose(0, 2)
    assert not x.is_contiguous()
    for axis in range(3):
        _close(fft_matmul.fft4step_axis(x, axis, -1).numpy(),
               np.fft.fft(x.numpy(), axis=axis))


def test_axis_form_refuses_what_the_kernel_does_not_take():
    n = plan_lib.MAX_TWO_LEVEL * 2
    with pytest.raises(ValueError, match="two-level kernel limit"):
        fft_matmul.fft4step_axis(torch.zeros(2, n, 3, dtype=torch.complex64),
                                 1)
    with pytest.raises(ValueError, match="power-of-two"):
        fft_matmul.fft4step_axis(torch.zeros(2, 12, dtype=torch.complex64), 1)
    with pytest.raises(ValueError, match="an axis"):
        fft_matmul.fft4step_axis(torch.zeros((), dtype=torch.complex64), 0)
