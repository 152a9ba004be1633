"""The port's plans and local FFTs (``repro_torch.core.plan``/``local_fft``)
against the JAX reference on the same numpy inputs, and the single-device
3-D transform, a schedule run by the executor, against them."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import local_fft as ref_local
from repro.core import plan as ref_plan
from repro_torch.core import Croft3D, FFTOptions, fft3d_local, local_fft, plan
from repro_torch.core import schedule as schedule_lib
from repro_torch.kernels import dft_rows
from repro_torch.obs import metrics

IMPLS = ("matmul", "stockham", "xla", "pallas")
KERNEL_TOL = 3e-4   # tests/test_kernels_fft.py:18
FFT3_TOL = 5e-4     # tests/test_kernels_fft.py:78


def _field(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [2 ** p for p in range(15)])
def test_split_factors_match(n):
    assert plan.split_factors(n) == ref_plan.split_factors(n)
    assert plan.split_factors(n, 16) == ref_plan.split_factors(n, 16)


def test_split_factors_reject_non_pow2():
    for mod in (plan, ref_plan):
        with pytest.raises(ValueError, match="power-of-two"):
            mod.split_factors(24)


@pytest.mark.parametrize("n", [8, 64, 256, 2048, 8192])
@pytest.mark.parametrize("sign", [-1, +1])
def test_plan_constants_match(n, sign):
    ours = plan.make_plan(n, sign)
    ref = ref_plan.make_plan(n, sign)
    assert (ours.n, ours.n1, ours.n2, ours.two_level) == \
        (ref.n, ref.n1, ref.n2, ref.two_level)
    for name in ("w1", "w2", "tw", "w1_stacked", "w2_stacked"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    # the device tensors are the numpy constants, cached per device
    w1, w2, tw = ours.constants_torch("cpu")
    np.testing.assert_array_equal(w1.numpy(), ref.w1)
    assert ours.constants_torch("cpu")[0] is w1
    # "multiple plans": rebuilt with tensor ops, as constants_jnp does
    for a, b in zip(ours.constants_torch("cpu", rematerialize=True),
                    ref.constants_jnp(rematerialize=True)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


def test_plan_cache_info_and_clear():
    plan.clear_plan_cache()
    plan.make_plan(64)
    plan.make_plan(64)
    info = plan.plan_cache_info()
    assert info.hits >= 1 and info.currsize >= 1
    plan.clear_plan_cache()
    assert plan.plan_cache_info().currsize == 0


@pytest.mark.parametrize("n", [64, 512, 8192])
@pytest.mark.parametrize("plan_cache", [True, False])
def test_fft_matmul_matches_reference(n, plan_cache):
    """Single product, two-level four-step and the six-step recursion."""
    x = _field((3, n), seed=n)
    ours = local_fft.fft_matmul(torch.from_numpy(x), -1,
                                plan_cache=plan_cache).numpy()
    ref = np.asarray(ref_local.fft_matmul(jnp.asarray(x), -1,
                                          plan_cache=plan_cache))
    np.testing.assert_allclose(ours, ref, atol=KERNEL_TOL * np.abs(ref).max())


def _axis_layouts(x: np.ndarray, axis: int) -> dict:
    """The values of ``x`` in three layouts: contiguous, a K-chunk slice
    (the block of a larger field, cut along the first other dim) and a
    ``movedim`` view (the axis stored first)."""
    cut = next(d for d in range(x.ndim) if d != axis % x.ndim)
    big = np.concatenate([_field(x.shape, seed=7), x, _field(x.shape, 8)],
                         axis=cut)
    lo = x.shape[cut]
    stored_first = np.ascontiguousarray(np.moveaxis(x, axis, 0))
    return {
        "contiguous": torch.from_numpy(x.copy()),
        "k_chunk": torch.from_numpy(big).narrow(cut, lo, lo),
        "movedim": torch.from_numpy(stored_first).movedim(0, axis),
    }


@pytest.mark.parametrize("n", [2, 8, 64, 128, 1024, 8192])
@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("axis", [-3, -2, -1])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("plan_cache", [True, False])
def test_matmul_along_an_axis_matches_reference(n, ndim, axis, sign,
                                                plan_cache):
    """``fft_1d(impl="matmul")`` and ``fft_matmul(axis=)``, which read the
    axis where it lies, against the reference's ``fft_matmul`` on the
    axis moved last and against numpy, on every layout of the input."""
    shape = [3, 2] if ndim == 3 else [2, 3, 2]
    shape.insert(ndim + axis, n)
    x = _field(tuple(shape), seed=n + ndim)
    ref = np.moveaxis(np.asarray(ref_local.fft_matmul(
        jnp.asarray(np.moveaxis(x, axis, -1)), sign,
        plan_cache=plan_cache)), -1, axis)
    exact = np.fft.fft(x.astype(np.complex128), axis=axis)
    if sign == +1:
        exact = np.fft.ifft(x.astype(np.complex128), axis=axis) * n
    atol = KERNEL_TOL * np.abs(ref).max()
    np.testing.assert_allclose(ref, exact, atol=atol)
    for name, t in _axis_layouts(x, axis).items():
        for got in (local_fft.fft_1d(t, axis, sign, impl="matmul",
                                     plan_cache=plan_cache),
                    local_fft.fft_matmul(t, sign, axis=axis,
                                         plan_cache=plan_cache)):
            assert got.shape == x.shape and got.is_contiguous(), name
            np.testing.assert_allclose(got.numpy(), ref, atol=atol,
                                       err_msg=name)
            np.testing.assert_allclose(got.numpy(), exact, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fft_matmul_gradient_is_the_flipped_transform(axis, sign):
    """Under grad the products run inside ``grad.vjp.Linear``: the
    gradient equals ``torch.fft``'s autograd (``F_s^H = F_{-s}``)."""
    g = torch.Generator().manual_seed(axis)
    shape = [4, 8, 6]
    shape[axis] = 128
    x = torch.randn(shape, dtype=torch.complex64, generator=g,
                    requires_grad=True)
    r = torch.randn(shape, dtype=torch.complex64, generator=g)
    y = local_fft.fft_matmul(x, sign, axis=axis)
    assert y.grad_fn is not None
    (y * r).real.sum().backward()
    x2 = x.detach().clone().requires_grad_()
    f = torch.fft.fft if sign == -1 else torch.fft.ifft
    y2 = f(x2, dim=axis) * (1 if sign == -1 else shape[axis])
    (y2 * r).real.sum().backward()
    torch.testing.assert_close(y.detach(), y2.detach(), rtol=0,
                               atol=KERNEL_TOL * y2.abs().max().item())
    torch.testing.assert_close(x.grad, x2.grad, rtol=0,
                               atol=KERNEL_TOL * x2.grad.abs().max().item())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("plan_cache", [True, False])
def test_fft_1d_matches_reference(impl, sign, plan_cache):
    x = _field((4, 32, 8), seed=1)
    for axis in (0, 1, 2):
        ours = local_fft.fft_1d(torch.from_numpy(x), axis, sign, impl=impl,
                                plan_cache=plan_cache).numpy()
        ref = np.asarray(ref_local.fft_1d(jnp.asarray(x), axis, sign,
                                          impl=impl, plan_cache=plan_cache))
        np.testing.assert_allclose(ours, ref,
                                   atol=KERNEL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("impl", IMPLS + (("pallas", "stockham", "matmul"),))
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "none"])
@pytest.mark.parametrize("plan_cache", [True, False])
def test_fft3d_local_matches_reference(impl, sign, norm, plan_cache):
    x = _field((16, 8, 8), seed=2)
    ours = fft3d_local(torch.from_numpy(x), sign, impl=impl,
                       plan_cache=plan_cache, norm=norm).numpy()
    ref = np.asarray(ref_local.fft3d_local(jnp.asarray(x), sign, impl=impl,
                                           plan_cache=plan_cache, norm=norm))
    np.testing.assert_allclose(ours, ref, atol=FFT3_TOL * np.abs(ref).max())


def test_apply_norm_rejects_unknown():
    """The one normalization rule takes the reference's names and no
    other."""
    for norm in (None, "backward", "ortho", "none"):
        schedule_lib.norm_factor((2, 2, 2), -1, norm)
    with pytest.raises(ValueError, match="unknown norm"):
        schedule_lib.norm_factor((2, 2, 2), -1, "forward")


@pytest.mark.parametrize("impl", ["matmul", "stockham", "xla"])
def test_meshless_plan_is_the_per_axis_composition(impl):
    """A meshless ``Croft3D`` runs three 1-D FFTs, x then y then z, and
    the inverse's 1/N: bitwise what those calls give alone."""
    x = torch.from_numpy(_field((16, 8, 4), seed=3))
    p = Croft3D(tuple(x.shape), device="cpu",
                opts=FFTOptions(local_impl=impl))

    def composed(v, sign):
        for axis in (0, 1, 2):
            v = local_fft.fft_1d(v, axis, sign, impl=impl)
        return schedule_lib.normalize(
            v, schedule_lib.norm_factor(v.shape, sign, None))
    y = p.forward(x)
    assert torch.equal(y, composed(x, -1))
    assert torch.equal(p.inverse(y), composed(y, +1))


def test_entry_points_need_a_device_choice():
    """The card is the default: without one, asking for it raises."""
    from repro_torch.core import Croft3D, fft3d
    from repro_torch.kernels import fft_matmul_1d
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = torch.zeros(4, 4, 4, dtype=torch.complex64)
    for call in (lambda: fft3d(x), lambda: fft_matmul_1d(x),
                 lambda: Croft3D((4, 4, 4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert fft3d(x, device="cpu").device.type == "cpu"


# every two-level split the fused contiguous-axis kernel takes: 16 x 8
# (128 points) to 64 x 64 (4096)
TWO_LEVEL = [128, 256, 512, 1024, 2048, 4096]


def _exact(x: np.ndarray, sign: int, axis: int = -1) -> np.ndarray:
    x = x.astype(np.complex128)
    if sign == -1:
        return np.fft.fft(x, axis=axis)
    return np.fft.ifft(x, axis=axis) * x.shape[axis]


@pytest.mark.parametrize("n", TWO_LEVEL)
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("rows,pad", [(1, 0), (7, 3)])
def test_dft_rows_plain_matches_numpy(n, sign, rows, pad):
    """``kernels/dft_rows`` on a CPU tensor (its plain version) against
    numpy's FFT: one row, and an odd count of rows ``n + pad`` apart (a
    sliced view, read where it lies), with the plan's tables."""
    p = plan.make_plan(n, sign)
    w1, w2, _ = p.constants_torch("cpu")
    x = torch.from_numpy(_field((rows, n + pad), seed=n))[:, :n]
    got = dft_rows.dft_rows(x, w1, w2, p.twiddles_t_torch("cpu"))
    assert got.shape == (rows, n) and got.is_contiguous()
    want = _exact(x.numpy(), sign)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=KERNEL_TOL * np.abs(want).max())


def _fused_axes() -> float:
    found = metrics.get_registry().get(local_fft.FUSED_AXES)
    return 0.0 if found is None else found.value


@pytest.mark.parametrize("dtype,shape,axis,fused", [
    (torch.complex64, (3, 1024), -1, True),
    (torch.complex64, (2, 5, 128), -1, True),
    (torch.complex64, (3, 4096), -1, True),
    (torch.complex64, "k_chunk", -1, True),     # rows 2048 apart
    (torch.complex128, (3, 1024), -1, False),   # cuBLAS zgemm
    (torch.complex64, (3, 64), -1, False),      # one product
    (torch.complex64, (2, 8192), -1, False),    # six-step
    (torch.complex64, (1024, 3), 0, False),     # a strided axis, C = 3
])
def test_the_fused_kernel_takes_complex64_two_level_contiguous_axes(
        monkeypatch, dtype, shape, axis, fused):
    """``_dft_axis`` sends an axis to ``kernels/dft_rows`` by what it
    sees: C = 1, complex64, a two-level split of 128 to 4096 points; the
    three-step path keeps complex128, n <= 64, the six-step levels and
    every strided axis.  Either way the transform is numpy's."""
    if shape == "k_chunk":
        x = torch.from_numpy(_field((3, 2048), seed=2))[:, :1024]
    else:
        x = torch.from_numpy(_field(shape, seed=1)).to(dtype)
    seen = []
    run = dft_rows.dft_rows

    def spy(v, *tables):
        seen.append(v.stride())
        return run(v, *tables)
    monkeypatch.setattr(dft_rows, "dft_rows", spy)
    before = _fused_axes()
    got = local_fft.fft_matmul(x, -1, axis=axis)
    assert len(seen) == int(fused) == _fused_axes() - before
    if shape == "k_chunk":
        assert seen == [(2048, 1)]
    want = _exact(x.numpy(), -1, axis)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=KERNEL_TOL * np.abs(want).max())
