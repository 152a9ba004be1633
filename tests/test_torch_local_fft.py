"""The port's plans and local FFTs (``repro_torch.core.plan``/``local_fft``)
against the JAX reference on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import local_fft as ref_local
from repro.core import plan as ref_plan
from repro_torch.core import local_fft, plan

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
    ours = local_fft.fft3d_local(torch.from_numpy(x), sign, impl=impl,
                                 plan_cache=plan_cache, norm=norm).numpy()
    ref = np.asarray(ref_local.fft3d_local(jnp.asarray(x), sign, impl=impl,
                                           plan_cache=plan_cache, norm=norm))
    np.testing.assert_allclose(ours, ref, atol=FFT3_TOL * np.abs(ref).max())


def test_apply_norm_rejects_unknown():
    with pytest.raises(ValueError, match="unknown norm"):
        local_fft.apply_norm(torch.zeros(2, 2, 2, dtype=torch.complex64),
                             -1, "forward")


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
