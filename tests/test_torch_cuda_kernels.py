"""The Hopper kernels against their plain versions, on a CUDA card.

Marked ``cuda``: they skip where there is no card (the kernels are
compiled for sm_90a by nvcc at first use).  On a machine with the card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
"""

import pytest
import torch

from repro_torch.kernels import (fft_matmul, hermitian, launch_counts,
                                 spectral_scale, spectral_scale_op)
from repro_torch.kernels import transpose_pack as tp

KERNEL_TOL = 3e-4   # tests/test_kernels_fft.py:18
HERM_TOL = 1e-6     # tests/test_real_fft.py:149
SCALE_TOL = 1e-5    # tests/test_kernels_fft.py:68


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 16, 64, 256, 1024, 2048, 4096])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fft4step_kernel_matches_plain(cuda_device, n, sign):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(333, n, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    before = launch_counts().get("fft4step", 0)
    got = fft_matmul.fft4step(x, sign)
    torch.cuda.synchronize()
    assert launch_counts()["fft4step"] == before + 1
    want = fft_matmul.fft4step_plain(x, sign)
    atol = KERNEL_TOL * want.abs().max().item()
    assert (got - want).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis,p", [((16, 8, 8), 0, 2), ((8, 16, 8), 1, 2),
                                          ((4, 24, 5), 1, 8), ((3, 7, 6), 2, 3)])
def test_rotate_kernel_matches_plain(cuda_device, shape, axis, p):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(*shape, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    for idx in range(p):
        pieces = tp.pack_pieces(x, axis, idx, p)
        for ours, plain in zip(pieces, tp.pack_pieces(x.cpu(), axis, idx, p)):
            assert torch.equal(ours.cpu(), plain)
        back = tp.unpack_pieces(torch.stack(pieces), axis, -idx)
        assert torch.equal(back, x)
        assert torch.equal(tp.rotate_blocks(x, axis, idx, p).cpu(),
                           tp.rotate_blocks(x.cpu(), axis, idx, p))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(4, 64, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fft_matmul.fft4step(x[:, ::2])
    with pytest.raises(TypeError, match="complex64"):
        fft_matmul.fft4step(x.to(torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        tp.rotate_blocks(x.t(), 0, 1, 2)


@pytest.mark.cuda
def test_croft3d_meshless_runs_the_kernel(cuda_device):
    from repro_torch.core import Croft3D, FFTOptions
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(32, 16, 64, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    plan = Croft3D((32, 16, 64), opts=FFTOptions(local_impl="pallas"))
    before = launch_counts().get("fft4step", 0)
    y = plan.forward(x)
    assert launch_counts()["fft4step"] == before + 3
    ref = torch.fft.fftn(x)
    assert (y - ref).abs().max().item() < 5e-4 * ref.abs().max().item()
    assert (plan.inverse(y) - x).abs().max().item() < 1e-4


def _launched(name, fn):
    before = launch_counts().get(name, 0)
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pair_axis", [((8, 4, 16), 1), ((3, 6, 64), 0),
                                             ((2, 4, 3, 256), 1),
                                             ((5, 2, 1030), 1)])
def test_hermitian_kernels_match_plain(cuda_device, shape, pair_axis):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[-1])
    c = torch.randn(*shape, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    got = _launched(hermitian.UNPACK,
                    lambda: hermitian.unpack_two_for_one(c, pair_axis))
    want = hermitian.unpack_two_for_one_plain(c, pair_axis)
    tol = HERM_TOL * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    back = _launched(hermitian.EXTEND, lambda: hermitian.hermitian_extend(
        got, pair_axis, shape[-1]))
    want = hermitian.hermitian_extend_plain(got, pair_axis, shape[-1])
    assert (back - want).abs().max().item() <= HERM_TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_spectral_scale_kernels_match_plain(cuda_device, alpha):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(37, 513, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    hf = torch.randn(37, 513, dtype=torch.complex64, device=cuda_device,
                     generator=gen)
    hb = hf[0].contiguous()
    got = _launched(spectral_scale.FULL, lambda:
                    spectral_scale.spectral_scale_planes_full(x, hf, alpha))
    want = spectral_scale.spectral_scale_plain(x, hf, alpha)
    assert (got - want).abs().max().item() <= \
        SCALE_TOL * want.abs().max().item()
    got = _launched(spectral_scale.BROADCAST,
                    lambda: spectral_scale_op(x.reshape(1, 37, 513), hb, alpha))
    want = spectral_scale.spectral_scale_plain(x, hb, alpha)
    assert (got.reshape(37, 513) - want).abs().max().item() <= \
        SCALE_TOL * want.abs().max().item()


@pytest.mark.cuda
def test_real_kernel_wrappers_refuse_what_they_do_not_take(cuda_device):
    c = torch.zeros(4, 2, 64, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        hermitian.unpack_two_for_one(c[:, :, ::2], 1)
    with pytest.raises(TypeError, match="complex64"):
        hermitian.hermitian_extend(c.to(torch.complex128), 1, 128)
    with pytest.raises(TypeError, match="complex64"):
        spectral_scale.spectral_scale_planes_full(c[0], c[0].to(
            torch.complex128))
    with pytest.raises(ValueError, match="cuda"):
        spectral_scale.spectral_scale_planes_full(c[0], c[0].cpu())


@pytest.mark.cuda
def test_croft3d_r2c_meshless_runs_the_kernels(cuda_device):
    from repro_torch.core import Croft3D, FFTOptions, poisson_solve
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(32, 16, 64, device=cuda_device, generator=gen)
    plan = Croft3D((32, 16, 64), problem="r2c",
                   opts=FFTOptions(local_impl="pallas"))
    before = launch_counts()
    y = plan.forward(x)
    back = plan.inverse(y)
    u = poisson_solve(x - x.mean(), plan)
    after = launch_counts()
    for name in (hermitian.UNPACK, hermitian.EXTEND, spectral_scale.FULL):
        assert after[name] > before.get(name, 0)
    ref = torch.fft.rfftn(x)
    assert (y - ref).abs().max().item() < 5e-5 * ref.abs().max().item()
    assert (back - x).abs().max().item() < 1e-4
    assert u.shape == x.shape and torch.isfinite(u).all()
