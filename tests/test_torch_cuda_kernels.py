"""The Hopper kernels against their plain versions, on a CUDA card.

Marked ``cuda``: they skip where there is no card (the kernels are
compiled for sm_90a by nvcc at first use).  On a machine with the card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import (dft_rows, fft_matmul, flash_attention,
                                 hermitian, launch_counts, spectral_scale,
                                 spectral_scale_op)
from repro_torch.kernels import transpose_pack as tp

KERNEL_TOL = 3e-4   # tests/test_kernels_fft.py:18
HERM_TOL = 1e-6     # tests/test_real_fft.py:149
SCALE_TOL = 1e-5    # tests/test_kernels_fft.py:68
ATTN_TOL = 5e-5     # tests/test_kernels_fft.py:103 (float32, absolute)
# bfloat16, per element: ATTN_BF16_REL·|want| + ATTN_TOL.  Both sides work
# in float32 and round the result to bf16 at the end, each within 2**-8
# of the value, so two ulps of the value are room to spare
ATTN_BF16_REL = 2.0 ** -6
TF_TOL = 2e-4       # tests/test_models_smoke.py:111-113
# dft_rows against cuBLAS's products and torch.fft: float32 sums of the
# same terms (at most 64 a product) in another order than cuBLAS's, each
# output within a few float32 ulps of the largest; TF32 products (about
# 4e-4 of it, the benchmark's control) would not pass
DFT_TOL = 1e-5


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


def _axis_shape(ndim, axis, n, inner, outer=3):
    """A shape of ``ndim`` dims with ``n`` at ``axis``, ``outer`` points
    before it and ``inner`` after it."""
    after = ndim - 1 - axis
    factors = {1: [], 2: [2], 8: [2, 4], 24: [4, 6]}[inner]
    tail = [inner] if after == 1 else [1] * (after - len(factors)) + factors
    head = [outer] + [1] * (axis - 1) if axis else []
    return tuple(head + [n] + tail)


AXIS_CASES = [(ndim, axis, inner) for ndim in (3, 4) for axis in range(ndim)
              for inner in (1, 2, 8, 24) if axis < ndim - 1 or inner == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("ndim,axis,inner", AXIS_CASES)
@pytest.mark.parametrize("n", [16, 64, 1024, 4096])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fft4step_axis_matches_plain(cuda_device, ndim, axis, inner, n,
                                     sign):
    """Every axis of 3-D and 4-D inputs, transformed where it lies; inner
    24 is no multiple of the kernel's 8-column tile."""
    shape = _axis_shape(ndim, axis, n, inner)
    gen = torch.Generator(device=cuda_device).manual_seed(n + inner)
    x = torch.randn(*shape, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    got = _launched(fft_matmul.NAME,
                    lambda: fft_matmul.fft4step_axis(x, axis, sign))
    assert got.shape == x.shape and got.is_contiguous()
    want = fft_matmul.fft4step_axis_plain(x, axis, sign)
    assert (got - want).abs().max().item() <= \
        KERNEL_TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fft4step_axis_takes_a_non_contiguous_input(cuda_device, axis):
    gen = torch.Generator(device=cuda_device).manual_seed(axis)
    x = torch.randn(64, 32, 128, dtype=torch.complex64, device=cuda_device,
                    generator=gen).transpose(0, 2)      # (128, 32, 64) view
    assert not x.is_contiguous()
    got = _launched(fft_matmul.NAME,
                    lambda: fft_matmul.fft4step_axis(x, axis, -1))
    want = torch.fft.fft(x, dim=axis)
    assert (got - want).abs().max().item() <= \
        KERNEL_TOL * want.abs().max().item()


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


@pytest.mark.cuda
def test_croft3d_default_plan_round_trip_in_full_fp32(cuda_device):
    """``Croft3D(shape)`` with ``FFTOptions()``: the matmul local FFT's
    cuBLAS products on the field's own layout, TF32 off, at 256^3
    against ``torch.fft.fftn``, and back."""
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.core import local_fft
    from repro_torch.obs import metrics
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((256,) * 3, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    plan = Croft3D(x.shape, opts=FFTOptions())
    copies = metrics.get_registry().counter(local_fft.LAYOUT_COPIES)
    before = copies.value
    y = plan.forward(x)
    assert not torch.backends.cuda.matmul.allow_tf32
    want = torch.fft.fftn(x)
    assert (y - want).abs().max().item() <= 3e-5 * want.abs().max().item()
    back = plan.inverse(y)
    assert (back - x).abs().max().item() <= 3e-5 * x.abs().max().item()
    assert copies.value == before
    # the 256-point contiguous axis of each transform ran the fused kernel
    launches = launch_counts().get(dft_rows.NAME, 0)
    plan.inverse(plan.forward(x))
    torch.cuda.synchronize()
    assert launch_counts()[dft_rows.NAME] == launches + 2


def _launched(name, fn):
    before = launch_counts().get(name, 0)
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    return out


def _dft_tables(n, sign, device):
    from repro_torch.core import plan as plan_lib
    p = plan_lib.make_plan(n, sign)
    w1, w2, _ = p.constants_torch(device)
    return w1, w2, p.twiddles_t_torch(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("rows,pad", [(1, 0), (333, 0), (257, 5)])
def test_dft_rows_kernel_matches_plain_and_torch_fft(cuda_device, n, sign,
                                                     rows, pad):
    """Every split the kernel takes, both signs, one row, a ragged count
    of rows and rows ``n + pad`` apart (a sliced view): against its plain
    version (the cuBLAS products and twiddle pass, TF32 off) and against
    ``torch.fft`` as the oracle."""
    from repro_torch.device import full_fp32_matmul
    full_fp32_matmul(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n + rows)
    x = torch.randn(rows, n + pad, dtype=torch.complex64,
                    device=cuda_device, generator=gen)[:, :n]
    tables = _dft_tables(n, sign, cuda_device)
    got = _launched(dft_rows.NAME, lambda: dft_rows.dft_rows(x, *tables))
    assert got.shape == (rows, n) and got.is_contiguous()
    plain = dft_rows.dft_rows_plain(x, *tables)
    oracle = torch.fft.fft(x) if sign == -1 else torch.fft.ifft(x) * n
    for want in (plain, oracle):
        assert (got - want).abs().max().item() <= \
            DFT_TOL * want.abs().max().item()


@pytest.mark.cuda
def test_dft_rows_wrapper_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(4, 1024, dtype=torch.complex64, device=cuda_device)
    tables = _dft_tables(1024, -1, cuda_device)
    with pytest.raises(TypeError, match="complex64"):
        dft_rows.dft_rows(x.to(torch.complex128), *tables)
    with pytest.raises(ValueError, match="one cuda device"):
        dft_rows.dft_rows(x, *(t.cpu() for t in tables))
    with pytest.raises(ValueError, match="unit stride"):
        dft_rows.dft_rows(torch.zeros(4, 2048, dtype=torch.complex64,
                                      device=cuda_device)[:, ::2], *tables)
    with pytest.raises(ValueError, match="unit stride"):
        dft_rows.dft_rows(x.as_strided((4, 1024), (512, 1)), *tables)
    eight = torch.ones(8, 8, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="splits"):
        dft_rows.dft_rows(x[:, :64], eight, eight, eight)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_cache", [True, False])
def test_matmul_fft_runs_the_fused_kernel_on_a_k_chunk(cuda_device,
                                                       plan_cache):
    """``fft_matmul`` on rows 2048 apart (a K-chunk's slice) launches the
    kernel once, on the view, with the plan's cached tables or rebuilt
    ones."""
    from repro_torch.core import local_fft
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(96, 2048, dtype=torch.complex64, device=cuda_device,
                    generator=gen)[:, :1024]
    got = _launched(dft_rows.NAME, lambda: local_fft.fft_matmul(
        x, -1, plan_cache=plan_cache))
    want = torch.fft.fft(x)
    assert (got - want).abs().max().item() <= \
        DFT_TOL * want.abs().max().item()


@pytest.mark.cuda
def test_croft3d_default_plan_runs_the_fused_kernel_at_1024(cuda_device):
    """``Croft3D(shape)`` under ``FFTOptions()`` with a 1024-point
    contiguous axis, the cell's split (32 x 32): one launch a transform,
    the round trip within the default plan's 3e-5."""
    from repro_torch.core import Croft3D, FFTOptions
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(64, 32, 1024, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    plan = Croft3D(x.shape, opts=FFTOptions())
    y = _launched(dft_rows.NAME, lambda: plan.forward(x))
    want = torch.fft.fftn(x)
    assert (y - want).abs().max().item() <= 3e-5 * want.abs().max().item()
    back = _launched(dft_rows.NAME, lambda: plan.inverse(y))
    assert (back - x).abs().max().item() <= 3e-5 * x.abs().max().item()


@pytest.mark.cuda
def test_croft3d_default_plan_in_double_donates_its_axis_outputs(cuda_device):
    """``Croft3D(shape, dtype=torch.complex128)`` under ``FFTOptions()``
    at 256^3: cuBLAS FP64 products against ``torch.fft.fftn`` within
    float64 rounding, the caller's field unchanged, and a round trip
    that holds at most 3 blocks beside the field, as the y and z axes
    write their outputs into the executor's dead input blocks (4 without
    that)."""
    from repro_torch.core import Croft3D, FFTOptions, local_fft
    from repro_torch.obs import metrics
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((256,) * 3, dtype=torch.complex128, device=cuda_device,
                    generator=gen)
    keep = x.clone()
    plan = Croft3D(x.shape, dtype=torch.complex128, opts=FFTOptions())
    want = torch.fft.fftn(x)
    y = plan.forward(x)
    assert (y - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    back = plan.inverse(y)
    assert (back - x).abs().max().item() <= 1e-12 * x.abs().max().item()
    assert torch.equal(x, keep)
    del y, back, want, keep
    donated = metrics.get_registry().counter(local_fft.DONATED_OUTPUTS)
    before = donated.value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plan.inverse(plan.forward(x))
    torch.cuda.synchronize()
    block = x.numel() * x.element_size()
    assert torch.cuda.max_memory_allocated() - base <= 3.05 * block
    assert donated.value == before + 4


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
def test_meshless_service_runs_the_scale_kernel(cuda_device):
    """A meshless ``TransformService`` on the card serves a filtered
    request at 64^3 through the full-shape scale kernel."""
    from repro_torch.serve import TransformService
    gen = torch.Generator(device=cuda_device).manual_seed(64)
    x = torch.randn((64,) * 3, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    h = torch.randn((64,) * 3, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    before = launch_counts().get("spectral_scale_full", 0)
    with TransformService() as svc:
        assert svc.device.type == "cuda"
        got = svc.transform(x.cpu().numpy(), problem="filtered",
                            h=h.cpu().numpy())
    assert launch_counts().get("spectral_scale_full", 0) > before
    want = torch.fft.fftn(x) * h
    err = (torch.from_numpy(got).to(cuda_device) - want).abs().max()
    assert err.item() <= 5e-4 * want.abs().max().item()  # test_kernels_fft.py:78


@pytest.mark.cuda
def test_meshless_service_stages_through_bounded_pinned_memory(
        cuda_device, monkeypatch):
    """The meshless service on the card moves payloads and results through
    its two pinned chunks (made smaller here than one plane of the field,
    so each plane goes row block by row block): ragged rows, payloads cast
    on the way (float64 to complex64), a transposed and a reversed view
    come back bitwise equal to the cached plan's batched call on the same
    stack, and the pinned bytes do not grow from batch to batch."""
    from repro_torch.serve import TransformService
    from repro_torch.serve import service as service_mod
    monkeypatch.setattr(service_mod._Staging, "CHUNK", 1 << 12)
    rng = np.random.RandomState(65)
    xs = [rng.randn(32, 32, 32), rng.randn(32, 32, 32).transpose(2, 0, 1),
          rng.randn(32, 32, 32)[::-1]]  # float64 payloads
    pinned = []
    with TransformService(max_batch=4, max_wait_ms=200.0) as svc:
        for _ in range(3):
            futs = [svc.submit(x) for x in xs]
            got = [f.result(timeout=300) for f in futs]
            pinned.append([v for k, v in torch.cuda.host_memory_stats(
            ).items() if "allocated_bytes" in k and k.endswith("current")])
        plan = svc.cache.get((32, 32, 32)).plan
    assert all(r.ok and (r.batch_size, r.padded_size) == (3, 4) for r in got)
    stack = torch.zeros((4, 32, 32, 32), dtype=torch.complex64,
                        device=cuda_device)
    stack[:3] = torch.from_numpy(np.stack(xs)).to(cuda_device)
    want = plan.forward_batched(stack)[:3].cpu().numpy()
    for r, w in zip(got, want):
        assert np.array_equal(r.value, w)
    assert pinned[0] == pinned[1] == pinned[2], pinned


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
    for name in (hermitian.UNPACK, hermitian.EXTEND, spectral_scale.POISSON):
        assert after[name] > before.get(name, 0)
    ref = torch.fft.rfftn(x)
    assert (y - ref).abs().max().item() < 5e-5 * ref.abs().max().item()
    assert (back - x).abs().max().item() < 1e-4
    assert u.shape == x.shape and torch.isfinite(u).all()


def _view_cases(dev):
    """Per wrapper: (launch count, its call on lazy views, its plain version
    on the same values in memory, tolerance relative to max|want|)."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def c(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=gen)
    x3, cc, s = c(4, 64, 8), c(3, 2, 64), c(3, 4, 32)
    x2, h2, hb, flat = c(6, 128), c(6, 128), c(128), c(2 * 4 * 64)
    q = torch.randn(1, 64, 2, 64, device=dev, generator=gen)

    def neg(t):
        # t's values behind a lazy negation
        return torch.complex(torch.zeros_like(t), -t).conj().imag

    def mem(t):
        return t.conj().resolve_conj()
    return {
        "fft4step_axis": (
            fft_matmul.NAME, lambda: fft_matmul.fft4step_axis(x3.conj(), 1),
            lambda: fft_matmul.fft4step_axis_plain(mem(x3), 1), KERNEL_TOL),
        "unpack_two_for_one": (
            hermitian.UNPACK, lambda: hermitian.unpack_two_for_one(
                cc.conj(), 1),
            lambda: hermitian.unpack_two_for_one_plain(mem(cc), 1), HERM_TOL),
        "hermitian_extend": (
            hermitian.EXTEND, lambda: hermitian.hermitian_extend(
                s.conj(), 1, 64),
            lambda: hermitian.hermitian_extend_plain(mem(s), 1, 64), HERM_TOL),
        "spectral_scale_planes": (
            spectral_scale.BROADCAST,
            lambda: spectral_scale.spectral_scale_planes(x2.conj(), hb.conj(),
                                                         0.5),
            lambda: spectral_scale.spectral_scale_plain(mem(x2), mem(hb), 0.5),
            SCALE_TOL),
        "spectral_scale_planes_full": (
            spectral_scale.FULL,
            lambda: spectral_scale.spectral_scale_planes_full(
                x2.conj(), h2.conj(), 0.5),
            lambda: spectral_scale.spectral_scale_plain(mem(x2), mem(h2), 0.5),
            SCALE_TOL),
        "rotate_block_rows": (
            tp.NAME, lambda: tp.rotate_block_rows(flat.conj(), 2, 4, 64, 1),
            lambda: tp.rotate_block_rows_plain(mem(flat), 2, 4, 64, 1), 0.0),
        "flash_attention": (
            flash_attention.NAME, lambda: flash_attention.flash_attention(
                neg(q), neg(q), neg(q)),
            lambda: flash_attention.flash_attention_plain(q, q, q), ATTN_TOL),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft4step_axis", "unpack_two_for_one",
                                  "hermitian_extend", "spectral_scale_planes",
                                  "spectral_scale_planes_full",
                                  "rotate_block_rows", "flash_attention"])
def test_wrappers_read_conj_and_neg_views(cuda_device, name):
    """A lazy conjugate (or negation) reaches no kernel as raw memory:
    each wrapper, given ``x.conj()``, launches its kernel and agrees with
    the plain version on the conjugated values."""
    count, call, plain, tol = _view_cases(cuda_device)[name]
    got = _launched(count, call)
    want = plain()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
def test_croft3d_backward_runs_the_kernels(cuda_device):
    """The meshless backward passes run the kernels: three ``fft4step``
    launches for the c2c adjoint, and for the packed r2c filtered one the
    full-shape scale twice and three FFTs, each gradient within 1e-4 of
    ``torch.fft`` autograd."""
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.kernels import reset_launch_counts
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(32, 16, 64, dtype=torch.complex64, device=cuda_device,
                    generator=gen).requires_grad_()
    plan = Croft3D((32, 16, 64), opts=FFTOptions(local_impl="pallas"))
    y = plan.forward(x)
    reset_launch_counts()
    (y.abs() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts().get(fft_matmul.NAME, 0) == 3
    assert (x.grad - 2 * x.numel() * x.detach()).abs().max().item() < \
        1e-4 * x.grad.abs().max().item()
    rplan = Croft3D((32, 16, 64), problem="r2c",
                    opts=FFTOptions(local_impl="pallas"))
    xr = torch.randn(32, 16, 64, device=cuda_device,
                     generator=gen).requires_grad_()
    h = torch.randn(*rplan.spectrum_shape, dtype=torch.complex64,
                    device=cuda_device, generator=gen).requires_grad_()
    y = rplan.forward_filtered(xr, h)
    reset_launch_counts()
    (y.abs() ** 2).sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts.get(spectral_scale.FULL, 0) >= 2
    assert counts.get(fft_matmul.NAME, 0) == 3
    x2 = xr.detach().clone().requires_grad_()
    h2 = h.detach().clone().requires_grad_()
    (torch.fft.rfftn(x2) * h2).abs().pow(2).sum().backward()
    for got, want in ((xr.grad, x2.grad), (h.grad, h2.grad)):
        assert (got - want).abs().max().item() < \
            1e-4 * want.abs().max().item()


def _attention_close(got, want) -> bool:
    """Every element within ATTN_TOL (float32) or ATTN_BF16_REL of its
    value plus ATTN_TOL (bfloat16)."""
    want = want.float()
    tol = (ATTN_TOL if got.dtype == torch.float32
           else ATTN_BF16_REL * want.abs() + ATTN_TOL)
    return bool(((got.float() - want).abs() <= tol).all())


def _attention_case(dev, b, sq, skv, h, kv, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype),
            torch.randn(b, skv, kv, d, device=dev, generator=gen).to(dtype),
            torch.randn(b, skv, kv, d, device=dev, generator=gen).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 120, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (False, 40)])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, d, causal,
                                              window, g):
    # 333 is no multiple of the kernel's 128-row or 64-key tiles
    q, k, v = _attention_case(cuda_device, 2, 333, 333, 2 * g, 2, d, dtype,
                              seed=d + g)
    got = _launched(flash_attention.NAME, lambda: flash_attention.
                    flash_attention(q, k, v, causal=causal, window=window))
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
    assert got.dtype == dtype and got.shape == (2, 333, 2 * g, d)
    assert _attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,causal,window", [
    (77, 200, True, 64),      # Sq < Skv
    (300, 100, True, 32),     # rows past skv + window - 1: no valid key
    (1, 129, False, None),    # one query row
    (257, 1, True, None),     # one key
])
def test_flash_attention_kernel_ragged(cuda_device, sq, skv, causal, window):
    q, k, v = _attention_case(cuda_device, 1, sq, skv, 8, 2, 120,
                              torch.float32, seed=sq)
    got = _launched(flash_attention.NAME, lambda: flash_attention.
                    flash_attention(q, k, v, causal=causal, window=window))
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
    assert torch.isfinite(got).all()
    assert _attention_close(got, want)


def _launched_variant(variant, fn):
    before = launch_counts().get(variant, 0)
    out = _launched(flash_attention.NAME, fn)
    assert launch_counts()[variant] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 120, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (False, 40)])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,skv", [(333, 333), (77, 200), (300, 100)])
def test_flash_attention_tensor_cores_match_plain(cuda_device, d, causal,
                                                  window, g, sq, skv):
    """The bf16 tensor-core kernel, element by element; (300, 100) with a
    window leaves rows with no valid key."""
    q, k, v = _attention_case(cuda_device, 2, sq, skv, 2 * g, 2, d,
                              torch.bfloat16, seed=d + g + sq)
    got = _launched_variant(flash_attention.TC, lambda: flash_attention.
                            flash_attention(q, k, v, causal=causal,
                                            window=window))
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
    assert torch.isfinite(got).all()
    assert _attention_close(got, want)


@pytest.mark.cuda
def test_flash_attention_takes_the_variant_of_its_dtype_and_shape(
        cuda_device):
    cases = [(torch.bfloat16, 120, 0, flash_attention.TC),
             (torch.float32, 120, 0, flash_attention.FFMA),
             (torch.bfloat16, 36, 0, flash_attention.FFMA),   # 72-byte rows
             (torch.bfloat16, 64, 1, flash_attention.FFMA)]   # unaligned q
    for dtype, d, offset, which in cases:
        q, k, v = _attention_case(cuda_device, 1, 150, 150, 4, 2, d, dtype,
                                  seed=d)
        if offset:
            q = torch.cat([q.new_zeros(offset), q.reshape(-1)])[offset:] \
                .view(q.shape)
        assert flash_attention.variant(q, k, v) == which
        got = _launched_variant(which, lambda: flash_attention.
                                flash_attention(q, k, v, window=64))
        assert _attention_close(got, flash_attention.flash_attention_plain(
            q, k, v, window=64))


@pytest.mark.cuda
def test_flash_attention_wrapper_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _attention_case(cuda_device, 1, 16, 16, 4, 2, 64,
                              torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q[:, ::2], k[:, ::2], v[:, ::2])
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="cuda"):
        flash_attention.flash_attention(q, k.cpu(), v)
    big = torch.zeros(1, 4, 2, 136, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(big, big, big)


@pytest.mark.cuda
def test_lm_serving_runs_the_kernel(cuda_device):
    """The smoke model on the card in float32: the prefill and train passes
    launch the kernel once per layer, the decode never, and the decode
    logits at position S equal the train pass's (teacher forcing)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_caches, init_params
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b", smoke=True),
                              dtype="float32")
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                        cuda_device)
    s = 48                      # past the smoke model's 32-token window
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, s + 1), device=cuda_device,
                           generator=gen)
    before = launch_counts().get(flash_attention.NAME, 0)
    ref, _ = forward(model, cfg, tokens, mode="train", kv_block=16)
    caches = init_caches(cfg, 2, 64, dtype=torch.float32, device=cuda_device)
    forward(model, cfg, tokens[:, :s], mode="prefill", caches=caches,
            kv_block=16)
    after_prefill = launch_counts()[flash_attention.NAME]
    dec, _ = forward(model, cfg, tokens[:, s:], mode="decode", caches=caches,
                     start=s, kv_block=16)
    assert after_prefill == before + 2 * cfg.n_layers
    assert launch_counts()[flash_attention.NAME] == after_prefill
    top = ref.abs().max().item()
    assert (dec[:, 0] - ref[:, s]).abs().max().item() <= TF_TOL * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_whisper_encoder_shape(cuda_device, dtype):
    """whisper-base's encoder self-attention: B 8, Sq = Skv = 1500 frames
    (no multiple of the kernel's tiles), 8 heads over 8, head_dim 64,
    non-causal, no window, q pre-scaled as the model passes it; bf16 on
    the tensor-core kernel, float32 on FFMA."""
    q, k, v = _attention_case(cuda_device, 8, 1500, 1500, 8, 8, 64, dtype,
                              seed=1500)
    q = (q.float() * 64 ** -0.5).to(dtype)
    which = flash_attention.TC if dtype == torch.bfloat16 \
        else flash_attention.FFMA
    assert flash_attention.variant(q, k, v) == which
    got = _launched_variant(which, lambda: flash_attention.flash_attention(
        q, k, v, causal=False, scale=1.0))
    want = flash_attention.flash_attention_plain(q, k, v, causal=False,
                                                 scale=1.0)
    assert got.shape == (8, 1500, 8, 64) and torch.isfinite(got).all()
    assert _attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", TF_TOL),
                                       ("bfloat16", 5e-2)])
def test_whisper_prefill_on_the_card_matches_the_cpu(cuda_device, dtype, tol):
    """whisper-base's smoke model through ``make_serve_steps`` on the card
    and on the CPU, the same weights and inputs: the prefill (the encoder
    over 32 frames, the decoder over 12 tokens) launches the kernel once
    a self-attention layer (4) and never for cross-attention, a decode
    step never; the last logits, a decode step and the cross caches agree
    within ``tol``·max|ref| (2e-4 float32, 5e-2 bf16)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, init_params
    from repro_torch.train import cast_to_compute, make_serve_steps
    cfg = dataclasses.replace(get_config("whisper-base", smoke=True),
                              dtype=dtype)
    b, s, t = 2, 12, cfg.n_frontend_tokens
    cpu = cast_to_compute(init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"), dtype)
    card = copy.deepcopy(cpu).to(cuda_device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen)
    frames = torch.randn(b, t, cfg.d_model, generator=gen)
    out = {}
    for dev, model in (("cpu", cpu), (cuda_device, card)):
        prefill, decode = make_serve_steps(cfg, b, 32, kv_block=16,
                                           device=dev)
        caches = init_caches(cfg, b, 32, enc_len=t,
                             dtype=getattr(torch, dtype), device=dev)
        before = launch_counts().get(flash_attention.NAME, 0)
        last, caches = prefill(model, tokens[:, :s], caches, frames=frames)
        mid = launch_counts().get(flash_attention.NAME, 0)
        step, _ = decode(model, tokens[:, s:], caches, s)
        after = launch_counts().get(flash_attention.NAME, 0)
        out[str(dev)] = (last, step, caches[0][0]["cross"]["k"],
                         mid - before, after - mid)
    want, got = out["cpu"], out[str(cuda_device)]
    assert want[3:] == (0, 0)
    assert got[3:] == (cfg.encoder.n_layers + cfg.n_layers, 0)
    for g, w in zip(got[:3], want[:3]):
        w = w.float()
        assert torch.isfinite(g).all()
        assert (g.cpu().float() - w).abs().max().item() \
            <= tol * w.abs().max().item()


# --- the streaming kernels: rotate_blocks (16- or 8-byte vectors) and the
# spectral scale (16-byte vectors), bitwise against their plain versions ---

def _offset_randn(dev, numel, offset, seed):
    """``numel`` complex64 values whose base lies ``offset`` elements past
    an allocation (offset 1: only 8-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(numel + offset, dtype=torch.complex64, device=dev,
                      generator=gen)
    return buf[offset:]


# (outer, unit): unit 1 and odd units take 8-byte vectors, even ones
# 16-byte vectors; runs of 8 bytes to 48 KB, shorter and longer than a
# thread block's 1024 vectors, so a block spans several runs or a run
# several blocks
ROTATE_RUNS = [(3, 1), (5, 7), (4, 16), (6, 64), (4, 128), (3, 1000),
               (2, 6000)]


@pytest.mark.cuda
@pytest.mark.parametrize("outer,unit", ROTATE_RUNS)
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_rotate_paths_match_plain(cuda_device, outer, unit, p):
    for offset in (0, 1):
        x = _offset_randn(cuda_device, outer * p * unit, offset, unit + p)
        for spm in (False, True):
            for dpm in (False, True):
                for shift in range(p):
                    got = _launched(tp.NAME, lambda: tp.rotate_block_rows(
                        x, outer, p, unit, shift, spm, dpm))
                    want = tp.rotate_block_rows_plain(x, outer, p, unit,
                                                      shift, spm, dpm)
                    assert torch.equal(got, want), (offset, spm, dpm, shift)
        path = tp.rotate_path(unit, x.data_ptr(), got.data_ptr())
        aligned = offset == 0 and unit % 2 == 0
        assert path == (tp.VEC16 if aligned else tp.VEC8)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_rotate_past_2gib(cuda_device, offset):
    """Three 1 GiB blocks: runs start at byte offsets 0, 2^30 and 2^31 and
    end at 3·2^30 (16-byte vectors when aligned, 8-byte ones when not)."""
    unit = 1 << 27
    x = _offset_randn(cuda_device, 3 * unit, offset, 7)
    for spm, dpm in ((False, False), (True, False), (False, True)):
        got = _launched(tp.NAME, lambda: tp.rotate_block_rows(
            x, 1, 3, unit, 2, spm, dpm))
        for i in range(3):
            j = (i + 2) % 3
            assert torch.equal(got[i * unit:(i + 1) * unit],
                               x[j * unit:(j + 1) * unit])
        del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 513, 1024, 4097])
@pytest.mark.parametrize("x_offset,h_offset", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_spectral_scale_streams_bitwise(cuda_device, n, x_offset, h_offset,
                                        alpha):
    """Both variants against the plain version, to the bit: bases one
    element in (8-byte aligned), odd totals (a vector across a row
    boundary), n = 1, and n = 4097."""
    rows = 37
    x = _offset_randn(cuda_device, rows * n, x_offset, n).view(rows, n)
    hf = _offset_randn(cuda_device, rows * n, h_offset, n + 1).view(rows, n)
    hb = _offset_randn(cuda_device, n, h_offset, n + 2)
    got = _launched(spectral_scale.FULL, lambda: spectral_scale.
                    spectral_scale_planes_full(x, hf, alpha))
    assert torch.equal(got, spectral_scale.spectral_scale_plain(x, hf, alpha))
    assert got.data_ptr() % 16 == x.data_ptr() % 16
    got = _launched(spectral_scale.BROADCAST, lambda: spectral_scale.
                    spectral_scale_planes(x, hb, alpha))
    assert torch.equal(got, spectral_scale.spectral_scale_plain(x, hb, alpha))


def _wavenumbers(dev, n, box, real=False):
    """``poisson_solve``'s vector of an axis of n points: k ≠ integer when
    box ≠ 2π, so every k² rounds."""
    freq = torch.fft.rfftfreq if real else torch.fft.fftfreq
    return freq(n, d=box / (2 * math.pi * n), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 7, 33), (3, 4, 513), (2, 1, 1),
                                   (1, 3, 2), (9, 5, 33)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_poisson_scale_kernel_bitwise(cuda_device, shape, offset, alpha):
    """The Poisson multiply against its plain version, to the bit: odd
    widths (a vector across a row and a plane boundary), a base 8 bytes
    past a 16-byte boundary, alpha ≠ 1, and k = 0 held."""
    nx, ny, nz = shape
    x = _offset_randn(cuda_device, math.prod(shape), offset,
                      nz + offset).view(shape)
    for box in (2 * math.pi, 3.7):
        k = (_wavenumbers(cuda_device, nx, box),
             _wavenumbers(cuda_device, ny, box),
             _wavenumbers(cuda_device, 2 * nz - 2, box, real=True)
             if nz > 1 else _wavenumbers(cuda_device, 1, box))
        got = _launched(spectral_scale.POISSON,
                        lambda: spectral_scale.poisson_scale(x, *k, alpha))
        want = spectral_scale.poisson_scale_plain(x, *k, alpha)
        assert torch.equal(got, want), box
        assert got.data_ptr() % 16 == x.data_ptr() % 16


@pytest.mark.cuda
def test_poisson_scale_long_stream(cuda_device):
    """Many blocks, a column pattern that never lines up with the
    vectors: (256, 256, 513), bitwise."""
    shape = (256, 256, 513)
    x = _offset_randn(cuda_device, math.prod(shape), 0, 513).view(shape)
    k = (_wavenumbers(cuda_device, 256, 3.7),) * 2 + (
        _wavenumbers(cuda_device, 1024, 3.7, real=True),)
    assert torch.equal(spectral_scale.poisson_scale(x, *k, 0.5),
                       spectral_scale.poisson_scale_plain(x, *k, 0.5))


@pytest.mark.cuda
def test_poisson_scale_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(4, 2, 8, dtype=torch.complex64, device=cuda_device)
    k = [torch.zeros(n, device=cuda_device) for n in (4, 2, 8)]
    with pytest.raises(TypeError, match="float32"):
        spectral_scale.poisson_scale(x, k[0].double(), k[1], k[2])
    with pytest.raises(ValueError, match="cuda"):
        spectral_scale.poisson_scale(x, k[0], k[1].cpu(), k[2])


@pytest.mark.cuda
def test_spectral_scale_long_stream(cuda_device):
    """Many grid strides per thread: 2^22 rows of 3 (a column pattern that
    never lines up with the vectors) and (2048, 1024) full."""
    for rows, n in ((1 << 22, 3), (2048, 1024)):
        x = _offset_randn(cuda_device, rows * n, 0, n).view(rows, n)
        h = _offset_randn(cuda_device, rows * n, 0, n + 1).view(rows, n)
        assert torch.equal(spectral_scale.spectral_scale_planes(x, h[0], 0.5),
                           spectral_scale.spectral_scale_plain(x, h[0], 0.5))
        assert torch.equal(spectral_scale.spectral_scale_planes_full(x, h),
                           spectral_scale.spectral_scale_plain(x, h))


@pytest.mark.cuda
def test_model_constructors_default_to_the_card(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_caches, init_params
    cfg = get_config("h2o-danube-3-4b", smoke=True)
    for model in (init_params(cfg), Model(cfg)):
        assert all(p.device.type == "cuda" for p in model.parameters())
    caches = init_caches(cfg, 1, 8)
    assert caches[0][0]["self"]["k"].device.type == "cuda"


@pytest.mark.cuda
def test_fnet_forward_on_the_card_matches_the_cpu(cuda_device):
    """The fnet-350m smoke model (the spectral mixer's DFT products on
    cuBLAS) on the card against the same weights and tokens on the CPU,
    float32, within 2e-4·max|ref|; it launches none of the kernels."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    cfg = dataclasses.replace(get_config("fnet-350m", smoke=True),
                              dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    want, _ = forward(model, cfg, tokens)
    before = launch_counts()
    got, _ = forward(model.to(cuda_device), cfg, tokens.to(cuda_device))
    torch.cuda.synchronize()
    assert launch_counts() == before
    err = (got.cpu() - want).abs().max().item()
    assert err <= TF_TOL * want.abs().max().item()


@pytest.mark.cuda
def test_trace_forward_meshless_on_the_card(cuda_device):
    """A meshless plan on the card gets the e2e span and the note, and
    ``y`` is the production forward's, bitwise."""
    from repro_torch import obs
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.obs import instrument
    plan = Croft3D((64, 64, 64), opts=FFTOptions(local_impl="pallas"))
    x = torch.randn((64, 64, 64), dtype=torch.complex64, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(2))
    tracer = obs.enable()
    try:
        y, summary = instrument.trace_forward(plan, x, tracer=tracer)
        events = tracer.events()
    finally:
        obs.disable()
    # the attribution's own spans (each names its plan) are the e2e one;
    # the plan's hot-path spans lie inside it
    assert [e["name"] for e in events if "plan" in e["args"]] == ["e2e"]
    assert "croft3d:forward" in {e["name"] for e in events}
    assert summary["stages"] == []
    assert summary["e2e_s"] > 0 and "note" in summary
    with torch.no_grad():
        assert torch.equal(y, plan.forward(x))


MOE_TOL = 1e-5      # tests/test_perf_paths.py:64


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor,n_shared", [(16.0, 0), (1.25, 2),
                                                      (0.5, 0)])
def test_moe_forward_on_the_card_matches_the_cpu(cuda_device,
                                                 capacity_factor, n_shared):
    """``moe_fwd`` (the stable-sort dispatch, the batched expert GEMMs on
    cuBLAS, the float32 combine) on the card against the same weights and
    tokens on the CPU, float32, within 1e-5; the same rows are dropped.
    It launches none of the kernels."""
    from repro_torch.models.config import MoESpec
    from repro_torch.models.moe import init_moe, moe_fwd
    m = MoESpec(n_experts=16, top_k=6, n_shared=n_shared, d_ff_expert=32,
                capacity_factor=capacity_factor)
    p = init_moe(64, m, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 96, 64, generator=torch.Generator().manual_seed(1))
    want = moe_fwd(p, x, m)
    before = launch_counts()
    got = moe_fwd(p.to(cuda_device), x.to(cuda_device), m).cpu()
    assert launch_counts() == before
    assert (got - want).abs().max().item() <= MOE_TOL
    assert torch.equal((got == 0).all(-1), (want == 0).all(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mixtral-8x22b"])
def test_moe_models_on_the_card_match_the_cpu(cuda_device, arch):
    """The smoke model (MLA or GQA attention, MoE FFNs) on the card against
    the same weights on the CPU, float32: train logits and the decode step
    after a prefill within 2e-4·max|ref|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_caches, init_params
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 25),
                           generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda_device):
        model = model.to(dev)
        t = tokens.to(dev)
        train, _ = forward(model, cfg, t, mode="train", kv_block=16)
        caches = init_caches(cfg, 2, 32, dtype=torch.float32, device=dev)
        forward(model, cfg, t[:, :24], mode="prefill", caches=caches,
                kv_block=16)
        dec, _ = forward(model, cfg, t[:, 24:], mode="decode", caches=caches,
                         start=24, kv_block=16)
        outs.append((train.cpu(), dec.cpu()))
    (want, want_dec), (got, got_dec) = outs
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= TF_TOL * top
    assert (got_dec - want_dec).abs().max().item() <= TF_TOL * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [256, 128])
@pytest.mark.parametrize("window", [64, None])
def test_gqa_head_dim_256_takes_the_blockwise_core_on_the_card(
        cuda_device, dtype, head_dim, window):
    """``gqa_fwd`` over a segment at 0 (the kernel's case) on the card
    against the same call on the CPU in float32 on the same values: at
    head_dim 256 (gemma3, recurrentgemma) it runs the blockwise core and
    launches no kernel; at 128 it launches ``flash_attention`` once, on
    ``wgmma`` for bf16.  Float32 within ATTN_TOL; bf16 within
    ATTN_BF16_REL·max|want| + ATTN_TOL (the layer rounds its projections
    to bf16 around the core, so the bound is taken on the output's
    largest value rather than on each element)."""
    import copy
    from repro_torch.models.attention import MaskSpec, gqa_fwd, init_gqa
    from repro_torch.models.config import AttentionSpec
    from repro_torch.train import cast_to_compute
    a = AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=4, head_dim=head_dim,
                      window=window)
    p = cast_to_compute(init_gqa(256, a, torch.Generator().manual_seed(0),
                                 "cpu"), dtype)
    x = torch.randn(2, 256, 256,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    pos = torch.arange(256, dtype=torch.int32)
    ms = MaskSpec(causal=True, window=window)
    want, _ = gqa_fwd(copy.deepcopy(p).float(), x.float(), a, ms, pos,
                      start=0)
    before = launch_counts()
    got, _ = gqa_fwd(p.to(cuda_device), x.to(cuda_device), a, ms,
                     pos.to(cuda_device), start=0)
    torch.cuda.synchronize()
    after = launch_counts()
    launched = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    if head_dim > flash_attention.D_MAX:
        assert not any(launched.values()), launched
    else:
        variant = flash_attention.TC if dtype == torch.bfloat16 \
            else flash_attention.FFMA
        assert launched.get(flash_attention.NAME) == 1, launched
        assert launched.get(variant) == 1, launched
    assert got.dtype == dtype
    tol = ATTN_TOL if dtype == torch.float32 \
        else ATTN_BF16_REL * want.abs().max().item() + ATTN_TOL
    assert (got.cpu().float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_lm_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One smoke-size train step of h2o-danube-3-4b in float32 on the card
    against the same step on the CPU from one seeded state: the loss,
    every gradient leaf (``value_and_grad``, 1e-4·max|ref|) and, after
    ``make_train_step``'s AdamW update, both moments of every leaf (the
    same tolerance; the first update itself is lr times about the sign of
    each gradient element, too sharp to compare between the two), and
    the card's masters against the AdamW formula on the card's own
    moments (1e-5·max|ref|, float64, weight decay where the reference's
    stacked layout has >= 2 dims); the grad-taking pass launches no
    ``flash_attention``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.device import full_fp32_matmul
    from repro_torch.models.model import stacked_names
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_step import value_and_grad
    full_fp32_matmul(cuda_device)
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b", smoke=True),
                              dtype="float32")
    ocfg = OptConfig(lr=1e-3, warmup_steps=0)
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg, ocfg,
                           device="cpu")
    card = init_train_state(torch.Generator().manual_seed(0), cfg, ocfg,
                            device="cpu")
    card["params"].to(cuda_device)
    card["opt"] = {"m": {k: v.to(cuda_device)
                         for k, v in card["opt"]["m"].items()},
                   "v": {k: v.to(cuda_device)
                         for k, v in card["opt"]["v"].items()},
                   "step": card["opt"]["step"].to(cuda_device)}
    batch = SyntheticDataset(cfg.vocab, 48, 2, seed=3).batch_at(0)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_loss, _, want = value_and_grad(cpu["params"], cfg, t, kv_block=16)
    before = launch_counts()
    got_loss, _, got = value_and_grad(
        card["params"], cfg, {k: v.to(cuda_device) for k, v in t.items()},
        kv_block=16)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after.get(flash_attention.NAME, 0) == \
        before.get(flash_attention.NAME, 0)
    assert abs(got_loss.item() - want_loss.item()) <= 1e-4 * abs(
        want_loss.item())
    for k, w in want.items():
        assert (got[k].cpu() - w).abs().max() <= TF_TOL / 2 * w.abs().max(), k
    step = make_train_step(cfg, ocfg, None, 2, kv_block=16)
    p0 = {k: v.double() for k, v in cpu["params"].state_dict().items()}
    step(cpu, batch)
    lr = step(card, batch)[1]["lr"].item()
    for mom in ("m", "v"):
        for k, w in cpu["opt"][mom].items():
            g = card["opt"][mom][k].cpu()
            assert (g - w).abs().max() <= TF_TOL / 2 * w.abs().max(), k
    stacked = stacked_names(card["params"])
    for k, p in card["params"].named_parameters():
        m, v = (card["opt"][x][k].cpu().double() for x in ("m", "v"))
        delta = m / (1 - ocfg.b1) / ((v / (1 - ocfg.b2)).sqrt() + ocfg.eps)
        if p.ndim + (k in stacked) >= 2:
            delta = delta + ocfg.weight_decay * p0[k]
        want = p0[k] - lr * delta
        assert (p.cpu().double() - want).abs().max() <= \
            1e-5 * p0[k].abs().max(), k


@pytest.mark.cuda
def test_spectral_train_step_launches_the_kernels(cuda_device):
    """A 64^3 packed r2c spectral-filter step with ``local_impl="pallas"``
    on the card: ``fft4step``, ``unpack_two_for_one`` and
    ``spectral_scale_full`` launch, and the params after the step are the
    CPU step's within 1e-5·max|ref|."""
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.models.spectral import (init_spectral_filter_params,
                                             spectral_filter_apply)
    from repro_torch.train import make_spectral_train_step
    n = 64
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        plan = Croft3D((n,) * 3, problem="r2c", strategy="packed",
                       opts=FFTOptions(local_impl="pallas"), device=dev)
        g = torch.Generator().manual_seed(0)
        x = torch.randn((n,) * 3, generator=g).to(dev)
        true = {"gate": 1 + 0.3 * torch.randn((n,) * 3, generator=g),
                "filter": 1 + 0.3 * torch.randn(plan.spectrum_shape,
                                                generator=g)}
        with torch.no_grad():
            target = spectral_filter_apply(
                plan, {k: v.to(dev) for k, v in true.items()}, x)
        step, _ = make_spectral_train_step(plan, lr=0.05)
        params = init_spectral_filter_params(None, plan)
        before = launch_counts()
        params, _ = step(params, x, target)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        after = launch_counts()
        out[dev.type] = ({k: v.cpu() for k, v in params.items()},
                         {k: after.get(k, 0) - before.get(k, 0)
                          for k in after})
    (want, _), (got, launched) = out["cpu"], out["cuda"]
    for k in ("fft4step", "unpack_two_for_one", "spectral_scale_full"):
        assert launched.get(k, 0) >= 1, launched
    for k in want:
        assert (got[k] - want[k]).abs().max() <= 1e-5 * want[k].abs().max()
