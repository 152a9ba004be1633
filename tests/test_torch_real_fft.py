"""The port's real transforms and spectral epilogue against the JAX
reference, meshless: the packing primitives, the plain versions of the
Hermitian and spectral-scale kernels (against the Pallas kernels in
interpret mode), local packed/embed r2c and c2r for every local impl,
the strategy resolution, the packed ``describe()`` goldens, and
``forward_filtered``/``poisson_solve``.  The same inputs, made with
numpy, go through both packages.  The Hopper kernels themselves are held
against these plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import real as ref_real
from repro.core import Croft3D as RefCroft3D
from repro.core import Decomposition as RefDecomposition
from repro.core import FFTOptions as RefOptions
from repro.core import poisson_solve as ref_poisson_solve
from repro.core import rfft as ref_rfft
from repro.core import schedule as ref_schedule
from repro.kernels import hermitian as ref_hermitian
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels import spectral_scale as ref_ss
from repro.real import packing as ref_packing
from repro.real import pipeline as ref_pipeline
from test_schedule import GOLDEN
from repro_torch import real
from repro_torch.core import (Croft3D, Decomposition, FFTOptions,
                              poisson_solve, rfft)
from repro_torch.core import schedule as schedule_lib
from repro_torch.kernels import hermitian, ops, ref, spectral_scale
from repro_torch.real import packing, pipeline

HERM_TOL = 1e-6      # tests/test_real_fft.py:149
SCALE_TOL = 1e-5     # tests/test_kernels_fft.py:68
FWD_TOL = 3e-5       # tests/test_real_fft.py:44, relative to max|ref|
RT_TOL = 2e-5        # tests/test_real_fft.py:47
PALLAS_TOL = 5e-5    # tests/test_real_fft.py:160, relative to max|ref|


def _real(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _cplx(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# --- packing primitives ------------------------------------------------------

def test_dtypes_and_negate_freq():
    assert packing.complex_dtype_for(torch.float32) == torch.complex64
    assert packing.complex_dtype_for(torch.float64) == torch.complex128
    assert packing.real_dtype_for(torch.complex128) == torch.float64
    assert packing.real_dtype_for(torch.complex64) == torch.float32
    a = _cplx((3, 5, 6))
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(
            packing.negate_freq(_t(a), axis).numpy(),
            np.asarray(ref_packing.negate_freq(jnp.asarray(a), axis)))


@pytest.mark.parametrize("pair_axis", [0, 1, -2])
def test_pack_two_and_split_pairs_match_reference(pair_axis):
    x = _real((4, 6, 8), seed=1)
    got = packing.pack_two(_t(x), pair_axis)
    want = ref_packing.pack_two(jnp.asarray(x), pair_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        packing.split_pairs(got, pair_axis).numpy(),
        np.asarray(ref_packing.split_pairs(want, pair_axis)))
    with pytest.raises(ValueError, match="even"):
        packing.pack_two(_t(_real((3, 5, 8))), 0)


@pytest.mark.parametrize("n,fold,nh", [(16, True, None), (16, False, None),
                                       (15, False, None), (15, False, 8),
                                       (32, False, 17)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_unpack_and_repack_match_reference(n, fold, nh, use_pallas):
    C = _cplx((4, 3, n), seed=n)
    got = packing.unpack_two(_t(C), 1, nh=nh, fold=fold,
                             use_pallas=use_pallas)
    want = ref_packing.unpack_two(jnp.asarray(C), 1, nh=nh, fold=fold,
                                  use_pallas=use_pallas)
    _close(got, want, HERM_TOL)
    if fold or nh is None or nh == n // 2 + 1:
        back = packing.repack_halves(got, 1, n, folded=fold,
                                     use_pallas=use_pallas)
        ref_back = ref_packing.repack_halves(want, 1, n, folded=fold,
                                             use_pallas=use_pallas)
        _close(back, ref_back, HERM_TOL)


def test_unpack_fold_rejects_odd_n():
    with pytest.raises(ValueError, match="even"):
        packing.unpack_two(_t(_cplx((2, 2, 15))), 0, fold=True)


# --- the Hermitian kernels' plain versions vs the Pallas kernels --------------

@pytest.mark.parametrize("n", [16, 64, 256])
def test_hermitian_plain_matches_pallas(n):
    C = _cplx((8, 4, n), seed=n)
    rows = C.reshape(-1, n)
    ar, ai, br, bi = ref_hermitian.unpack_two_for_one_planes(
        jnp.asarray(rows.real), jnp.asarray(rows.imag), interpret=True)
    A = (np.asarray(ar) + 1j * np.asarray(ai)).reshape(8, 4, n // 2)
    B = (np.asarray(br) + 1j * np.asarray(bi)).reshape(8, 4, n // 2)
    # pair axis 1: A fills its first half, B its second
    got = hermitian.unpack_two_for_one(_t(C), 1)
    _close(got, np.concatenate([A, B], axis=1), HERM_TOL)
    assert torch.equal(got, hermitian.unpack_two_for_one_plain(_t(C), 1))
    S = got.numpy()
    SA, SB = S[:, :4].reshape(-1, n // 2), S[:, 4:].reshape(-1, n // 2)
    cr, ci = ref_hermitian.hermitian_extend_planes(
        jnp.asarray(SA.real), jnp.asarray(SA.imag), jnp.asarray(SB.real),
        jnp.asarray(SB.imag), interpret=True)
    want = (np.asarray(cr) + 1j * np.asarray(ci)).reshape(8, 4, n)
    back = hermitian.hermitian_extend(got, 1, n)
    _close(back, want, HERM_TOL)
    _close(back, C, 1e-5)           # the exact inverse, up to rounding


@pytest.mark.parametrize("shape,pair_axis", [((6, 4, 2, 8), 0),
                                             ((2, 6, 3, 16), 1),
                                             ((2, 3, 4, 32), 2)])
def test_hermitian_plain_pair_axis_views(shape, pair_axis):
    """Any pair axis before the transform axis: the kernel's (outer, L, n)
    view against the reference's unpack + concatenate."""
    C = _cplx(shape, seed=len(shape))
    got = hermitian.unpack_two_for_one(_t(C), pair_axis)
    want = ref_packing.unpack_two(jnp.asarray(C), pair_axis, fold=True)
    _close(got, want, HERM_TOL)
    back = hermitian.hermitian_extend(got, pair_axis, shape[-1])
    _close(back, ref_packing.repack_halves(want, pair_axis, shape[-1],
                                           folded=True), HERM_TOL)
    with pytest.raises(ValueError, match="transform axis"):
        hermitian.unpack_two_for_one(_t(C), len(shape) - 1)


# --- spectral scale: plain versions vs the Pallas kernels ----------------------

@pytest.mark.parametrize("alpha", [1.0, 0.25, -3.0])
def test_spectral_scale_plain_matches_pallas(alpha):
    x = _cplx((12, 64), seed=2)
    hb = _cplx((64,), seed=3)
    hf = _cplx((12, 64), seed=4)
    planes = lambda a: (jnp.asarray(a.real), jnp.asarray(a.imag))
    yr, yi = ref_ss.spectral_scale_planes(*planes(x), *planes(hb), alpha,
                                          interpret=True)
    want_b = np.asarray(yr) + 1j * np.asarray(yi)
    yr, yi = ref_ss.spectral_scale_planes_full(*planes(x), *planes(hf), alpha,
                                               interpret=True)
    want_f = np.asarray(yr) + 1j * np.asarray(yi)
    got_b = spectral_scale.spectral_scale_planes(_t(x), _t(hb), alpha)
    got_f = spectral_scale.spectral_scale_planes_full(_t(x), _t(hf), alpha)
    _close(got_b, want_b, SCALE_TOL * np.abs(want_b).max())
    _close(got_f, want_f, SCALE_TOL * np.abs(want_f).max())
    # the plain version repeats the kernel's order: alpha before the product
    oracle = ref.ref_spectral_scale(_t(x), _t(hf), alpha)
    np.testing.assert_allclose(
        got_f.numpy(), np.asarray(ref_oracles.ref_spectral_scale(
            jnp.asarray(x), jnp.asarray(hf), alpha)),
        atol=SCALE_TOL * np.abs(want_f).max())
    _close(got_f, oracle, SCALE_TOL * np.abs(want_f).max())


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_spectral_scale_op_matches_reference(alpha):
    x = _cplx((2, 5, 32), seed=5)
    h = _cplx((32,), seed=6)
    got = ops.spectral_scale_op(_t(x), _t(h), alpha, device="cpu")
    want = np.asarray(ref_ops.spectral_scale_op(jnp.asarray(x),
                                                jnp.asarray(h), alpha))
    _close(got, want, SCALE_TOL * np.abs(want).max())


@pytest.mark.parametrize("hshape", [(4, 6, 8), (8,), (1, 6, 8)])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_spectral_scale_dispatch_matches_reference(hshape, alpha):
    """Same-shape complex64 filters go to the kernel's plain version,
    anything else to the plain expression — both equal the reference."""
    x = _cplx((4, 6, 8), seed=7)
    h = _cplx(hshape, seed=8)
    got = spectral_scale.spectral_scale(_t(x), _t(h), alpha)
    want = np.asarray(ref_ss.spectral_scale(jnp.asarray(x), jnp.asarray(h),
                                            alpha))
    _close(got, want, SCALE_TOL * np.abs(want).max())


def test_spectral_scale_wrappers_check_shapes():
    x = torch.zeros(4, 8, dtype=torch.complex64)
    with pytest.raises(ValueError):
        spectral_scale.spectral_scale_planes(x, torch.zeros(4, 8))
    with pytest.raises(ValueError):
        spectral_scale.spectral_scale_planes_full(x, torch.zeros(8))


# --- local packed / embed r2c and c2r ------------------------------------------

IMPL_CASES = [((8, 4, 16), impl) for impl in ("matmul", "stockham", "xla",
                                              "pallas")]
# even Nz pairs along y; odd Nz (fold-free, all Nh bins); odd Ny pairs
# along x — the shapes of tests/test_real_fft.py:30-36
PACKED_CASES = [(shape, impl, None) for shape, impl in IMPL_CASES]
PACKED_CASES += [((8, 4, 16), "xla", "ortho"), ((8, 4, 16), "pallas", "ortho"),
                 ((4, 8, 32), "pallas", None), ((8, 4, 15), "xla", "ortho"),
                 ((9, 6, 15), "xla", None), ((8, 9, 12), "xla", None)]


@pytest.mark.parametrize("shape,impl,norm", PACKED_CASES)
def test_local_packed_matches_reference(shape, impl, norm):
    x = _real(shape, seed=sum(shape))
    nz = shape[-1]
    opts, ref_opts = FFTOptions(local_impl=impl), RefOptions(local_impl=impl)
    got = real.local_rfft3d_packed(_t(x), opts, norm=norm)
    want = np.asarray(ref_real.local_rfft3d_packed(jnp.asarray(x), ref_opts,
                                                   norm=norm))
    tol = PALLAS_TOL if impl == "pallas" else FWD_TOL
    _close(got, want, tol * np.abs(want).max())
    _close(got, np.fft.rfftn(x, norm=norm or "backward"),
           tol * np.abs(want).max())
    back = real.local_irfft3d_packed(got, nz, opts, norm=norm)
    _close(back, ref_real.local_irfft3d_packed(jnp.asarray(want), nz,
                                               ref_opts, norm=norm), RT_TOL)
    _close(back, x, RT_TOL)


@pytest.mark.parametrize("shape,impl", IMPL_CASES + [((9, 6, 15), "xla")])
def test_local_embed_matches_reference(shape, impl):
    x = _real(shape, seed=3)
    nz = shape[-1]
    opts, ref_opts = FFTOptions(local_impl=impl), RefOptions(local_impl=impl)
    got = rfft.rfft3d(_t(x), opts=opts, strategy="embed", device="cpu")
    want = np.asarray(ref_rfft.rfft3d(jnp.asarray(x), opts=ref_opts,
                                      strategy="embed"))
    _close(got, want, FWD_TOL * np.abs(want).max())
    back = rfft.irfft3d(got, nz, opts=opts, strategy="embed", device="cpu")
    _close(back, ref_rfft.irfft3d(jnp.asarray(want), nz, opts=ref_opts,
                                  strategy="embed"), RT_TOL)
    assert back.dtype == torch.float32


@pytest.mark.parametrize("nz", [8, 15])
@pytest.mark.parametrize("strategy", ["packed", "embed"])
def test_c2r_non_hermitian_input_matches_reference(nz, strategy):
    """The DC/Nyquist plane projection of a non-Hermitian half spectrum
    (a derivative filter's surviving Nyquist plane), as in
    tests/test_real_fft.py:119-137."""
    n = 8
    x = np.random.RandomState(nz).randn(n, n, nz)
    kx = np.fft.fftfreq(n, d=1.0 / n)[:, None, None]
    y = (1j * kx * np.fft.rfftn(x) * (1 + 0.3j)).astype(np.complex64)
    opts = FFTOptions(local_impl="xla")
    got = rfft.irfft3d(_t(y), nz, opts=opts, strategy=strategy, device="cpu")
    want = np.asarray(ref_rfft.irfft3d(jnp.asarray(y), nz,
                                       opts=RefOptions(local_impl="xla"),
                                       strategy=strategy))
    ref_np = np.fft.irfftn(y, s=(n, n, nz), axes=(0, 1, 2))
    _close(got, want, 2e-6 * np.abs(ref_np).max())
    _close(got, ref_np, 2e-6 * np.abs(ref_np).max())


def test_rfft3d_rejects_complex_and_bad_strategy():
    with pytest.raises(ValueError, match="real"):
        rfft.rfft3d(torch.ones(4, 4, 4, dtype=torch.complex64), device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        rfft.rfft3d(torch.ones(4, 4, 4), strategy="bogus", device="cpu")
    with pytest.raises(ValueError, match="packed"):
        rfft.rfft3d(torch.ones(9, 9, 15), strategy="packed", device="cpu")
    with pytest.raises(ValueError, match="fold_filter"):
        rfft.rfft3d(torch.ones(4, 4, 4), kspace_filter=torch.ones(4, 4, 3),
                    fold_filter=True, device="cpu")


def test_batched_local_r2c_equals_per_field():
    x = _real((3, 8, 4, 16), seed=9)
    plan = Croft3D((8, 4, 16), problem="r2c", device="cpu",
                   opts=FFTOptions(local_impl="pallas"))
    y = plan.forward_batched(_t(x))
    for b in range(3):
        assert torch.equal(y[b], plan.forward(_t(x[b])))
    back = plan.inverse_batched(y)
    _close(back, x, RT_TOL)


# --- strategy resolution --------------------------------------------------------

class _FakeMesh:
    """Axis sizes for both packages' resolution code: the reference reads
    ``devices.shape``, the port ``shape``."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.size = math.prod(self.shape.values())
        self.devices = np.empty(tuple(self.shape.values()))


MESHES = [
    (None, None),
    ({"data": 2, "model": 4}, ("pencil", ("data", "model"))),
    ({"p": 8}, ("slab", ("p",))),
    ({"a": 2, "b": 2, "c": 2}, ("cell", ("a", "b", "c"))),
    ({"a": 2, "b": 2, "c": 2}, ("pencil", (("a", "b"), "c"))),
    ({"p": 1}, ("slab", ("p",))),
    ({"data": 2, "model": 4}, ("pencil", ("data", "nope"))),
]
SHAPES = [(32, 32, 32), (32, 8, 32), (32, 32, 30), (32, 32, 15), (9, 9, 16),
          (8, 9, 12), (16, 8, 8), (12, 24, 16), (32, 16, 4)]


@pytest.mark.parametrize("mesh_case", range(len(MESHES)))
@pytest.mark.parametrize("impl", ["alltoall", "ring"])
def test_resolve_strategy_matches_reference(mesh_case, impl):
    sizes, dec_spec = MESHES[mesh_case]
    mesh = None if sizes is None else _FakeMesh(sizes)
    dec = None if dec_spec is None else Decomposition(*dec_spec)
    ref_dec = None if dec_spec is None else RefDecomposition(*dec_spec)
    opts, ref_opts = (FFTOptions(transpose_impl=impl),
                      RefOptions(transpose_impl=impl))
    for shape in SHAPES:
        assert real.unsupported_reason(shape, mesh, dec, opts) == \
            ref_real.unsupported_reason(shape, mesh, ref_dec, ref_opts)
        if mesh is not None:
            assert real.packed_unsupported_reason(shape, dec, sizes, opts) == \
                ref_pipeline.packed_unsupported_reason(shape, ref_dec, sizes,
                                                       ref_opts)
        for strategy in (None, "auto", "packed", "embed", "bogus"):
            try:
                want = ref_real.resolve_strategy(strategy, shape, mesh,
                                                 ref_dec, ref_opts)
            except ValueError as e:
                with pytest.raises(ValueError) as info:
                    real.resolve_strategy(strategy, shape, mesh, dec, opts)
                assert str(info.value) == str(e)
                continue
            assert real.resolve_strategy(strategy, shape, mesh, dec,
                                         opts) == want
    assert real.packed_local_reason((9, 9, 4)) == \
        ref_real.packed_local_reason((9, 9, 4))


# --- packed schedules: the goldens ----------------------------------------------

PENCIL = Decomposition("pencil", ("data", "model"))
SLAB = Decomposition("slab", ("p",))


@pytest.mark.parametrize("key", ["packed-pencil-fwd", "packed-pencil-inv",
                                 "packed-slab-fwd", "packed-slab-inv"])
def test_packed_describe_matches_golden(key):
    dec = PENCIL if "pencil" in key else SLAB
    sched = (pipeline.build_packed_forward(dec) if key.endswith("fwd")
             else pipeline.build_packed_inverse(dec, 32))
    assert sched.describe() == GOLDEN[key]
    ref_dec = RefDecomposition(dec.kind, dec.axes)
    want = (ref_pipeline.build_packed_forward(ref_dec) if key.endswith("fwd")
            else ref_pipeline.build_packed_inverse(ref_dec, 32))
    sizes = {"data": 2, "model": 4, "p": 8}
    for shape in ((32, 32, 32), (64, 16, 8)):
        assert sched.fft_events(shape, sizes) == want.fft_events(shape, sizes)
        assert sched.comm_events(shape, sizes) == want.comm_events(shape,
                                                                   sizes)
        for k in (1, 2, 4):
            assert sched.effective_k(shape, sizes, k) == \
                want.effective_k(shape, sizes, k)
    assert sched.transpose_count() == want.transpose_count()


def test_with_epilogue_structure():
    """tests/test_schedule.py:570-581, on the port."""
    from repro_torch.core.distributed import build_schedule
    sched = build_schedule(PENCIL, FFTOptions(output_layout="spectral"))
    fused = sched.with_epilogue(schedule_lib.SpectralScale())
    assert len(fused.epilogue) == 1
    assert "kscale[filter]" in fused.describe()
    assert fused.layout_out == sched.layout_out
    ref_fused = ref_schedule.Schedule.with_epilogue(
        ref_pipeline.build_packed_forward(RefDecomposition(
            "pencil", ("data", "model"))), ref_schedule.SpectralScale())
    ours = pipeline.build_packed_forward(PENCIL).with_epilogue(
        schedule_lib.SpectralScale())
    assert ours.describe() == ref_fused.describe()
    with pytest.raises(schedule_lib.ScheduleError, match="filter"):
        schedule_lib.SpectralScale().apply(
            torch.ones(2, 2, 2, dtype=torch.complex64), FFTOptions(), {}, 0)


def test_stage_op_layout_errors():
    lay = schedule_lib.layout_for(PENCIL, "spectral")
    with pytest.raises(schedule_lib.ScheduleError, match="real"):
        schedule_lib.PackTwo(1).transform(lay)
    with pytest.raises(schedule_lib.ScheduleError, match="complex"):
        schedule_lib.SplitPairs(1).transform(
            schedule_lib.layout_for(PENCIL, "spectral", real=True))
    with pytest.raises(schedule_lib.ScheduleError, match="divide"):
        lay.with_den(2, div=2)


# --- forward_filtered and poisson_solve, meshless --------------------------------

@pytest.mark.parametrize("problem", ["c2c", "r2c"])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_forward_filtered_matches_reference(problem, alpha):
    shape = (8, 8, 16)
    x = (_real(shape, seed=11) if problem == "r2c"
         else _cplx(shape, seed=11))
    hshape = shape[:2] + (9,) if problem == "r2c" else shape
    h = _cplx(hshape, seed=12)
    plan = Croft3D(shape, problem=problem, device="cpu",
                   opts=FFTOptions(local_impl="pallas"))
    ref_plan = RefCroft3D(shape, problem=problem,
                          opts=RefOptions(local_impl="pallas"))
    got = plan.forward_filtered(_t(x), _t(h), alpha)
    want = np.asarray(ref_plan.forward_filtered(jnp.asarray(x),
                                                jnp.asarray(h), alpha))
    _close(got, want, PALLAS_TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="fold"):
        plan.forward_filtered(_t(x), _t(h), fold=True)


@pytest.mark.parametrize("problem,strategy", [("c2c", None),
                                              ("r2c", "packed"),
                                              ("r2c", "embed")])
def test_poisson_solve_matches_reference(problem, strategy):
    shape = (8, 16, 8)
    f = _real(shape, seed=13)
    f -= f.mean()
    plan = Croft3D(shape, problem=problem, strategy=strategy, device="cpu")
    ref_plan = RefCroft3D(shape, problem=problem, strategy=strategy)
    got = poisson_solve(_t(f), plan)
    want = np.real(np.asarray(ref_poisson_solve(jnp.asarray(f), ref_plan)))
    if problem == "c2c":
        got = got.real
    _close(got, want, 1e-5 * np.abs(want).max())
    assert plan.spectrum_shape == ref_plan.spectrum_shape
    assert plan.input_dtype == (torch.float32 if problem == "r2c"
                                else torch.complex64)
    assert plan.flops_model() == pytest.approx(ref_plan.flops_model())
