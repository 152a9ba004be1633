"""The port's gradients (``repro_torch.grad``) against the JAX reference
and ``torch.fft`` autograd, meshless and on the IR.

PyTorch's autograd computes ``A^H g``, JAX's vjp ``A^T ct``: for a
complex input ``x.grad == conj(jax_vjp(conj(g)))``, for a real input
``x.grad == jax_vjp(conj(g))``.  The same numpy inputs go through both
packages: the meshless entry points (both norms, ``"pallas"`` through
the kernels' plain versions and ``"matmul"``), every transposed stage op
against the reference's op, the ``adj-*`` ``describe()`` goldens,
``inverse_schedule``, a dot-product test per plan, conjugate and
stride-0 views, and the primal left bitwise as it was.  The distributed
plans are held by ``tests/test_torch_grad_distributed.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Decomposition as RefDecomposition
from repro.core import FFTOptions as RefOptions
from repro.core import fft3d as ref_fft3d
from repro.core import ifft3d as ref_ifft3d
from repro.core import irfft3d as ref_irfft3d
from repro.core import rfft3d as ref_rfft3d
from repro.core.distributed import build_schedule as ref_build
from repro.grad import adjoint as ref_adjoint
from repro.real import pipeline as ref_pipeline
from test_schedule import GOLDEN
from repro_torch.core import (Croft3D, Decomposition, FFTOptions, fft3d,
                              ifft3d, irfft3d, rfft3d)
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.distributed import build_schedule, inverse_schedule
from repro_torch.grad import adjoint, vjp
from repro_torch.kernels import fft_matmul, flash_attention, hermitian
from repro_torch.kernels import spectral_scale as ss
from repro_torch.kernels import transpose_pack as tp
from repro_torch.real import pipeline

GRAD_TOL = 1e-5      # tests/test_grad.py:39,43,55,60
N = 8
IMPLS = ("pallas", "matmul")
NORMS = (None, "ortho")


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _c(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _grad(fn, x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``x.grad`` of ``fn(x).backward(g)`` on CPU tensors."""
    xt = torch.from_numpy(x).requires_grad_()
    fn(xt).backward(torch.from_numpy(g))
    return xt.grad.numpy()


def _jax_grad(fn, x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The torch-convention gradient from the JAX reference:
    ``conj(vjp(conj g))`` (a real input's is real already)."""
    _, pull = jax.vjp(fn, jnp.asarray(x))
    return np.conj(np.asarray(pull(jnp.asarray(np.conj(g)))[0]))


# --- meshless entry points ----------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("norm", NORMS)
def test_local_c2c_grads_match_torch_and_reference(impl, norm):
    rng = np.random.RandomState(0)
    x, g = _c(rng, N, N, N), _c(rng, N, N, N)
    opts = FFTOptions(local_impl=impl)
    inorm = norm or "backward"
    cases = (
        (lambda v: fft3d(v, opts=opts, norm=norm, device="cpu"),
         lambda v: torch.fft.fftn(v, norm=norm),
         lambda v: ref_fft3d(v, norm=norm)),
        (lambda v: ifft3d(v, opts=opts, norm=inorm, device="cpu"),
         lambda v: torch.fft.ifftn(v, norm=inorm),
         lambda v: ref_ifft3d(v, norm=inorm)),
    )
    for ours, oracle, ref in cases:
        got = _grad(ours, x, g)
        assert _rel(got, _grad(oracle, x, g)) < GRAD_TOL
        assert _rel(got, _jax_grad(ref, x, g)) < GRAD_TOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("norm", NORMS)
def test_local_r2c_grads_match_torch_and_reference(impl, norm):
    rng = np.random.RandomState(1)
    x = rng.randn(N, N, N).astype(np.float32)
    g = _c(rng, N, N, N // 2 + 1)
    opts = FFTOptions(local_impl=impl)
    got = _grad(lambda v: rfft3d(v, opts=opts, norm=norm, strategy="packed",
                                 device="cpu"), x, g)
    assert got.dtype == np.float32
    assert _rel(got, _grad(lambda v: torch.fft.rfftn(v, norm=norm), x, g)) \
        < GRAD_TOL
    assert _rel(got, _jax_grad(lambda v: ref_rfft3d(v, norm=norm), x, g)) \
        < GRAD_TOL
    y = np.fft.rfftn(x).astype(np.complex64)
    gr = rng.randn(N, N, N).astype(np.float32)
    got = _grad(lambda v: irfft3d(v, N, opts=opts, norm=norm,
                                  strategy="packed", device="cpu"), y, gr)
    assert _rel(got, _grad(lambda v: torch.fft.irfftn(v, s=(N,) * 3,
                                                      norm=norm), y, gr)) \
        < GRAD_TOL
    assert _rel(got, _jax_grad(lambda v: ref_irfft3d(v, N, norm=norm),
                               y, gr)) < GRAD_TOL


@pytest.mark.parametrize("strategy,nz", [("packed", 7), ("embed", 8)])
def test_local_r2c_grads_odd_nz_and_embed(strategy, nz):
    """Odd Nz takes the unfolded two-for-one (its own transposes); the
    embedding differentiates through the c2c plan."""
    rng = np.random.RandomState(2)
    opts = FFTOptions(local_impl="xla" if nz % 2 else "pallas")
    x = rng.randn(N, N, nz).astype(np.float32)
    g = _c(rng, N, N, nz // 2 + 1)
    got = _grad(lambda v: rfft3d(v, opts=opts, strategy=strategy,
                                 device="cpu"), x, g)
    assert _rel(got, _grad(torch.fft.rfftn, x, g)) < GRAD_TOL
    y = np.fft.rfftn(x).astype(np.complex64)
    gr = rng.randn(N, N, nz).astype(np.float32)
    got = _grad(lambda v: irfft3d(v, nz, opts=opts, strategy=strategy,
                                  device="cpu"), y, gr)
    assert _rel(got, _grad(lambda v: torch.fft.irfftn(v, s=(N, N, nz)),
                           y, gr)) < GRAD_TOL


@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_local_filtered_grads(problem):
    """``h.grad == conj(s) * g`` and ``x.grad`` through the filter, with
    ``loss = sum |y|^2`` (g = 2 y)."""
    rng = np.random.RandomState(3)
    plan = Croft3D((N,) * 3, problem=problem, device="cpu",
                   opts=FFTOptions(local_impl="pallas"))
    x = (rng.randn(N, N, N).astype(np.float32) if problem == "r2c"
         else _c(rng, N, N, N))
    h = _c(rng, *plan.spectrum_shape)
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    y = plan.forward_filtered(xt, ht, alpha=0.5)
    (y.abs() ** 2).sum().backward()
    x2 = torch.from_numpy(x).requires_grad_()
    h2 = torch.from_numpy(h).requires_grad_()
    fn = torch.fft.rfftn if problem == "r2c" else torch.fft.fftn
    s = fn(x2)
    y2 = s * (0.5 * h2)
    (y2.abs() ** 2).sum().backward()
    assert _rel(y.detach(), y2.detach()) < GRAD_TOL
    assert _rel(xt.grad, x2.grad) < GRAD_TOL
    assert _rel(ht.grad, h2.grad) < GRAD_TOL
    g = 2 * y2.detach()
    assert _rel(ht.grad, 0.5 * torch.conj(s.detach()) * g) < GRAD_TOL


# --- the transposed stage ops -------------------------------------------------

def _ops_cases(rng):
    c = _c(rng, 4, 6, 8)          # a complex block, pair axis 1
    r = rng.randn(4, 6, 8).astype(np.float32)
    return {
        "pack2T": (adjoint.PackTwoT(1), ref_adjoint.PackTwoT(1), c),
        "split2T": (adjoint.SplitPairsT(1), ref_adjoint.SplitPairsT(1), r),
        "unpack2T": (adjoint.UnpackTwoT(1), ref_adjoint.UnpackTwoT(1), c),
        "repack2T": (adjoint.RepackHalvesT(1, 8), ref_adjoint.RepackHalvesT(1, 8),
                     c),
    }


@pytest.mark.parametrize("name", ["pack2T", "split2T", "unpack2T", "repack2T"])
@pytest.mark.parametrize("off", [0, 1])
def test_transposed_ops_match_reference(name, off):
    rng = np.random.RandomState(4)
    ours, ref, blk = _ops_cases(rng)[name]
    if off:
        blk = np.stack([blk, 2 * blk])
    got = ours.apply(torch.from_numpy(blk), None, {}, off)
    want = ref.apply(jnp.asarray(blk), None, {}, off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert ours.describe() == ref.describe()


@pytest.mark.parametrize("which", ["unfold", "fold"])
def test_plane_transposes_match_reference(which):
    rng = np.random.RandomState(5)
    if which == "unfold":
        ct = _c(rng, 2, N, N, N // 2 + 1)
        got = adjoint.unfold_dc_plane_t(torch.from_numpy(ct))
        want = ref_adjoint.unfold_dc_plane_t(jnp.asarray(ct))
    else:
        pbar = _c(rng, 2, N, N, N // 2)
        got = adjoint.fold_dc_plane_t(torch.from_numpy(pbar), N)
        want = ref_adjoint.fold_dc_plane_t(jnp.asarray(pbar), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("fold,n", [(True, 8), (False, 8), (False, 7)])
def test_unpack_and_repack_transposes_are_adjoint(fold, n):
    """``<unpack(C), ab> == <C, unpackT(ab)>`` under the unconjugated real
    pairing Re(sum u * v) of the reference's convention, folded and not,
    and the same for the repack."""
    from repro_torch.real import packing
    rng = np.random.RandomState(6)
    nh = n // 2 if fold else n // 2 + 1
    C = torch.from_numpy(_c(rng, 3, 2, n))
    ab = torch.from_numpy(_c(rng, 3, 4, nh))

    def pair(u, v):
        return float((u.real * v.real - u.imag * v.imag).sum()) \
            if u.is_complex() else float((u * v).sum())
    lhs = pair(packing.unpack_two(C, 1, nh=nh, fold=fold), ab)
    rhs = pair(C, adjoint.unpack_two_t(ab, 1, n, fold))
    assert abs(lhs - rhs) < 1e-4 * abs(lhs)
    lhs = pair(packing.repack_halves(ab, 1, n, folded=fold), C)
    rhs = pair(ab, adjoint.repack_halves_t(C, 1, nh, fold))
    assert abs(lhs - rhs) < 1e-4 * abs(lhs)


# --- adjoint schedules: goldens and the reference's strings ------------------

PENCIL = Decomposition("pencil", ("data", "model"))
SLAB = Decomposition("slab", ("p",))


def _adj_built():
    return {
        "adj-pencil-natural": adjoint.adjoint_schedule(
            build_schedule(PENCIL, FFTOptions())),
        "adj-pencil-spectral": adjoint.adjoint_schedule(
            build_schedule(PENCIL, FFTOptions(output_layout="spectral"))),
        "adj-packed-pencil-fwd": adjoint.adjoint_schedule(
            pipeline.build_packed_forward(PENCIL)),
        "adj-packed-slab-fwd": adjoint.adjoint_schedule(
            pipeline.build_packed_forward(SLAB)),
    }


@pytest.mark.parametrize("key", sorted(k for k in GOLDEN
                                       if k.startswith("adj-")))
def test_adjoint_goldens(key):
    assert _adj_built()[key].describe() == GOLDEN[key]


AXES = {"pencil": ("data", "model"), "slab": ("p",), "cell": ("a", "b", "c"),
        "pencil-folded": (("a", "b"), "c")}


def _pairs():
    out = []
    for kind, axes in AXES.items():
        name = kind.split("-")[0]
        dec, rdec = Decomposition(name, axes), RefDecomposition(name, axes)
        for layout in ("natural", "spectral"):
            for sign in (-1, +1):
                if name == "cell" and layout == "spectral":
                    continue
                out.append((f"{kind}/{layout}/{sign:+d}",
                            build_schedule(dec, FFTOptions(
                                output_layout=layout), sign),
                            ref_build(rdec, RefOptions(output_layout=layout),
                                      sign)))
        if name in ("pencil", "slab") and kind == name:
            out.append((f"{kind}/packed-fwd",
                        pipeline.build_packed_forward(dec),
                        ref_pipeline.build_packed_forward(rdec)))
            out.append((f"{kind}/packed-inv",
                        pipeline.build_packed_inverse(dec, 32),
                        ref_pipeline.build_packed_inverse(rdec, 32)))
    return out


@pytest.mark.parametrize("tag", [t for t, _, _ in _pairs()])
def test_adjoint_schedules_match_reference(tag):
    (ours, want), = [(o, w) for t, o, w in _pairs() if t == tag]
    adj = adjoint.adjoint_schedule(ours)
    assert adj.describe() == ref_adjoint.adjoint_schedule(want).describe()
    # the adjoint of the adjoint is the forward's pipeline again
    assert str(adjoint.adjoint_schedule(adj).layout_out) == str(adj.layout_in)


def test_inverse_schedule_of_c2c_and_refusal_of_packed():
    from repro.core.distributed import inverse_schedule as ref_inverse
    sched = build_schedule(PENCIL, FFTOptions(output_layout="spectral"))
    inv = inverse_schedule(sched)
    assert inv.sign == +1 and inv.name.endswith("^-1")
    assert inv.describe() == ref_inverse(ref_build(
        RefDecomposition("pencil", ("data", "model")),
        RefOptions(output_layout="spectral"))).describe()
    with pytest.raises(ValueError, match="pure c2c"):
        inverse_schedule(pipeline.build_packed_forward(PENCIL))
    # a pipeline with no communicator runs meshless: the inverse inverts
    local = schedule_lib.Schedule(
        "local", -1,
        schedule_lib.Layout(tuple(schedule_lib.LayoutAxis(d) for d in "xyz")),
        tuple(schedule_lib.Stage(f"{d}-fft", fft_axis=i, impl_stage=i)
              for i, d in enumerate("xyz")))
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_c(rng, N, N, N))
    opts = FFTOptions(local_impl="pallas")
    y = schedule_lib.run_schedule(x, local, opts, None)
    back = schedule_lib.run_schedule(y, inverse_schedule(local), opts, None)
    assert _rel(back / N ** 3, x) < GRAD_TOL


# --- dot-product tests: <A x, g> == <x, A^H g> -------------------------------

def _dot(a, b) -> complex:
    return complex(torch.vdot(a.reshape(-1).to(torch.complex128),
                              b.reshape(-1).to(torch.complex128)))


PLANS = {
    "c2c": (lambda v: fft3d(v, opts=FFTOptions(local_impl="pallas"),
                            device="cpu"), True),
    "c2c-inverse-ortho": (lambda v: ifft3d(v, opts=FFTOptions(
        local_impl="pallas"), norm="ortho", device="cpu"), True),
    "r2c-packed": (lambda v: rfft3d(v, opts=FFTOptions(local_impl="pallas"),
                                    strategy="packed", device="cpu"), False),
    "c2r-packed": (lambda v: irfft3d(v, N, opts=FFTOptions(local_impl="pallas"),
                                     strategy="packed", device="cpu"), True),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_dot_product_identity(name):
    """Re<A x, g> == Re<x, A^H g> for every meshless plan (R-linear maps
    hold the real part; C-linear ones the whole inner product)."""
    fn, complex_in = PLANS[name]
    rng = np.random.RandomState(8)
    if name.startswith("c2r"):
        x = np.fft.rfftn(rng.randn(N, N, N)).astype(np.complex64)
    else:
        x = _c(rng, N, N, N) if complex_in else rng.randn(N, N, N).astype(
            np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt)
    g = (torch.from_numpy(_c(rng, *y.shape)) if y.is_complex()
         else torch.from_numpy(rng.randn(*y.shape).astype(np.float32)))
    y.backward(g)
    lhs, rhs = _dot(y.detach(), g), _dot(xt.detach(), xt.grad)
    assert abs(lhs.real - rhs.real) < 1e-5 * abs(lhs)
    if name.startswith("c2c"):
        assert abs(lhs - rhs) < 1e-5 * abs(lhs)


def test_dot_product_identity_filter():
    rng = np.random.RandomState(9)
    s = torch.from_numpy(_c(rng, 4, N, N)).requires_grad_()
    h = torch.from_numpy(_c(rng, 4, N, N)).requires_grad_()
    g = torch.from_numpy(_c(rng, 4, N, N))
    y = vjp.spectral_scale(s, h, 0.5)
    y.backward(g)
    assert abs(_dot(y.detach(), g) - _dot(s.detach(), s.grad)) < 1e-5 * abs(
        _dot(y.detach(), g))
    np.testing.assert_allclose(h.grad.numpy(),
                               (0.5 * torch.conj(s.detach()) * g).numpy(),
                               atol=1e-6)


# --- views: conjugate bits and stride-0 gradients ----------------------------

def _view_cases(rng):
    x3 = torch.from_numpy(_c(rng, 4, 16, 8))
    c = torch.from_numpy(_c(rng, 3, 2, 16))
    s = torch.from_numpy(_c(rng, 3, 4, 8))
    x2, h2 = torch.from_numpy(_c(rng, 6, 32)), torch.from_numpy(_c(rng, 6, 32))
    hb = torch.from_numpy(_c(rng, 32))
    flat = torch.from_numpy(_c(rng, 2 * 4 * 6))
    q = torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32))
    return {
        "fft4step_axis": lambda v: fft_matmul.fft4step_axis(v(x3), 1, -1),
        "unpack_two_for_one": lambda v: hermitian.unpack_two_for_one(v(c), 1),
        "hermitian_extend": lambda v: hermitian.hermitian_extend(v(s), 1, 16),
        "spectral_scale_planes": lambda v: ss.spectral_scale_planes(
            v(x2), v(hb), 0.5),
        "spectral_scale_planes_full": lambda v: ss.spectral_scale_planes_full(
            v(x2), v(h2), 0.5),
        "rotate_block_rows": lambda v: tp.rotate_block_rows(v(flat), 2, 4, 6,
                                                            1),
        "flash_attention": lambda v: flash_attention.flash_attention(
            v(q, neg=True), v(q, neg=True), v(q, neg=True)),
    }


def conj_view(t, neg=False):
    """``t.conj()``, a lazy conjugate; ``neg`` (a real ``t``): ``t``'s
    values behind a lazy negation (the imaginary part of a conjugate)."""
    if neg:
        return torch.complex(torch.zeros_like(t), -t).conj().imag
    return t.conj()


def resolved(t, neg=False):
    return conj_view(t, neg).resolve_conj().resolve_neg()


def _plain(t):
    return t.resolve_conj().resolve_neg()


@pytest.mark.parametrize("name", sorted(_view_cases(np.random.RandomState(0))))
def test_plain_versions_read_conj_views(name):
    """Each wrapper's plain version gives the same answer for a lazy view
    (``x.conj()``, or a negated view) and for its values in memory."""
    fn = _view_cases(np.random.RandomState(10))[name]
    assert torch.equal(_plain(fn(conj_view)), _plain(fn(resolved)))


def test_conj_input_and_broadcast_gradient():
    """A conjugate-view input and the stride-0 gradient of ``y.sum()``
    through the meshless c2c and packed r2c plans."""
    rng = np.random.RandomState(11)
    opts = FFTOptions(local_impl="pallas")
    x = torch.from_numpy(_c(rng, N, N, N))
    got = fft3d(x.conj(), opts=opts, device="cpu")
    want = fft3d(x.conj().resolve_conj(), opts=opts, device="cpu")
    assert torch.equal(got, want)
    assert _rel(got, torch.fft.fftn(torch.conj(x))) < GRAD_TOL
    for fn, oracle, v in (
            (lambda t: fft3d(t, opts=opts, device="cpu"), torch.fft.fftn,
             _c(rng, N, N, N)),
            (lambda t: rfft3d(t, opts=opts, strategy="packed", device="cpu"),
             torch.fft.rfftn, rng.randn(N, N, N).astype(np.float32))):
        a = torch.from_numpy(v).requires_grad_()
        fn(a).sum().abs().backward()
        b = torch.from_numpy(v).requires_grad_()
        oracle(b).sum().abs().backward()
        assert _rel(a.grad, b.grad) < GRAD_TOL
        # a conjugated gradient arrives as a lazy view
        a.grad = None
        y = fn(a)
        y.backward(torch.conj(torch.ones_like(y) * (1 + 2j)))
        b.grad = None
        yb = oracle(b)
        yb.backward(torch.conj(torch.ones_like(yb) * (1 + 2j)))
        assert _rel(a.grad, b.grad) < GRAD_TOL


@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_primal_bitwise_with_and_without_grad(problem):
    """The plans run the pre-grad ops: forward, inverse and the filtered
    forward are bitwise the same whether the input requires grad."""
    rng = np.random.RandomState(12)
    plan = Croft3D((N,) * 3, problem=problem, device="cpu",
                   opts=FFTOptions(local_impl="pallas"))
    x = (torch.from_numpy(rng.randn(N, N, N).astype(np.float32))
         if problem == "r2c" else torch.from_numpy(_c(rng, N, N, N)))
    h = torch.from_numpy(_c(rng, *plan.spectrum_shape))
    y0 = plan.forward(x)
    outs0 = (y0, plan.inverse(y0), plan.forward_filtered(x, h))
    xg, yg = x.clone().requires_grad_(), y0.clone().requires_grad_()
    outs1 = (plan.forward(xg), plan.inverse(yg),
             plan.forward_filtered(xg, h.clone().requires_grad_()))
    for a, b in zip(outs0, outs1):
        assert torch.equal(a, b.detach())
    with torch.no_grad():
        assert torch.equal(plan.forward(xg), y0)


def test_release_clears_the_plans():
    vjp.linear_plan(None, build_schedule(SLAB, FFTOptions()), FFTOptions(),
                    None, 0)
    assert vjp.linear_plan.cache_info().currsize > 0
    Croft3D((N,) * 3, device="cpu").release()
    assert all(c.cache_info().currsize == 0 for c in vjp._CACHES)


GRADCHECK = {
    "c2c": (lambda v: fft3d(v, opts=FFTOptions(local_impl="matmul"),
                            norm="ortho", device="cpu"), torch.complex128),
    "c2c-inverse": (lambda v: ifft3d(v, opts=FFTOptions(local_impl="xla"),
                                     device="cpu"), torch.complex128),
    "r2c-packed": (lambda v: rfft3d(v, opts=FFTOptions(local_impl="matmul"),
                                    strategy="packed", device="cpu"),
                   torch.float64),
    "c2r-packed": (lambda v: irfft3d(v, 4, opts=FFTOptions(
        local_impl="matmul"), strategy="packed", device="cpu"),
        torch.complex128),
}


@pytest.mark.parametrize("name", sorted(GRADCHECK))
def test_gradcheck_meshless(name):
    """``torch.autograd.gradcheck`` (finite differences in float64) on a
    4^3 grid: the plans' backward is the Jacobian's adjoint."""
    fn, dtype = GRADCHECK[name]
    gen = torch.Generator().manual_seed(13)
    shape = (4, 4, 3) if name == "c2r-packed" else (4, 4, 4)
    x = torch.randn(*shape, dtype=dtype, generator=gen).requires_grad_()
    assert torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-6)


def test_gradcheck_filter():
    gen = torch.Generator().manual_seed(14)
    s = torch.randn(3, 5, dtype=torch.complex128, generator=gen)
    h = torch.randn(3, 5, dtype=torch.complex128, generator=gen)
    assert torch.autograd.gradcheck(
        lambda a, b: vjp.spectral_scale(a, b, 0.5),
        (s.requires_grad_(), h.requires_grad_()))
