"""The Poisson solve's k-space multiply, meshless on the CPU: the
multiplier -1/k² computed inside the pass from the three wavenumber
vectors (``kernels/spectral_scale.py:poisson_scale`` and its plain
version) against the expression that once built it at the spectrum's full
shape (k², two ``where``s, the reciprocal, the complex cast, then
``spectral_scale_plain``), to the bit; and ``poisson_solve`` against the
solve through ``forward_filtered`` with that full-shape multiplier, meshless
and on 4 gloo ranks (pencil 2x2 and slab 4), where each rank's block is
held against the same solve with the multiplier cut to its
``output_sharding`` block.  The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``."""

import json
import math

import pytest
import torch

import torch_ranks
from repro_torch.core import (Croft3D, Decomposition, FFTOptions,
                              poisson_solve)
from repro_torch.core import api
from repro_torch.core.decomposition import spec_slices
from repro_torch.kernels import spectral_scale as ss
from repro_torch.obs import metrics

OPTS = FFTOptions(local_impl="pallas")
SHAPE = (8, 16, 16)


def wavenumbers(shape, problem, box=2 * math.pi):
    """kx, ky, kz as ``poisson_solve`` makes them."""
    nx, ny, nz = shape
    kz = (torch.fft.rfftfreq if problem == "r2c" else torch.fft.fftfreq)(
        nz, d=box / (2 * math.pi * nz))
    return (torch.fft.fftfreq(nx, d=box / (2 * math.pi * nx)),
            torch.fft.fftfreq(ny, d=box / (2 * math.pi * ny)), kz)


def full_multiplier(kx, ky, kz, dtype):
    """The multiplier as the solve built it before: at the full shape."""
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    inv_k2 = torch.where(k2 == 0, 0.0, -1.0 / torch.where(k2 == 0, 1.0, k2))
    return inv_k2.to(dtype)


def full_multiply(x, kx, ky, kz, alpha):
    """The multiply as the solve ran it before: the full-shape ``h`` through
    the schedule epilogue's dispatch."""
    return ss.spectral_scale(x, full_multiplier(kx, ky, kz, x.dtype), alpha)


def spectrum(problem, strategy, seed=3, dtype=torch.complex64):
    # fft4step, the pallas local FFT, takes complex64 alone
    opts = OPTS if dtype == torch.complex64 else FFTOptions()
    plan = Croft3D(SHAPE, problem=problem, strategy=strategy, device="cpu",
                   dtype=dtype, opts=opts)
    f = torch.randn(SHAPE, generator=torch.Generator().manual_seed(seed),
                    dtype=plan.input_dtype)
    return plan.forward(f)


def mesh_block(y, coords, k):
    """A (2, 2) pencil mesh's output block at ``coords`` of the spectrum
    ``y``, and the wavenumbers ``k`` cut to it."""
    spec = Decomposition("pencil", ("data", "model")).spectral_spec()
    sl = spec_slices(spec, y.shape, {"data": 2, "model": 2}, coords)
    return y[sl].contiguous(), tuple(v[s] for v, s in zip(k, sl))


CASES = {
    "c2c": ("c2c", None, None, 1.0, torch.complex64),
    "c2c-alpha": ("c2c", None, None, 0.25, torch.complex64),
    "c2c-complex128": ("c2c", None, None, 0.5, torch.complex128),
    "r2c-packed": ("r2c", "packed", None, 1.0, torch.complex64),
    "r2c-embed": ("r2c", "embed", None, 1.0, torch.complex64),
    "r2c-block-with-k0": ("r2c", "packed", {"data": 0, "model": 0}, 1.0,
                          torch.complex64),
    "c2c-block": ("c2c", None, {"data": 1, "model": 1}, 0.25,
                  torch.complex64),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("box", [2 * math.pi, 3.7])
def test_poisson_scale_equals_the_full_shape_multiply(case, box):
    """Box 2π makes every k an integer, so k² is exact; box 3.7 rounds,
    so another order of the sums shows."""
    problem, strategy, coords, alpha, dtype = CASES[case]
    y = spectrum(problem, strategy, dtype=dtype)
    k = wavenumbers(SHAPE, problem, box)
    if coords is not None:
        y, k = mesh_block(y, coords, k)
    holds_k0 = bool((full_multiplier(*k, torch.float32) == 0).any())
    assert holds_k0 == (coords is None or coords["data"] == 0)
    want = full_multiply(y, *k, alpha)
    assert torch.equal(ss.poisson_scale_plain(y, *k, alpha), want)
    assert torch.equal(ss.poisson_scale(y, *k, alpha), want)


def test_poisson_scale_checks_the_vectors():
    y = torch.zeros(4, 8, 5, dtype=torch.complex64)
    kx, ky, kz = torch.zeros(4), torch.zeros(8), torch.zeros(5)
    with pytest.raises(ValueError, match="expected kx"):
        ss.poisson_scale(y, kx, ky, torch.zeros(4))
    with pytest.raises(ValueError, match="expected kx"):
        ss.poisson_scale(y, ky, kx, kz)
    with pytest.raises(ValueError, match="an \\(X, Y, Z\\) block"):
        ss.poisson_scale(y[None], kx, ky, kz)


def parent_solve(rhs, plan, box=2 * math.pi):
    """The solve through ``forward_filtered`` with the full-shape
    multiplier."""
    h = full_multiplier(*wavenumbers(plan.shape, plan.problem, box),
                        plan.dtype)
    return plan.inverse(plan.forward_filtered(rhs.to(plan.input_dtype), h))


SOLVES = [("c2c", None), ("r2c", "packed"), ("r2c", "embed")]


@pytest.mark.parametrize("problem,strategy", SOLVES)
@pytest.mark.parametrize("box", [2 * math.pi, 3.7])
def test_poisson_solve_equals_the_full_shape_solve(problem, strategy, box):
    plan = Croft3D(SHAPE, problem=problem, strategy=strategy, device="cpu",
                   opts=OPTS)
    f = torch.randn(SHAPE, generator=torch.Generator().manual_seed(7))
    assert torch.equal(poisson_solve(f, plan, box),
                       parent_solve(f, plan, box))


def fused_count() -> float:
    found = metrics.get_registry().get(api.POISSON_FUSED)
    return 0.0 if found is None else found.value


@pytest.mark.parametrize("problem,strategy", SOLVES)
def test_a_solve_counts_one_fused_multiplier_and_builds_no_full_one(
        problem, strategy, monkeypatch):
    """``poisson_fused_multipliers`` +1 a solve, +0 a c2c round trip; the
    solve never reaches the full-shape multiply."""
    def refuse(*a, **k):
        raise AssertionError("the full-shape multiply ran")
    for name in ("spectral_scale_planes_full", "spectral_scale_planes",
                 "spectral_scale"):
        monkeypatch.setattr(ss, name, refuse)
    plan = Croft3D(SHAPE, problem=problem, strategy=strategy, device="cpu",
                   opts=OPTS)
    f = torch.randn(SHAPE, generator=torch.Generator().manual_seed(8))
    before = fused_count()
    poisson_solve(f, plan)
    poisson_solve(f, plan)
    assert fused_count() == before + 2
    c2c = Croft3D(SHAPE, device="cpu", opts=OPTS)
    c2c.inverse(c2c.forward(f.to(torch.complex64)))
    assert fused_count() == before + 2


@pytest.mark.parametrize("problem,strategy", SOLVES)
def test_poisson_solve_differentiates_in_rhs(problem, strategy):
    """The gradient through the in-pass multiplier equals the one through
    the full-shape ``h`` (the same real multiply of the cotangent)."""
    plan = Croft3D(SHAPE, problem=problem, strategy=strategy, device="cpu",
                   opts=OPTS)
    gen = torch.Generator().manual_seed(9)
    f = torch.randn(SHAPE, generator=gen)
    w = torch.randn(SHAPE, generator=gen)
    grads = []
    for solve in (poisson_solve, parent_solve):
        x = f.clone().requires_grad_(True)
        u = solve(x, plan)
        ((u.real if u.is_complex() else u) * w).sum().backward()
        grads.append(x.grad)
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-6 * grads[1].abs().max().item())


MESHES = {"pencil": ((2, 2), ("data", "model")), "slab": ((4,), ("p",))}

WORKER = r"""
import json, math, sys
import torch
from torch_ranks import join, leave
from repro_torch.core import Croft3D, Decomposition, make_mesh, poisson_solve
from repro_torch.core import api
from repro_torch.obs import metrics
from test_torch_poisson_scale import OPTS, SHAPE, full_multiplier, wavenumbers
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
join(rank, port, 4)


def fused():
    found = metrics.get_registry().get(api.POISSON_FUSED)
    return 0.0 if found is None else found.value


f = torch.randn(SHAPE, generator=torch.Generator().manual_seed(11))
records, meshes = [], []
for kind, (sizes, names) in %r.items():
    mesh = make_mesh(sizes, names, device="cpu")
    meshes.append(mesh)
    dec = Decomposition(kind, names)
    for problem, strategy in (("c2c", None), ("r2c", "packed"),
                              ("r2c", "embed")):
        plan = Croft3D(SHAPE, mesh, dec, OPTS, problem=problem,
                       strategy=strategy)
        for box in (2 * math.pi, 3.7):
            fl = f[plan.input_sharding].contiguous()
            before = fused()
            got = poisson_solve(fl, plan, box)
            solved = fused()
            h = full_multiplier(*wavenumbers(SHAPE, problem, box),
                                plan.dtype)[plan.output_sharding]
            want = plan.inverse(plan.forward_filtered(
                fl.to(plan.input_dtype), h.contiguous()))
            records.append(dict(
                kind=kind, problem=f"{problem}-{strategy}", box=box,
                shape_ok=tuple(got.shape) == tuple(fl.shape),
                bitwise=bool(torch.equal(got, want)),
                counted=solved == before + 1 and fused() == solved))
with open(f"{out}/rank{rank}.json", "w") as fh:
    json.dump(records, fh)
leave(*meshes)
"""


@pytest.fixture(scope="module")
def mesh_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("poisson_ranks")
    torch_ranks.spawn(WORKER % (MESHES,), 4, [out], out)
    return [r for rank in range(4)
            for r in json.loads((out / f"rank{rank}.json").read_text())]


@pytest.mark.parametrize("problem", ["c2c-None", "r2c-packed", "r2c-embed"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_solve_equals_the_full_shape_solve(mesh_records, kind,
                                                problem):
    """Each rank's solve block, the multiplier computed in the multiply
    after the plan's forward, equals the block of the solve that ran the
    full-shape multiplier, cut to ``output_sharding``, in the forward's
    epilogue."""
    runs = [r for r in mesh_records
            if r["kind"] == kind and r["problem"] == problem]
    assert len(runs) == 4 * 2          # 4 ranks x 2 boxes
    for r in runs:
        assert r["shape_ok"] and r["bitwise"] and r["counted"], r
