"""The port's distributed gradients on 4 gloo ranks against the JAX
reference on a 4-device mesh (``tests/test_grad.py``'s checks).

One reference subprocess computes, on a pencil 2x2 mesh, the gradients
of ``Croft3D.forward`` (c2c and packed r2c, batch 1 and 2) for a given
cotangent, and the folded/unfolded filter forward and gradients.  The
reference's gradients are JAX's ``A^T ct``; the port's autograd gives
``A^H g``, so the reference is run on ``conj(g)`` and conjugated.  One
spawn of 4 torch ranks (gloo, CPU tensors) then runs:

  * the grad matrix: c2c and packed r2c x batch 1 and 2 x the three
    transposes, each rank's block of ``x.grad`` within 1e-4 of the
    reference's and of the alltoall plan's (tests/test_grad.py:65-115);
  * norm-mode gradients of ``fft3d``/``rfft3d`` against ``torch.fft``
    autograd on the whole array (tests/test_grad.py:117-152);
  * the folded and unfolded filtered forward, loss and both gradients
    (tests/test_grad.py:158 onward);
  * a mixed-transpose ``scheduled_fft3d`` (ring, pairwise and alltoall
    stages, per-stage K) whose gradient of ``sum |y|^2`` is held to the
    Parseval identity ``2 N x`` at rtol 1e-3;
  * the linear plans' primal bitwise the same with and without grad,
    the filter without grad the fused schedule epilogue, and
    ``Croft3D.release`` dropping the cached plans.
"""

import dataclasses
import json

import numpy as np
import pytest

import torch_ranks
from conftest import run_multidevice

N = 16
GRAD_TOL = 1e-4      # tests/test_grad.py:110,141,147,205
FWD_TOL = 1e-5       # tests/test_grad.py:189
PROBLEMS = ("c2c", "r2c")
BATCHES = (1, 2)
IMPLS = ("alltoall", "ring", "pairwise")

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D, Decomposition, FFTOptions
N = %d
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
dec = Decomposition("pencil", ("data", "model"))
rng = np.random.RandomState(0)
c = lambda *s: (rng.randn(*s) + 1j * rng.randn(*s)).astype(np.complex64)
out = {"x1": c(N, N, N), "xb": c(2, N, N, N), "g1": c(N, N, N),
       "gb": c(2, N, N, N)}

def tgrad(fn, x, g):
    _, pull = jax.vjp(fn, jnp.asarray(x))
    return np.conj(np.asarray(pull(jnp.asarray(np.conj(g)))[0]))

for problem, kw in (("c2c", {}),
                    ("r2c", {"problem": "r2c", "strategy": "packed"})):
    plan = Croft3D((N, N, N), mesh, dec, FFTOptions(output_layout="spectral"),
                   **kw)
    for batch in (1, 2):
        x, g = (out["x1"], out["g1"]) if batch == 1 else (out["xb"], out["gb"])
        if problem == "r2c":
            x, g = np.real(x).copy(), g[..., :N // 2 + 1]
        fwd = plan.forward if batch == 1 else jax.vmap(plan.forward)
        out[f"grad_{problem}_{batch}"] = tgrad(fwd, x, g)

# the folded filter (tests/test_grad.py:158 onward)
plan = Croft3D((N, N, N), mesh, dec, FFTOptions(), problem="r2c",
               strategy="packed")
xr = rng.randn(N, N, N).astype(np.float32)
neg = jnp.asarray((-np.arange(N)) %% N)
g0 = rng.randn(N, N).astype(np.float32)
gj = 0.5 * (g0 + g0[np.asarray(neg)][:, np.asarray(neg)])
out["xr"], out["gj"] = xr, gj

def loss(g, x, fold):
    ge = 0.5 * (g + g[neg][:, neg])
    h = jnp.broadcast_to(ge[:, :, None], plan.spectrum_shape)
    y = plan.forward_filtered(x, h, fold=fold)
    return jnp.sum(jnp.real(y * jnp.conj(y)))

xj = jax.device_put(jnp.asarray(xr), plan.input_sharding)
h = jnp.broadcast_to(jnp.asarray(gj)[:, :, None], plan.spectrum_shape)
out["y_unfolded"] = np.asarray(plan.forward_filtered(xj, h, fold=False))
l0, (dg, dx) = jax.value_and_grad(lambda g, x: loss(g, x, False),
                                  argnums=(0, 1))(jnp.asarray(gj), xj)
out["loss"], out["dg"], out["dx"] = float(l0), np.asarray(dg), np.asarray(dx)
np.savez(%r, **out)
print("OK reference")
"""

WORKER = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import (Croft3D, Decomposition, FFTOptions, fft3d,
                              make_mesh, rfft3d)
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.distributed import scheduled_fft3d
from repro_torch.grad import vjp
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
join(rank, port, 4)
ref = np.load(npz)
N = ref["x1"].shape[-1]
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
rel = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                         / max(float(np.abs(np.asarray(b)).max()), 1e-30))
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
dec = Decomposition("pencil", ("data", "model"))
records = []

# -- the grad matrix ---------------------------------------------------------
for problem in ("c2c", "r2c"):
    kw = {} if problem == "c2c" else dict(problem="r2c", strategy="packed")
    for batch in (1, 2):
        x, g = ((ref["x1"], ref["g1"]) if batch == 1
                else (ref["xb"], ref["gb"]))
        if problem == "r2c":
            x, g = np.real(x).copy(), g[..., :N // 2 + 1]
        want = ref[f"grad_{problem}_{batch}"]
        grads = {}
        for impl in ("alltoall", "ring", "pairwise"):
            plan = Croft3D((N, N, N), mesh, dec, FFTOptions(
                output_layout="spectral", transpose_impl=impl,
                local_impl="pallas"), **kw)
            isl, osl = plan.input_sharding, plan.output_sharding
            xl = t(x[(Ellipsis,) + isl]).requires_grad_()
            fwd = plan.forward if batch == 1 else plan.forward_batched
            y = fwd(xl)
            y.backward(t(g[(Ellipsis,) + osl]))
            grads[impl] = xl.grad
            records.append(dict(check="matrix", problem=problem, batch=batch,
                                impl=impl, real=not xl.grad.is_complex(),
                                err=rel(xl.grad.numpy(),
                                        want[(Ellipsis,) + isl])))
        for impl in ("ring", "pairwise"):
            records.append(dict(check="impls", problem=problem, batch=batch,
                                impl=impl, err=rel(grads[impl],
                                                   grads["alltoall"])))

# -- norm modes against torch.fft autograd -----------------------------------
opts = FFTOptions(output_layout="spectral", local_impl="pallas")
rng = np.random.RandomState(1)
x = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)).astype(np.complex64)
ct = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)).astype(np.complex64)
for norm in (None, "ortho"):
    for problem in ("c2c", "r2c"):
        xin = x if problem == "c2c" else np.real(x).copy()
        gin = ct if problem == "c2c" else ct[..., :N // 2 + 1].copy()
        full = t(xin).requires_grad_()
        oracle = torch.fft.fftn if problem == "c2c" else torch.fft.rfftn
        oracle(full, norm=norm).backward(t(gin))
        plan = Croft3D((N, N, N), mesh, dec, opts,
                       **({} if problem == "c2c" else
                          dict(problem="r2c", strategy="packed")))
        isl, osl = plan.input_sharding, plan.output_sharding
        xl = t(xin[isl]).requires_grad_()
        if problem == "c2c":
            y = fft3d(xl, mesh, dec, opts, norm=norm)
        else:
            y = rfft3d(xl, mesh, dec, opts, strategy="packed", norm=norm)
        y.backward(t(gin[osl]))
        records.append(dict(check="norm", problem=problem, norm=str(norm),
                            err=rel(xl.grad, full.grad.numpy()[isl])))

# -- folded and unfolded filter ----------------------------------------------
plan = Croft3D((N, N, N), mesh, dec, FFTOptions(local_impl="pallas"),
               problem="r2c", strategy="packed")
neg = torch.tensor((-np.arange(N)) % N)
xr, gj = ref["xr"], ref["gj"]
isl, osl = plan.input_sharding, plan.output_sharding
got = {}
for fold in (False, True):
    g = t(gj).requires_grad_()
    xl = t(xr[isl]).requires_grad_()
    ge = 0.5 * (g + g[neg][:, neg])
    h = ge[:, :, None].expand(plan.spectrum_shape)[osl]
    y = plan.forward_filtered(xl, h, fold=fold)
    loss = (y.abs() ** 2).sum()
    loss.backward()
    total = torch.tensor([float(loss)], dtype=torch.float64)
    dist.all_reduce(total)
    dg = g.grad.clone()
    dist.all_reduce(dg)              # g is every rank's: sum its parts
    got[fold] = (y.detach(), float(total), dg, xl.grad)
    records.append(dict(check="filter", fold=fold,
                        y=rel(y.detach(), ref["y_unfolded"][osl]),
                        loss=abs(float(total) - float(ref["loss"]))
                        / abs(float(ref["loss"])),
                        dg=rel(dg, ref["dg"]), dx=rel(xl.grad, ref["dx"][isl])))
records.append(dict(check="fold-vs-unfold",
                    y=rel(got[True][0], got[False][0]),
                    loss=abs(got[True][1] - got[False][1]) / abs(got[False][1]),
                    dg=rel(got[True][2], got[False][2]),
                    dx=rel(got[True][3], got[False][3])))

# -- a mixed-transpose schedule: Parseval ------------------------------------
base = schedule_lib.build_c2c(dec)
impls = ("ring", "pairwise", "alltoall")
stages = list(base.stages)
for i, (j, st) in enumerate(base.comm_stages()):
    stages[j] = dataclasses.replace(st, transpose_impl=impls[i % 3],
                                    overlap_k=2 - i % 2)
mixed = dataclasses.replace(base, stages=tuple(stages), points=None)
shape = (N, N, N // 2)
xm = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
msl = dec.slices(shape, mesh, mesh.coords, "natural")
xl = t(xm[msl]).requires_grad_()
mopts = FFTOptions(local_impl=("pallas", "matmul", "xla"))
y = scheduled_fft3d(xl, mesh, mixed, mopts)
(y.abs() ** 2).sum().backward()
n = float(np.prod(shape))
want = 2 * n * xm[msl]
records.append(dict(check="parseval", describe=mixed.describe(),
                    # tests/test_schedule.py:648
                    ok=bool(np.allclose(xl.grad.numpy(), want, rtol=1e-3,
                                        atol=1e-3)),
                    err=rel(xl.grad, want)))

# -- dot products: sum over ranks of Re<A x, g> == Re<x, A^H g> -------------
def dot(a, b):
    return float((a.conj() * b).real.sum()) if a.is_complex() else \
        float((a * b).sum())

for name in ("linear", "packed-rfft", "packed-irfft", "filtered"):
    kw = ({} if name in ("linear", "filtered") else
          dict(problem="r2c", strategy="packed"))
    plan = Croft3D((N, N, N), mesh, dec, FFTOptions(
        transpose_impl="ring", local_impl="pallas"), **kw)
    if name == "packed-irfft":
        yl = torch.fft.rfftn(t(np.real(x)))[plan.output_sharding]
        xl = yl.contiguous().requires_grad_()
        y = plan.inverse(xl)
    else:
        xin = np.real(x).copy() if name == "packed-rfft" else x
        xl = t(xin[plan.input_sharding]).requires_grad_()
        y = (plan.forward_filtered(xl, t(ct[plan.output_sharding]))
             if name == "filtered" else plan.forward(xl))
    g = (t(ct[..., :y.shape[-1]][:y.shape[0], :y.shape[1]]) if y.is_complex()
         else t(np.real(ct)[:y.shape[0], :y.shape[1], :y.shape[2]]))
    y.backward(g)
    sums = torch.tensor([dot(y.detach(), g), dot(xl.detach(), xl.grad)],
                        dtype=torch.float64)
    dist.all_reduce(sums)
    records.append(dict(check="dot", plan=name, lhs=float(sums[0]),
                        rhs=float(sums[1])))

# -- the ad-hoc stage shim: one stage of the pencil pipeline -----------------
from repro_torch.core.distributed import _stage
st = schedule_lib.build_c2c(dec).stages[0]
xl = t(x[dec.slices((N, N, N), mesh, mesh.coords)])
got = _stage(xl, fft_axis=st.fft_axis, comm_axis=st.comm_axis,
             split_axis=st.split_axis, concat_axis=st.concat_axis,
             chunk_axis=st.chunk_axis, sign=-1, opts=opts, mesh=mesh)
# the x-FFT, then x <-> y over "data": x sharded by it, y whole
xi, half = mesh.axis_index("data"), N // 2
want = torch.fft.fft(t(x), dim=0)[xi * half:(xi + 1) * half, :,
                                  dec.slices((N, N, N), mesh, mesh.coords)[2]]
records.append(dict(check="stage", err=rel(got, want.numpy())))

# -- the primal without and with grad; release -------------------------------
for problem in ("c2c", "r2c"):
    kw = {} if problem == "c2c" else dict(problem="r2c", strategy="packed")
    plan = Croft3D((N, N, N), mesh, dec, FFTOptions(local_impl="pallas"), **kw)
    xin = x if problem == "c2c" else np.real(x).copy()
    xl = t(xin[plan.input_sharding])
    hl = t(ct[..., :plan.spectrum_shape[-1]][plan.output_sharding])
    y0 = plan.forward(xl)
    plain = (y0, plan.inverse(y0))
    xg, yg = xl.clone().requires_grad_(), y0.clone().requires_grad_()
    graded = (plan.forward(xg), plan.inverse(yg))
    ok = all(torch.equal(a, b.detach()) for a, b in zip(plain, graded))
    if problem == "c2c":
        # without grad the filter stays the fused schedule epilogue
        sched = plan._forward_schedule().with_epilogue(
            schedule_lib.SpectralScale())
        ok &= torch.equal(plan.forward_filtered(xl, hl),
                          schedule_lib.run_schedule(xl, sched, plan.opts, mesh,
                                                    {"filter": hl}))
    records.append(dict(check="bitwise", problem=problem, ok=bool(ok)))
cached = sum(c.cache_info().currsize for c in vjp._CACHES)
plan.release()
records.append(dict(check="release", before=cached,
                    after=sum(c.cache_info().currsize for c in vjp._CACHES)))
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(records, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    run_multidevice(REFERENCE % (N, path), n_devices=4)
    return path


@pytest.fixture(scope="module")
def port_records(reference_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER, 4, [reference_path, out], out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


def _records(port_records, check, **match):
    return [r for recs in port_records for r in recs if r["check"] == check
            and all(r.get(k) == v for k, v in match.items())]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_grad_matrix_matches_reference(port_records, problem, batch, impl):
    runs = _records(port_records, "matrix", problem=problem, batch=batch,
                    impl=impl)
    assert len(runs) == 4
    for r in runs:
        assert r["err"] < GRAD_TOL, r
        # a real input's gradient is real
        assert r["real"] == (problem == "r2c"), r


@pytest.mark.parametrize("impl", ["ring", "pairwise"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_grad_impls_agree_with_alltoall(port_records, problem, batch, impl):
    runs = _records(port_records, "impls", problem=problem, batch=batch,
                    impl=impl)
    assert len(runs) == 4 and all(r["err"] < GRAD_TOL for r in runs), runs


@pytest.mark.parametrize("norm", ["None", "ortho"])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_norm_mode_grads_match_torch_fft(port_records, problem, norm):
    runs = _records(port_records, "norm", problem=problem, norm=norm)
    assert len(runs) == 4 and all(r["err"] < GRAD_TOL for r in runs), runs


@pytest.mark.parametrize("fold", [False, True])
def test_filter_forward_and_grads_match_reference(port_records, fold):
    runs = _records(port_records, "filter", fold=fold)
    assert len(runs) == 4
    for r in runs:
        assert r["y"] < FWD_TOL and r["loss"] < FWD_TOL, r
        assert r["dg"] < GRAD_TOL and r["dx"] < GRAD_TOL, r


def test_folded_filter_equals_unfolded(port_records):
    runs = _records(port_records, "fold-vs-unfold")
    assert len(runs) == 4
    for r in runs:
        assert r["y"] < FWD_TOL and r["loss"] < FWD_TOL, r
        assert r["dg"] < GRAD_TOL and r["dx"] < GRAD_TOL, r


def test_mixed_schedule_grad_is_parseval(port_records):
    runs = _records(port_records, "parseval")
    assert len(runs) == 4
    # the schedule mixes all three transposes and both K
    assert all(s in runs[0]["describe"] for s in (
        "impl=ring", "impl=pairwise", "impl=alltoall", "K=1", "K=2"))
    assert all(r["ok"] for r in runs), runs


@pytest.mark.parametrize("problem", PROBLEMS)
def test_distributed_primal_bitwise_under_grad(port_records, problem):
    runs = _records(port_records, "bitwise", problem=problem)
    assert len(runs) == 4 and all(r["ok"] for r in runs), runs


@pytest.mark.parametrize("plan", ["linear", "packed-rfft", "packed-irfft",
                                  "filtered"])
def test_dot_product_identity_distributed(port_records, plan):
    """Summed over the ranks, Re<A x, g> == Re<x, A^H g> for each plan
    (the ring transpose, so the adjoint's rounds run too)."""
    runs = _records(port_records, "dot", plan=plan)
    assert len(runs) == 4
    for r in runs:
        assert abs(r["lhs"] - r["rhs"]) < 1e-5 * abs(r["lhs"]), r


def test_stage_shim_runs_one_stage(port_records):
    runs = _records(port_records, "stage")
    assert len(runs) == 4 and all(r["err"] < 1e-5 for r in runs), runs


def test_release_drops_distributed_plans(port_records):
    for r in _records(port_records, "release"):
        assert r["before"] > 0 and r["after"] == 0, r
