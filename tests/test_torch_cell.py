"""The cell decomposition, folded mesh axes and the distributed embed on
8 gloo ranks against the JAX reference on an 8-device mesh.

One reference subprocess runs ``repro.core.Croft3D`` on a 2x2x2 mesh —
cell, and pencil over the folded axis ``(("a", "b"), "c")`` — forward,
inverse and the gradient of the forward for a given cotangent, and the
r2c embed strategy on pencil 2x4, slab 8 and cell 2x2x2 (forward and
its gradient).  One spawn of 8 torch ranks (gloo, CPU tensors) runs the
port on the same meshes and holds each rank's block against its slice
of the reference's global arrays:

  * c2c within 1e-5 of max|ref|, round trips within 1e-4
    (tests/test_distributed_fft.py:46-58, 98-118), for K in {1, 2};
  * the embed r2c within 5e-5 of max|ref| (tests/test_real_fft.py:160)
    and its c2r round trip within 1e-4;
  * gradients within 1e-4 (tests/test_grad.py:110) under the port's
    convention ``x.grad == conj(jax_vjp(conj g))``.
"""

import json
import math

import numpy as np
import pytest
import torch

import torch_ranks
from conftest import run_multidevice
from repro_torch.core import Croft3D, Decomposition, FFTOptions

N = 16
REL_TOL = 1e-5   # tests/test_distributed_fft.py:27
RT_TOL = 1e-4    # tests/test_distributed_fft.py:28
RFFT_TOL = 5e-5  # tests/test_real_fft.py:160
GRAD_TOL = 1e-4  # tests/test_grad.py:110
C2C = {"cell": ((2, 2, 2), ("a", "b", "c"), ("a", "b", "c")),
       "pencil-folded": ((2, 2, 2), ("a", "b", "c"), (("a", "b"), "c"))}
EMBED = {"pencil": ((2, 4), ("y", "z"), ("y", "z")),
         "slab": ((8,), ("p",), ("p",)),
         "cell": ((2, 2, 2), ("a", "b", "c"), ("a", "b", "c"))}

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D, Decomposition, FFTOptions
N = %d
rng = np.random.RandomState(42)
c = lambda *s: (rng.randn(*s) + 1j * rng.randn(*s)).astype(np.complex64)
x, g = c(N, N, N), c(N, N, N)
xr = rng.randn(N, N, N).astype(np.float32)
out = {"x": x, "g": g, "xr": xr}
auto = jax.sharding.AxisType.Auto

def tgrad(fn, v, ct):
    _, pull = jax.vjp(fn, jnp.asarray(v))
    return np.conj(np.asarray(pull(jnp.asarray(np.conj(ct)))[0]))

for kind, (sizes, names, axes) in %r.items():
    mesh = jax.make_mesh(sizes, names, axis_types=(auto,) * len(sizes))
    plan = Croft3D((N, N, N), mesh, Decomposition(kind.split("-")[0], axes),
                   FFTOptions())
    y = plan.forward(jax.device_put(jnp.asarray(x), plan.input_sharding))
    out[f"y_{kind}"] = np.asarray(y)
    out[f"xb_{kind}"] = np.asarray(plan.inverse(y))
    out[f"grad_{kind}"] = tgrad(plan.forward, x, g)
for kind, (sizes, names, axes) in %r.items():
    mesh = jax.make_mesh(sizes, names, axis_types=(auto,) * len(sizes))
    plan = Croft3D((N, N, N), mesh, Decomposition(kind, axes), FFTOptions(),
                   problem="r2c", strategy="embed")
    y = plan.forward(jax.device_put(jnp.asarray(xr), plan.input_sharding))
    out[f"embed_{kind}"] = np.asarray(y)
    out[f"embed_grad_{kind}"] = tgrad(plan.forward, xr, g[..., :N // 2 + 1])
np.savez(%r, **out)
print("OK reference")
"""

WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
join(rank, port, 8)
ref = np.load(npz)
x, g, xr = ref["x"], ref["g"], ref["xr"]
N = x.shape[0]
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
rel = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                         / max(float(np.abs(np.asarray(b)).max()), 1e-30))
records = []
meshes = {}
def mesh_of(sizes, names):
    # every rank makes every mesh in the same order (its groups are
    # collective over the world)
    key = (sizes, names)
    if key not in meshes:
        meshes[key] = make_mesh(sizes, names, device="cpu")
    return meshes[key]

for kind, (sizes, names, axes) in %r.items():
    mesh = mesh_of(tuple(sizes), tuple(names))
    dec = Decomposition(kind.split("-")[0], tuple(
        tuple(a) if isinstance(a, list) else a for a in axes))
    want = ref[f"y_{kind}"]
    for k in (1, 2):
        plan = Croft3D((N, N, N), mesh, dec, FFTOptions(
            overlap_k=k, local_impl="pallas"))
        isl, osl = plan.input_sharding, plan.output_sharding
        xl = t(x[isl]).requires_grad_()
        y = plan.forward(xl)
        xb = plan.inverse(y.detach())
        y.backward(t(g[osl]))
        records.append(dict(
            check="c2c", kind=kind, k=k,
            err=float(np.abs(y.detach().numpy() - want[osl]).max()
                      / np.abs(want).max()),
            inv_err=float(np.abs(xb.numpy() - ref[f"xb_{kind}"][isl]).max()),
            rt=float((xb - xl.detach()).abs().max()),
            grad=rel(xl.grad, ref[f"grad_{kind}"][isl])))

for kind, (sizes, names, axes) in %r.items():
    mesh = mesh_of(tuple(sizes), tuple(names))
    dec = Decomposition(kind, tuple(axes))
    plan = Croft3D((N, N, N), mesh, dec, FFTOptions(local_impl="pallas"),
                   problem="r2c", strategy="embed")
    isl, osl = plan.input_sharding, plan.output_sharding
    want = ref[f"embed_{kind}"]
    xl = t(xr[isl]).requires_grad_()
    y = plan.forward(xl)
    xb = plan.inverse(y.detach())
    y.backward(t(g[..., :N // 2 + 1][osl]))
    records.append(dict(
        check="embed", kind=kind, strategy=plan.strategy,
        shape_ok=tuple(y.shape) == want[osl].shape,
        err=float(np.abs(y.detach().numpy() - want[osl]).max()
                  / np.abs(want).max()),
        rt=float((xb - xl.detach()).abs().max()), real=not xb.is_complex(),
        grad=rel(xl.grad, ref[f"embed_grad_{kind}"][isl])))
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(records, f)
leave(*meshes.values())
"""


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    run_multidevice(REFERENCE % (N, C2C, EMBED, path), n_devices=8)
    return path


@pytest.fixture(scope="module")
def port_records(reference_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER % (C2C, EMBED), 8, [reference_path, out], out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(8)]


def _records(port_records, check, kind):
    return [r for recs in port_records for r in recs
            if r["check"] == check and r["kind"] == kind]


@pytest.mark.parametrize("kind", sorted(C2C))
def test_c2c_blocks_match_reference(port_records, kind):
    runs = _records(port_records, "c2c", kind)
    assert len(runs) == 8 * 2
    for r in runs:
        assert r["err"] < REL_TOL, r
        assert r["rt"] < RT_TOL and r["inv_err"] < RT_TOL, r


@pytest.mark.parametrize("kind", sorted(C2C))
def test_c2c_grads_match_reference(port_records, kind):
    runs = _records(port_records, "c2c", kind)
    assert len(runs) == 8 * 2 and all(r["grad"] < GRAD_TOL for r in runs), runs


@pytest.mark.parametrize("kind", sorted(EMBED))
def test_distributed_embed_matches_reference(port_records, kind):
    runs = _records(port_records, "embed", kind)
    assert len(runs) == 8
    for r in runs:
        assert r["strategy"] == "embed" and r["shape_ok"], r
        assert r["err"] < RFFT_TOL, r
        assert r["rt"] < RT_TOL and r["real"], r


@pytest.mark.parametrize("kind", sorted(EMBED))
def test_distributed_embed_grads_match_reference(port_records, kind):
    runs = _records(port_records, "embed", kind)
    assert len(runs) == 8 and all(r["grad"] < GRAD_TOL for r in runs), runs


class _FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.size = math.prod(self.shape.values())
        self.device = torch.device("cpu")
        self.coords = {a: 0 for a in self.shape}


@pytest.mark.parametrize("kind,axes", [("cell", ("a", "b", "c")),
                                       ("pencil", (("a", "b"), "c"))])
@pytest.mark.parametrize("impl", ["ring", "pairwise"])
def test_point_to_point_transposes_stay_single_axis(kind, axes, impl):
    """Ring and pairwise stay rejected on the cell regroup and on folded
    axes, before any collective (``Decomposition.validate``)."""
    with pytest.raises(ValueError, match="single mesh axes only|cell"):
        Croft3D((N, N, N), _FakeMesh({"a": 2, "b": 2, "c": 2}),
                Decomposition(kind, axes), FFTOptions(transpose_impl=impl))
