"""The port's distributed real transforms and spectral epilogue on 4 gloo
ranks against the JAX reference on a 4-device mesh.

One reference subprocess runs ``repro.core.Croft3D`` for pencil 2x2 and
slab 4 at 16^3: the packed r2c forward, its inverse, ``forward_filtered``
with the filter after the unfold and folded into the schedule, and the
c2c ``forward_filtered``; it saves the global outputs.  One spawn of 4
torch ranks (gloo, CPU tensors) then runs every transpose impl x K and
checks each rank's block against its spectral-layout slice of those
outputs, and checks ``Mesh.reshard``/``Mesh.gather`` on their own.
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
KINDS = {"pencil": ((2, 2), ("data", "model")), "slab": ((4,), ("p",))}
TRANSFORMS = ("forward", "inverse", "filtered", "folded", "c2c_filtered")
REL_TOL = 1e-5   # tests/test_real_fft.py:338
RT_TOL = 1e-4    # tests/test_real_fft.py:339
RFFT_TOL = 5e-5  # tests/test_real_fft.py:160

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D, Decomposition, FFTOptions
N = %d
rng = np.random.RandomState(42)
x = rng.randn(N, N, N).astype(np.float32)
xc = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)).astype(np.complex64)
kx = np.fft.fftfreq(N)[:, None, None]
ky = np.fft.fftfreq(N)[None, :, None]
# kz-independent, real and 2-D-even: valid for the folded epilogue
h = (np.exp(-(kx ** 2 + ky ** 2) * 20) * np.ones((1, 1, N // 2 + 1))
     ).astype(np.complex64)
hc = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)).astype(np.complex64)
out = {"x": x, "xc": xc, "h": h, "hc": hc}
auto = jax.sharding.AxisType.Auto
for kind, (sizes, names) in %r.items():
    mesh = jax.make_mesh(sizes, names, axis_types=(auto,) * len(sizes))
    dec = Decomposition(kind, names)
    plan = Croft3D((N, N, N), mesh, dec, problem="r2c", strategy="packed")
    xd = jax.device_put(jnp.asarray(x), plan.input_sharding)
    hd = jax.device_put(jnp.asarray(h), plan.output_sharding)
    y = plan.forward(xd)
    out[f"forward_{kind}"] = np.asarray(y)
    out[f"inverse_{kind}"] = np.asarray(plan.inverse(y))
    out[f"filtered_{kind}"] = np.asarray(plan.forward_filtered(xd, hd))
    out[f"folded_{kind}"] = np.asarray(plan.forward_filtered(xd, hd,
                                                             fold=True))
    cplan = Croft3D((N, N, N), mesh, dec,
                    FFTOptions(output_layout="spectral"))
    out[f"c2c_filtered_{kind}"] = np.asarray(cplan.forward_filtered(
        jax.device_put(jnp.asarray(xc), cplan.input_sharding),
        jax.device_put(jnp.asarray(hc), cplan.output_sharding)))
np.savez(%r, **out)
print("OK reference")
"""

WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
join(rank, port, 4)
ref = np.load(npz)
x, xc, h, hc = ref["x"], ref["xc"], ref["h"], ref["hc"]
N = x.shape[0]
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
records, meshes = [], []
for kind, (sizes, names) in %r.items():
    mesh = make_mesh(sizes, names, device="cpu")
    meshes.append(mesh)
    dec = Decomposition(kind, names)
    outs = {}
    for impl in ("alltoall", "ring", "pairwise"):
        for k in (1, 2):
            opts = FFTOptions(overlap_k=k, transpose_impl=impl,
                              local_impl="pallas")
            plan = Croft3D((N, N, N), mesh, dec, opts, problem="r2c",
                           strategy="packed")
            cplan = Croft3D((N, N, N), mesh, dec, FFTOptions(
                overlap_k=k, transpose_impl=impl, local_impl="pallas",
                output_layout="spectral"))
            xl = t(x[plan.input_sharding])
            hl = t(h[plan.output_sharding])
            y = plan.forward(xl)
            got = {"forward": y, "inverse": plan.inverse(y),
                   "filtered": plan.forward_filtered(xl, hl),
                   "folded": plan.forward_filtered(xl, hl, fold=True),
                   "c2c_filtered": cplan.forward_filtered(
                       t(xc[cplan.input_sharding]),
                       t(hc[cplan.output_sharding]))}
            for name, v in got.items():
                want = ref[f"{name}_{kind}"]
                sl = (plan.input_sharding if name == "inverse" else
                      cplan.output_sharding if name == "c2c_filtered"
                      else plan.output_sharding)
                scale = 1.0 if name == "inverse" else float(
                    np.abs(want).max())
                records.append(dict(
                    kind=kind, impl=impl, k=k, transform=name,
                    shape_ok=tuple(v.shape) == want[sl].shape,
                    err=float(np.abs(v.numpy() - want[sl]).max()) / scale,
                    rt=float(np.abs(got["inverse"].numpy() - xl.numpy()).max())))
                outs[(impl, k, name)] = v
            # leading batch axes ride through one schedule
            yb = plan.forward_batched(torch.stack([xl, 2 * xl]))
            y2 = plan.forward(2 * xl)
            records.append(dict(
                kind=kind, impl=impl, k=k, transform="batch",
                err=max(float((yb[0] - y).abs().max() / y.abs().max()),
                        float((yb[1] - y2).abs().max() / y2.abs().max()))))
    base = {n: outs[("alltoall", 1, n)] for n in
            ("forward", "inverse", "filtered", "folded", "c2c_filtered")}
    records.append(dict(kind=kind, transform="*", bitwise=all(
        torch.equal(v, base[n]) for (i, k, n), v in outs.items())))
    # reshard natural <-> spectral of a (2, N, N, N/2) batch of blocks, and
    # the plane gather
    g = (np.random.RandomState(7).randn(2, N, N, N // 2)
         + 1j).astype(np.complex64)
    shape = (N, N, N // 2)
    nat, spec = dec.spec("natural"), dec.spec("spectral")
    mine = lambda lay: t(g[(Ellipsis,) + dec.slices(shape, mesh, mesh.coords,
                                                    lay)])
    there = mesh.reshard(mine("natural"), shape, nat, spec)
    back = mesh.reshard(there, shape, spec, nat)
    plane = mesh.gather(mine("spectral")[..., 0].contiguous(), shape[:2],
                        spec[:2])
    records.append(dict(kind=kind, transform="reshard",
                        to_spectral=bool(torch.equal(there, mine("spectral"))),
                        to_natural=bool(torch.equal(back, mine("natural"))),
                        gather=bool(torch.equal(plane, t(g[..., 0]))),
                        bytes=mesh.reshard_bytes))
    try:
        eplan = Croft3D((N, N, N), mesh, dec, FFTOptions(local_impl="pallas"),
                        problem="r2c", strategy="embed")
        xl = t(x[eplan.input_sharding])
        ye = eplan.forward(xl)
        want = np.fft.rfftn(x)
        records.append(dict(
            kind=kind, transform="embed", raised="ran",
            err=float(np.abs(ye.numpy() - want[eplan.output_sharding]).max()
                      / np.abs(want).max()),
            rt=float((eplan.inverse(ye) - xl).abs().max())))
    except NotImplementedError as e:
        records.append(dict(kind=kind, transform="embed", raised=str(e)))
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(records, f)
leave(*meshes)
"""


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    run_multidevice(REFERENCE % (N, KINDS, path), n_devices=4)
    return path


@pytest.fixture(scope="module")
def port_records(reference_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER % (KINDS,), 4, [reference_path, out], out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


def _records(port_records, kind, transform):
    return [r for recs in port_records for r in recs
            if r["kind"] == kind and r["transform"] == transform]


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rank_blocks_match_reference(port_records, kind, transform):
    runs = _records(port_records, kind, transform)
    assert len(runs) == 4 * 6        # 4 ranks x 3 impls x 2 K
    for r in runs:
        assert r["shape_ok"], r
        assert r["err"] < (RT_TOL if transform == "inverse" else REL_TOL), r
        assert r["rt"] < RT_TOL, r


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_transpose_impls_and_k_bitwise_equal(port_records, kind):
    summaries = _records(port_records, kind, "*")
    assert len(summaries) == 4
    assert all(s["bitwise"] for s in summaries), summaries


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_r2c_equals_per_field(port_records, kind):
    runs = _records(port_records, kind, "batch")
    assert len(runs) == 4 * 6 and all(r["err"] < REL_TOL for r in runs), runs


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reshard_and_gather_round_trip_exactly(port_records, kind):
    runs = _records(port_records, kind, "reshard")
    assert len(runs) == 4
    for r in runs:
        assert r["to_spectral"] and r["to_natural"] and r["gather"], r
        assert r["bytes"] > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_distributed_embed_plan_raises(port_records, kind):
    """The distributed embed plan no longer raises: it runs, matches
    ``numpy.fft.rfftn`` (tests/test_real_fft.py:160) and round-trips."""
    runs = _records(port_records, kind, "embed")
    assert len(runs) == 4
    for r in runs:
        assert r["raised"] == "ran", r
        assert r["err"] < RFFT_TOL and r["rt"] < RT_TOL, r


class _FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.size = math.prod(self.shape.values())
        self.device = torch.device("cpu")
        self.coords = {a: 0 for a in self.shape}


def test_embed_resolution_raises_without_running():
    """A distributed r2c plan that resolves to the embedding (auto on a
    cell decomposition, or asked for) resolves when it is built, before
    any collective, and never falls back to packed; asking for packed
    where it cannot run raises with the reason."""
    mesh = _FakeMesh({"a": 2, "b": 2, "c": 2})
    cell = Decomposition("cell", ("a", "b", "c"))
    plan = Croft3D((8, 8, 8), mesh, cell, problem="r2c")
    assert plan.strategy == "embed"
    # cell keeps x and y sharded and replicates the z-local half spectrum
    assert plan.output_sharding == (slice(0, 4), slice(0, 4), slice(0, 5))
    with pytest.raises(ValueError, match="pencil and slab"):
        Croft3D((8, 8, 8), mesh, cell, problem="r2c", strategy="packed")
    pencil = Decomposition("pencil", ("a", "b"))
    assert Croft3D((8, 8, 8), _FakeMesh({"a": 2, "b": 2}), pencil,
                   problem="r2c", strategy="embed").strategy == "embed"
