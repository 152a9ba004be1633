"""The port's distributed transform on 4 gloo ranks against the JAX
reference on a 4-device mesh.

One reference subprocess runs ``repro.core.Croft3D`` once per
(decomposition, layout), forward and inverse, and saves the global
outputs and every device's shard index.  The reference already pins its
transpose impls, K values and overlap modes bitwise equal
(tests/test_schedule.py:395-451), so one output per pair covers them all.
One spawn of 4 torch ranks (gloo, CPU tensors) then runs every port
configuration and checks each rank's block against its slice of the
reference output.
"""

import json

import numpy as np
import pytest

import torch_ranks
from conftest import run_multidevice
from repro_torch.core import Decomposition

N = 16
KINDS = {"pencil": ((2, 2), ("data", "model")), "slab": ((4,), ("p",))}
PAIRS = [(k, lay) for k in KINDS for lay in ("natural", "spectral")]
REL_TOL = 1e-5   # tests/test_distributed_fft.py:27
RT_TOL = 1e-4    # tests/test_distributed_fft.py:28

REFERENCE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D, Decomposition, FFTOptions
N = %d
rng = np.random.RandomState(42)
x = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)).astype(np.complex64)
out = {"x": x}
shards = []
auto = jax.sharding.AxisType.Auto
for kind, (sizes, names) in %r.items():
    mesh = jax.make_mesh(sizes, names, axis_types=(auto,) * len(sizes))
    dec = Decomposition(kind, names)
    for layout in ("natural", "spectral"):
        opts = FFTOptions(output_layout=layout)
        plan = Croft3D((N, N, N), mesh, dec, opts)
        y = plan.forward(jax.device_put(jnp.asarray(x), plan.input_sharding))
        out[f"y_{kind}_{layout}"] = np.asarray(y)
        out[f"xb_{kind}_{layout}"] = np.asarray(plan.inverse(y))
        out[f"tok_{kind}_{layout}"] = np.array([dec.to_token(),
                                                opts.to_token()])
        for s in y.addressable_shards:
            pos = np.argwhere(mesh.devices == s.device)[0]
            shards.append(dict(kind=kind, layout=layout,
                               coords={a: int(i) for a, i in zip(names, pos)},
                               index=[[sl.start or 0, N if sl.stop is None
                                       else sl.stop] for sl in s.index]))
out["shards"] = np.array(json.dumps(shards))
np.savez(%r, **out)
print("OK reference")
"""

WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import (Croft3D, Decomposition, FFTOptions,
                              local_block, make_mesh)
from repro_torch.core.schedule import CHUNKS_OVERLAPPED
from repro_torch.obs import metrics
overlapped = metrics.get_registry().counter(CHUNKS_OVERLAPPED)
rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
join(rank, port, 4)
ref = np.load(npz)
x = ref["x"]
shape = x.shape
records, meshes = [], []
for kind, (sizes, names) in %r.items():
    mesh = make_mesh(sizes, names, device="cpu")
    meshes.append(mesh)
    dec = Decomposition(kind, names)
    xl = torch.from_numpy(np.ascontiguousarray(
        local_block(x, dec, mesh.shape, mesh.coords)))
    for layout in ("natural", "spectral"):
        y_ref = ref[f"y_{kind}_{layout}"]
        scale = float(np.abs(y_ref).max())
        yr = local_block(y_ref, dec, mesh.shape, mesh.coords, layout)
        xbr = local_block(ref[f"xb_{kind}_{layout}"], dec, mesh.shape,
                          mesh.coords)
        outs = {}
        for impl in ("alltoall", "ring", "pairwise"):
            for k in (1, 2):
                for mode in ("pipelined", "unrolled"):
                    opts = FFTOptions(overlap_k=k, transpose_impl=impl,
                                      overlap_mode=mode, output_layout=layout,
                                      local_impl="pallas")
                    plan = Croft3D(shape, mesh, dec, opts)
                    before = overlapped.value
                    y = plan.forward(xl)
                    xb = plan.inverse(y)
                    outs[(impl, k, mode)] = y
                    records.append(dict(
                        kind=kind, layout=layout, impl=impl, k=k, mode=mode,
                        overlapped=overlapped.value - before,
                        err=float(np.abs(y.numpy() - yr).max()) / scale,
                        inv_err=float(np.abs(xb.numpy() - xbr).max()),
                        rt=float(np.abs(xb.numpy() - xl.numpy()).max())))
        base = outs[("alltoall", 1, "pipelined")]
        same_k = all(torch.equal(outs[(i, k, m)], outs[("alltoall", k, m)])
                     for (i, k, m) in outs)
        same_all = all(torch.equal(v, base) for v in outs.values())
        dtok, otok = (str(t) for t in ref[f"tok_{kind}_{layout}"])
        by_tok = Croft3D.from_tokens(shape, dtok, otok, mesh)
        direct = Croft3D(shape, mesh, dec, FFTOptions(output_layout=layout))
        yt = by_tok.forward(xl)
        records.append(dict(
            kind=kind, layout=layout, impl="*", bitwise_impls=same_k,
            bitwise_all=same_all, tokens=[by_tok.decomp.to_token(),
                                          by_tok.opts.to_token()],
            from_tokens_equal=bool(torch.equal(yt, direct.forward(xl))),
            from_tokens_err=float(np.abs(yt.numpy() - yr).max()) / scale))
    # ppermute: a shift by one along every axis of this mesh
    for axis in names:
        p, me = mesh.axis_size(axis), mesh.axis_index(axis)
        got = mesh.ppermute(torch.full((3,), float(me)), axis,
                            [(i, (i + 1) %% p) for i in range(p)])
        records.append(dict(kind=kind, impl="ppermute", axis=axis,
                            ok=bool(torch.all(got == (me - 1) %% p))))
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
def reference(reference_path):
    return np.load(reference_path)


@pytest.fixture(scope="module")
def port_records(reference_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER % (KINDS,), 4, [reference_path, out], out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("kind,layout", PAIRS)
def test_reference_shards_are_local_block_slices(reference, kind, layout):
    """The port's slice descriptors give each device exactly the shard the
    reference's NamedSharding placed on it."""
    sizes, names = KINDS[kind]
    dec = Decomposition(kind, names)
    shards = [s for s in json.loads(str(reference["shards"]))
              if s["kind"] == kind and s["layout"] == layout]
    assert len(shards) == 4
    for s in shards:
        sl = dec.slices((N,) * 3, dict(zip(names, sizes)), s["coords"], layout)
        assert [[x.start, x.stop] for x in sl] == s["index"]


@pytest.mark.parametrize("kind,layout", PAIRS)
def test_rank_blocks_match_reference(port_records, kind, layout):
    runs = [r for recs in port_records for r in recs
            if r["kind"] == kind and r.get("layout") == layout
            and r["impl"] not in ("*", "ppermute")]
    assert len(runs) == 4 * 12     # 4 ranks x 3 impls x 2 K x 2 modes
    for r in runs:
        assert r["err"] < REL_TOL, r
        assert r["rt"] < RT_TOL, r
        assert r["inv_err"] < RT_TOL, r


@pytest.mark.parametrize("kind,layout", PAIRS)
def test_transpose_impls_bitwise_equal(port_records, kind, layout):
    for recs in port_records:
        (summary,) = [r for r in recs if r["kind"] == kind
                      and r.get("layout") == layout and r["impl"] == "*"]
        assert summary["bitwise_impls"], summary
        # chunking and emission order change no row's arithmetic either
        assert summary["bitwise_all"], summary


# comm stages of a forward plus its inverse
COMM_STAGES = {("pencil", "natural"): 8, ("pencil", "spectral"): 4,
               ("slab", "natural"): 4, ("slab", "spectral"): 2}


@pytest.mark.parametrize("kind,layout", PAIRS)
def test_chunks_overlapped_counter(port_records, kind, layout):
    """``stage_chunks_overlapped`` grows by K - 1 a comm stage on every
    rank (4 a pencil spectral round trip at K = 2), and not at all with
    K = 1 or the blocking pairwise rounds."""
    runs = [r for recs in port_records for r in recs
            if r["kind"] == kind and r.get("layout") == layout
            and r["impl"] not in ("*", "ppermute")]
    for r in runs:
        want = (0 if r["impl"] == "pairwise"
                else COMM_STAGES[(kind, layout)] * (r["k"] - 1))
        assert r["overlapped"] == want, r


@pytest.mark.parametrize("kind,layout", PAIRS)
def test_from_tokens_runs_the_reference_plan(port_records, reference,
                                             kind, layout):
    dtok, otok = (str(t) for t in reference[f"tok_{kind}_{layout}"])
    for recs in port_records:
        (summary,) = [r for r in recs if r["kind"] == kind
                      and r.get("layout") == layout and r["impl"] == "*"]
        assert summary["tokens"] == [dtok, otok]
        assert summary["from_tokens_equal"]
        assert summary["from_tokens_err"] < REL_TOL


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_mesh_ppermute_shifts_by_one(port_records, kind):
    checks = [r for recs in port_records for r in recs
              if r["kind"] == kind and r["impl"] == "ppermute"]
    assert len(checks) == 4 * len(KINDS[kind][1])
    assert all(r["ok"] for r in checks), checks
