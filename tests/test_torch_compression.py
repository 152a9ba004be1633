"""The port's int8 error-feedback compression against the reference, on
the CPU.

The math (``tests/test_substrate.py:248-275``'s inputs, each drawn from
a fresh ``RandomState(0)``): ``quantize_int8``'s q and scale equal to
the reference's bit for bit (both round half to even), the residual of
``compress_residual`` within 1e-6 and its error-feedback conservation,
``topk_sparsify``/``topk_densify`` picking the same entries.

``compressed_psum`` on 4 gloo ranks over a ``pod`` axis of 4, against
the reference's 4-device ``shard_map`` run (``tests/test_parallel.py:
100-124``'s case, widened to a tree): a dict holding a (64,) leaf and a
list of a (8, 4) and a float16 (16,) leaf, two rounds with the first
round's residuals carried into the second except one, which is None.
Every rank's reduced tree and residuals are within 1e-6 of the
reference's, the residuals bit-equal (so each q*scale is), and the
reduction within ``4·amax/127`` of the exact sum.  Its collectives:
two all-reduces a leaf, a 4-byte MAX and the int32 payload, counted
as ``"all-reduce"`` (as many bytes as a float32 all-reduce).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conftest import run_multidevice
from repro.parallel import compression as ref_c
from repro_torch.parallel import compression as c

RANKS = 4
TOL = 1e-6
SHAPES = {"w": (64,), "b0": (8, 4), "b1": (16,)}

REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.parallel.compression import compressed_psum
mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
rng = np.random.RandomState(0)
g1 = {k: rng.randn(4, *s).astype(np.float32) for k, s in %r.items()}
g2 = {k: rng.randn(4, *s).astype(np.float32) * 0.5 for k, s in %r.items()}

def tree(g):
    return {"w": g["w"][0], "b": [g["b0"][0], g["b1"][0].astype(jnp.float16)]}

def body(a, b):
    a = {k: v for k, v in a.items()}
    b = {k: v for k, v in b.items()}
    out1, res1 = compressed_psum(tree(a), "pod")
    carried = {"w": res1["w"], "b": [None, res1["b"][1]]}
    out2, res2 = compressed_psum(tree(b), "pod", carried)
    flat = lambda t: [t["w"], t["b"][0], t["b"][1]]
    return (flat(out1), [r[None] for r in flat(res1)], flat(out2),
            [r[None] for r in flat(res2)])

spec = {k: P("pod") for k in g1}
rep = [P(), P(), P()]
res = [P("pod"), P("pod"), P("pod")]
o1, r1, o2, r2 = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                           out_specs=(rep, res, rep, res))(g1, g2)
out = {}
for k, v in g1.items():
    out["g1_" + k] = v
    out["g2_" + k] = g2[k]
for i, name in enumerate(("w", "b0", "b1")):
    out["o1_" + name] = np.asarray(o1[i]).astype(np.float32)
    out["r1_" + name] = np.asarray(r1[i])
    out["o2_" + name] = np.asarray(o2[i]).astype(np.float32)
    out["r2_" + name] = np.asarray(r2[i])
np.savez(%r, **out)
print("OK")
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch
import torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import make_mesh
from repro_torch.parallel.compression import compressed_psum

rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
join(rank, port, 4)
mesh = make_mesh((4,), ("pod",), device="cpu")
ref = np.load(npz)
me = mesh.axis_index("pod")


def tree(tag):
    leaf = lambda k: torch.from_numpy(ref[tag + "_" + k][me])
    return {"w": leaf("w"), "b": [leaf("b0"), leaf("b1").half()]}


def flat(t):
    return [t["w"], t["b"][0], t["b"][1]]


with mesh.counting() as cnt:
    out1, res1 = compressed_psum(tree("g1"), "pod", mesh=mesh)
carried = {"w": res1["w"], "b": [None, res1["b"][1]]}
out2, res2 = compressed_psum(tree("g2"), "pod", carried, mesh=mesh)
rec = {"rank": rank, "collectives": cnt.collectives,
       "dtypes": [str(t.dtype) for t in flat(out1)]}
for rnd, (o, r) in (("1", (out1, res1)), ("2", (out2, res2))):
    for name, ot, rt in zip(("w", "b0", "b1"), flat(o), flat(r)):
        want_o = ref["o" + rnd + "_" + name]
        want_r = ref["r" + rnd + "_" + name][me]
        exact = ref["g" + rnd + "_" + name].sum(0)
        rec[rnd + name] = dict(
            out_err=float(np.abs(ot.float().numpy() - want_o).max()),
            res_equal=bool((rt.numpy() == want_r).all()),
            res_err=float(np.abs(rt.numpy() - want_r).max()),
            exact_err=float(np.abs(ot.float().numpy() - exact).max()),
            amax=float(np.abs(ref["g" + rnd + "_" + name]).max()))
# a MAX all-reduce is counted as one all-reduce of its bytes
x = torch.tensor([float(rank), -1.0])
with mesh.counting() as cnt:
    got = mesh.all_reduce(x, "pod", op=dist.ReduceOp.MAX).wait()
rec["max"] = dict(value=got.tolist(), collectives=cnt.collectives)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


def _rng():
    return np.random.RandomState(0)


def test_int8_quantize_matches_reference():
    x = _rng().randn(64).astype(np.float32) * 5
    q, scale = c.quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_c.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert scale.item() == float(rscale)
    err = np.abs(c.dequantize_int8(q, scale).numpy() - x)
    assert err.max() <= scale.item() * 0.5 + 1e-6
    zero_q, zero_scale = c.quantize_int8(torch.zeros(8))
    assert zero_scale.item() == 1.0 and not zero_q.any()


def test_error_feedback_matches_reference():
    rng = _rng()
    x = rng.randn(32).astype(np.float32)
    res = rng.randn(32).astype(np.float32) * 0.01
    q, scale, new_res = c.compress_residual(torch.from_numpy(x),
                                            torch.from_numpy(res))
    rq, rscale, rres = ref_c.compress_residual(jnp.asarray(x),
                                               jnp.asarray(res))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert scale.item() == float(rscale)
    assert np.abs(new_res.numpy() - np.asarray(rres)).max() <= TOL
    recon = c.dequantize_int8(q, scale).numpy() + new_res.numpy()
    np.testing.assert_allclose(recon, x + res, atol=1e-6)
    q0, _, r0 = c.compress_residual(torch.from_numpy(x), None)
    rq0, _, rr0 = ref_c.compress_residual(jnp.asarray(x), None)
    assert np.array_equal(q0.numpy(), np.asarray(rq0))
    assert np.abs(r0.numpy() - np.asarray(rr0)).max() <= TOL


def test_topk_matches_reference():
    x = _rng().randn(100).astype(np.float32)
    vals, idx = c.topk_sparsify(torch.from_numpy(x), 0.1)
    rvals, ridx = ref_c.topk_sparsify(jnp.asarray(x), 0.1)
    assert sorted(idx.tolist()) == sorted(np.asarray(ridx).tolist())
    dense = c.topk_densify(vals, idx, (100,)).numpy()
    rdense = np.asarray(ref_c.topk_densify(rvals, ridx, (100,)))
    assert (dense != 0).sum() == 10
    np.testing.assert_array_equal(dense, rdense)
    top10 = np.argsort(-np.abs(x))[:10]
    np.testing.assert_allclose(np.sort(dense[top10]), np.sort(x[top10]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("compression")
    npz = os.path.join(str(out), "ref.npz")
    run_multidevice(REFERENCE % (SHAPES, SHAPES, npz), n_devices=4)
    torch_ranks.spawn(WORKER, RANKS, [npz, out], out)
    return [json.load(open(os.path.join(str(out), f"rank{r}.json")))
            for r in range(RANKS)]


@pytest.mark.parametrize("leaf", [r + n for r in "12" for n in SHAPES])
def test_compressed_psum_matches_reference(ranks, leaf):
    for r in ranks:
        got = r[leaf]
        assert got["out_err"] <= TOL, got
        assert got["res_equal"] and got["res_err"] <= TOL, got
        # tests/test_parallel.py:120, plus float16 rounding of the sum
        slack = 1e-5 if not leaf.endswith("b1") else 4 * got["amax"] * 2e-3
        assert got["exact_err"] <= 4 * got["amax"] / 127 + slack, got


def test_compressed_psum_keeps_dtypes_and_counts(ranks):
    n = {k: int(np.prod(s)) for k, s in SHAPES.items()}
    for r in ranks:
        assert r["dtypes"] == ["torch.float32", "torch.float32",
                               "torch.float16"]
        # per leaf: a 4-byte MAX (the shared scale), then the int32 sum
        assert r["collectives"] == {"all-reduce": {
            "count": 2 * len(SHAPES),
            "bytes": 4 * len(SHAPES) + 4 * sum(n.values())}}


def test_all_reduce_max_is_counted(ranks):
    for r in ranks:
        assert r["max"]["value"] == [float(RANKS - 1), -1.0]
        assert r["max"]["collectives"] == {"all-reduce": {"count": 1,
                                                          "bytes": 8}}
