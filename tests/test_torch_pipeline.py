"""The port's GPipe ``pipeline_apply`` on 4 gloo ranks against the
reference's 4-device run, on the CPU.

``tests/test_pipeline.py``'s case: L 8 tanh layers (W (8, 12, 12), b
(8, 12)), x (16, 12), 4 stages over a ``pod`` axis of 4, 4 microbatches.
The reference runs ``pipeline_apply`` in a 4-device JAX subprocess and
saves its output and the gradient of ``sum(out**2)`` with respect to W;
the port's ranks run the same schedule on the same numpy inputs.  Every
rank's output is held within 1e-5 of the reference's and of a sequential
pass, and its W gradient within 1e-4 (``tests/test_pipeline.py:39,
53``) of the reference's block of its own layers, with zeros elsewhere.
Two more schedules on the same ranks: one microbatch (the pipeline runs
its stages one after another) and 4 layers over 4 stages (one layer a
stage).  Each run's collectives are counted: M + P - 1 permutes (sent
by every stage but the last) and one all-reduce, forward.

Each case runs twice more: with ``local=True`` on only the rank's own
block of the leaves (output and gradient bit-equal to the whole-stack
run's), and with rank r's loss scaled by r + 1, whose gradient is the
mean of the ranks' losses' (2.5 times the sequential one), as the
docstring states.  Before each backward the ranks check, by a MAX and a
MIN all-reduce of the scalar, that every rank's loss is the same.
"""

import json
import os

import numpy as np
import pytest

import torch_ranks
from conftest import run_multidevice
from repro_torch.parallel.pipeline import bubble_fraction

RANKS = 4
FWD_TOL = 1e-5      # tests/test_pipeline.py:39
GRAD_TOL = 1e-4     # tests/test_pipeline.py:53
CASES = {"ref": (8, 4), "one_micro": (8, 1), "one_layer": (4, 4)}

REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.parallel.pipeline import pipeline_apply
mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
rng = np.random.RandomState(0)
L, B, D = 8, 16, 12
W = rng.randn(L, D, D).astype(np.float32) * 0.3
bvec = rng.randn(L, D).astype(np.float32) * 0.1
x = rng.randn(B, D).astype(np.float32)

def layer_fn(p, h):
    w, b = p
    return jnp.tanh(h @ w + b)

out = {"W": W, "b": bvec, "x": x}
for name, (layers, n_micro) in %r.items():
    w, b = jnp.asarray(W[:layers]), jnp.asarray(bvec[:layers])
    def loss(w):
        return jnp.sum(pipeline_apply(layer_fn, (w, b), jnp.asarray(x),
                                      mesh=mesh, stage_axis="pod",
                                      n_micro=n_micro) ** 2)
    out[name + "_y"] = np.asarray(pipeline_apply(
        layer_fn, (w, b), jnp.asarray(x), mesh=mesh, stage_axis="pod",
        n_micro=n_micro))
    out[name + "_g"] = np.asarray(jax.grad(loss)(w))
np.savez(%r, **out)
print("OK")
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch
import torch.distributed as dist
from torch_ranks import join, leave
from repro_torch.core import make_mesh
from repro_torch.parallel.pipeline import pipeline_apply

rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
cases = json.loads(sys.argv[5])
torch.set_num_threads(1)
join(rank, port, 4)
mesh = make_mesh((4,), ("pod",), device="cpu")
ref = np.load(npz)


def layer_fn(p, h):
    w, b = p
    return torch.tanh(h @ w + b)


rec = {"rank": rank, "stage": mesh.axis_index("pod")}
for name, (layers, n_micro) in cases.items():
    w = torch.from_numpy(ref["W"][:layers]).requires_grad_()
    b = torch.from_numpy(ref["b"][:layers])
    x = torch.from_numpy(ref["x"])
    seq = x
    for i in range(layers):
        seq = layer_fn((w[i], b[i]), seq)
    with mesh.counting() as cnt:
        y = pipeline_apply(layer_fn, (w, b), x, mesh=mesh, stage_axis="pod",
                           n_micro=n_micro)
    loss = (y ** 2).sum()
    ends = [mesh.all_reduce(loss.detach().reshape(1), "pod", op=op).wait()
            for op in (dist.ReduceOp.MAX, dist.ReduceOp.MIN)]
    loss.backward()
    g = w.grad.numpy()
    per = layers // 4
    mine = slice(per * rec["stage"], per * (rec["stage"] + 1))
    # the rank's own block only
    wl = w.detach()[mine].clone().requires_grad_()
    yl = pipeline_apply(layer_fn, (wl, b[mine]), x, mesh=mesh,
                        stage_axis="pod", n_micro=n_micro, local=True)
    (yl ** 2).sum().backward()
    # ranks whose losses differ: the gradient of their mean
    wm = w.detach().clone().requires_grad_()
    ym = pipeline_apply(layer_fn, (wm, b), x, mesh=mesh, stage_axis="pod",
                        n_micro=n_micro)
    ((rank + 1) * (ym ** 2).sum()).backward()
    others = np.delete(g, np.arange(layers)[mine], axis=0)
    rec[name] = dict(
        y_err=float(np.abs(y.detach().numpy() - ref[name + "_y"]).max()),
        seq_err=float((y - seq).abs().max()),
        g_err=float(np.abs(g[mine] - ref[name + "_g"][mine]).max()),
        g_others=float(np.abs(others).max()) if others.size else 0.0,
        g_scale=float(np.abs(ref[name + "_g"]).max()),
        loss_spread=float(ends[0] - ends[1]),
        local_y=bool(torch.equal(yl, y)),
        local_g=bool(torch.equal(wl.grad, w.grad[mine])),
        mean_g_err=float((wm.grad[mine] - 2.5 * w.grad[mine]).abs().max()),
        counts=cnt.counts)
    with torch.no_grad():
        z = pipeline_apply(layer_fn, (w, b), x, mesh=mesh, stage_axis="pod",
                           n_micro=n_micro)
    rec[name]["nograd_err"] = float((z - y.detach()).abs().max())
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    npz = os.path.join(str(out), "ref.npz")
    run_multidevice(REFERENCE % (CASES, npz), n_devices=4)
    torch_ranks.spawn(WORKER, RANKS, [npz, out, json.dumps(CASES)], out)
    return [json.load(open(os.path.join(str(out), f"rank{r}.json")))
            for r in range(RANKS)]


def test_bubble_fraction():
    assert bubble_fraction(2, 8) == pytest.approx(1 / 9)
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(1, 5) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_forward_matches_reference(runs, case):
    for r in runs:
        got = r[case]
        assert got["y_err"] < FWD_TOL, got
        assert got["seq_err"] < FWD_TOL, got
        assert got["nograd_err"] == 0.0, got


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_gradient_is_the_ranks_block(runs, case):
    for r in runs:
        got = r[case]
        assert got["g_err"] < GRAD_TOL, got
        assert got["g_others"] == 0.0, got
        assert got["g_scale"] > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_collectives(runs, case):
    """M + P - 1 steps, each a permute that every stage but the last
    sends on (a send is counted where it leaves), then one all-reduce."""
    _, n_micro = CASES[case]
    assert sorted(r["stage"] for r in runs) == list(range(RANKS))
    for r in runs:
        want = {"all-reduce": 1}
        if r["stage"] < RANKS - 1:
            want["collective-permute"] = n_micro + RANKS - 1
        assert r[case]["counts"] == want


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_local_block_equals_whole_stack(runs, case):
    """``local=True`` on the rank's own block computes what the whole
    stack computes, bit for bit, and its gradient is the block's."""
    for r in runs:
        assert r[case]["local_y"] and r[case]["local_g"], r[case]


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_gradient_is_the_mean_of_the_ranks_losses(runs, case):
    """The precondition the gradient rests on: every rank's loss is the
    same (the MAX and MIN all-reduce agree).  Where rank r's loss is
    scaled by r + 1, the gradient is the mean's: 2.5 times."""
    for r in runs:
        got = r[case]
        assert got["loss_spread"] == 0.0, got
        assert got["mean_g_err"] < GRAD_TOL * 2.5 * got["g_scale"], got
