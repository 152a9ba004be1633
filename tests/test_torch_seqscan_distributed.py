"""The port's sequence-parallel scans on 4 gloo ranks against the
reference's 8-device run, on the CPU.

``tests/test_parallel.py:24-61``'s case: (B 4, T 64, D 16) for
``cp_vector_recurrence`` and (B 4, T 64, H 2, K 4, V 4) for
``cp_matrix_recurrence``, chunk 4, the sequence sharded four ways.  The
reference runs on a (data 2, model 4) mesh of 8 virtual devices; the
port on a (data 1, model 4) mesh of 4 gloo ranks, each rank holding its
16-token block of the whole batch.  Each rank's block is held within the
reference test's tolerances (1e-5 vector, 1e-4 matrix) of its slice of
the reference's sharded result and of the meshless scan, and the final
state, which every rank returns, likewise.  Each rank's collectives
are counted: ⌈log2 4⌉ = 2 Hillis–Steele rounds plus one shift,
each a ``ppermute`` of the (decay, contribution) pair, then one
all-reduce.
"""

import json
import os

import numpy as np
import pytest

import torch_ranks
from conftest import run_multidevice

RANKS = 4
VEC_TOL = 1e-5      # tests/test_parallel.py:44-45
MAT_TOL = 1e-4      # tests/test_parallel.py:58-59

REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.parallel.seqscan import cp_vector_recurrence, cp_matrix_recurrence
from repro.models.recurrent import vector_recurrence, matrix_recurrence
mesh = jax.make_mesh((2,4), ("data","model"), axis_types=(jax.sharding.AxisType.Auto,)*2)
rng = np.random.RandomState(0)
B,T,D = 4, 64, 16
log_a = -np.abs(rng.randn(B,T,D)).astype(np.float32)*0.3
b = rng.randn(B,T,D).astype(np.float32); h0 = rng.randn(B,D).astype(np.float32)
ref, ref_l = vector_recurrence(*map(jnp.asarray,(log_a,b)), jnp.asarray(h0), 16)
h, hl = cp_vector_recurrence(jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0),
                             mesh=mesh, cp_axis="model", batch_spec="data", chunk=4)
H,K,V = 2, 4, 4
log_w = -np.abs(rng.randn(B,T,H,K)).astype(np.float32)*0.4
k = rng.randn(B,T,H,K).astype(np.float32); v = rng.randn(B,T,H,V).astype(np.float32)
r = rng.randn(B,T,H,K).astype(np.float32); u = rng.randn(H,K).astype(np.float32)
s0 = rng.randn(B,H,K,V).astype(np.float32)
oref, sref = matrix_recurrence(*map(jnp.asarray,(log_w,k,v,r)), jnp.asarray(u), jnp.asarray(s0), 16)
o, sl = cp_matrix_recurrence(*map(jnp.asarray,(log_w,k,v,r)), jnp.asarray(u), jnp.asarray(s0),
                             mesh=mesh, cp_axis="model", batch_spec="data", chunk=4)
np.savez(%r, log_a=log_a, b=b, h0=h0, log_w=log_w, k=k, v=v, r=r, u=u, s0=s0,
         h=np.asarray(h), hl=np.asarray(hl), local_h=np.asarray(ref),
         local_hl=np.asarray(ref_l), o=np.asarray(o), sl=np.asarray(sl),
         local_o=np.asarray(oref), local_sl=np.asarray(sref))
print("OK")
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.core import make_mesh
from repro_torch.parallel.seqscan import (cp_matrix_recurrence,
                                          cp_vector_recurrence)

rank, port, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
join(rank, port, 4)
mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
ref = np.load(npz)
t = ref["b"].shape[1] // 4
rows = slice(t * mesh.coords["model"], t * (mesh.coords["model"] + 1))


def err(got, want):
    return float(np.abs(got.numpy() - want).max())


def blk(name):
    return torch.from_numpy(ref[name][:, rows]).contiguous()


rec = {"rank": rank}
with mesh.counting() as cnt:
    h, hl = cp_vector_recurrence(blk("log_a"), blk("b"),
                                 torch.from_numpy(ref["h0"]), mesh=mesh,
                                 cp_axis="model", batch_spec="data", chunk=4)
rec["vector"] = dict(
    shape=list(h.shape), err=err(h, ref["h"][:, rows]),
    err_local=err(h, ref["local_h"][:, rows]), err_last=err(hl, ref["hl"]),
    err_last_local=err(hl, ref["local_hl"]), collectives=cnt.collectives)
with mesh.counting() as cnt:
    o, sl = cp_matrix_recurrence(
        blk("log_w"), blk("k"), blk("v"), blk("r"), torch.from_numpy(ref["u"]),
        torch.from_numpy(ref["s0"]), mesh=mesh, cp_axis="model",
        batch_spec="data", chunk=4)
rec["matrix"] = dict(
    shape=list(o.shape), err=err(o, ref["o"][:, rows]),
    err_local=err(o, ref["local_o"][:, rows]), err_last=err(sl, ref["sl"]),
    err_last_local=err(sl, ref["local_sl"]), collectives=cnt.collectives)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def scan_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("seqscan")
    npz = str(out / "ref.npz")
    run_multidevice(REFERENCE % npz, n_devices=8)
    torch_ranks.spawn(WORKER, RANKS, [npz, out], out)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(RANKS)]


@pytest.mark.parametrize("which,tol", [("vector", VEC_TOL),
                                       ("matrix", MAT_TOL)])
def test_cp_scan_blocks_match_the_reference_run(scan_ranks, which, tol):
    want_shape = [4, 16, 16] if which == "vector" else [4, 16, 2, 4]
    for r in scan_ranks:
        got = r[which]
        assert got["shape"] == want_shape, (r["rank"], got)
        assert got["err"] < tol, (r["rank"], got)
        assert got["err_local"] < tol, (r["rank"], got)


@pytest.mark.parametrize("which,tol", [("vector", VEC_TOL),
                                       ("matrix", MAT_TOL)])
def test_cp_scan_final_state_on_every_rank(scan_ranks, which, tol):
    for r in scan_ranks:
        got = r[which]
        assert got["err_last"] < tol, (r["rank"], got)
        assert got["err_last_local"] < tol, (r["rank"], got)


@pytest.mark.parametrize("which", ["vector", "matrix"])
def test_cp_scan_collectives_are_the_reference_schedule(scan_ranks, which):
    """Rounds d = 1, 2 send to rank + d, the shift to rank + 1, each a
    ppermute of both tensors of the pair; rank i sends in the rounds
    where i + d < 4.  So ranks 0 and 1 send 6 tensors (the reference
    program's 3 ppermutes x 2), rank 2 sends 4 and rank 3 none, and every
    rank joins one all-reduce of the final state."""
    state = 4 * 16 * 4 if which == "vector" else 4 * 2 * 4 * 4 * 4
    pair = (4 * 16 * 4 if which == "vector" else 4 * 2 * 4 * 4) + state
    for r, sends in zip(scan_ranks, (3, 3, 2, 0)):
        c = r[which]["collectives"]
        assert c["all-reduce"] == {"count": 1, "bytes": state}, (r["rank"], c)
        if sends:
            assert c["collective-permute"] == {
                "count": 2 * sends, "bytes": sends * pair}, (r["rank"], c)
        else:
            assert "collective-permute" not in c, (r["rank"], c)
        assert set(c) <= {"all-reduce", "collective-permute"}
