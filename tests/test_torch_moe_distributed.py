"""The port's sharded MoE dispatch on 4 gloo ranks against the
reference's meshless ``moe_fwd``, on the CPU.

``tests/test_perf_paths.py:48-90`` on a (data 1, model 4) mesh: the "ep"
mode (8 experts over 4 ranks, tokens sequence-sharded; the dispatch
buffer crosses the ranks through CROFT's K-chunked ``_stage``, real
float32 blocks split on the model dim), the "tp" mode (6 experts do not
divide 4: ffn-sliced weights and one all-reduce, with a shared expert)
and the decode shape (S 1, no sequence axis: tp).  Each rank's output is
held within 1e-5 of its slice of the reference; the collectives each
mode issues are counted with ``Mesh.counting()``.  float32 only: gloo's
collectives are not asked to carry bf16.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from repro.models.config import MoESpec as RefMoESpec
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import moe_fwd as ref_moe_fwd

TOL = 1e-5          # tests/test_perf_paths.py:64
RANKS = 4
D = 16

CASES = {
    # name: (MoESpec kwargs, x shape, cp_axis, key seed)
    "ep": (dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=16.0),
           (4, 8, D), "model", 0),
    "tp": (dict(n_experts=6, top_k=2, n_shared=1, d_ff_expert=32,
                capacity_factor=16.0), (4, 8, D), "model", 1),
    "decode": (dict(n_experts=8, top_k=2, d_ff_expert=32,
                    capacity_factor=16.0), (8, 1, D), None, 0),
}

WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.core import make_mesh
from repro_torch.models.config import MoESpec
from repro_torch.models.convert import load_tree
from repro_torch.models.moe import MoE
from repro_torch.models.moe_sharded import (moe_fwd_sharded, moe_mode,
                                            shard_moe)

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
join(rank, port, 4)
mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
with open(os.path.join(out, "cases.json")) as f:
    cases = json.load(f)
rec = {"rank": rank}
for name, (m_kw, shape, cp_axis, _) in cases.items():
    m = MoESpec(**m_kw)
    data = np.load(os.path.join(out, f"{name}.npz"))
    full = MoE(shape[-1], m, "cpu")
    load_tree(full, {k[2:]: data[k] for k in data.files
                     if k.startswith("p.")}, name)
    local = shard_moe(full, m, mesh, cp_axis=cp_axis, tp_axis="model")
    x = torch.from_numpy(data["x"])
    if moe_mode(m, mesh, cp_axis, "model") == "ep":
        s = shape[1] // 4
        rows = slice(s * mesh.coords["model"], s * (mesh.coords["model"] + 1))
    else:
        rows = slice(None)          # tp: every rank holds every token
    for k in (1, 2):
        with mesh.counting() as cnt:
            got = moe_fwd_sharded(local, x[:, rows].contiguous(), m,
                                  mesh=mesh, cp_axis=cp_axis,
                                  tp_axis="model", overlap_k=k)
        want = torch.from_numpy(data["ref"])[:, rows]
        rec[f"{name}-k{k}"] = dict(
            mode=moe_mode(m, mesh, cp_axis, "model"),
            shape=list(got.shape), dtype=str(got.dtype),
            err=float((got - want).abs().max()),
            w_gate=list(local.w_gate.shape),
            collectives=cnt.collectives)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ranks")
    rng = np.random.RandomState(0)
    for name, (m_kw, shape, _, seed) in CASES.items():
        m = RefMoESpec(**m_kw)
        p = ref_init_moe(jax.random.PRNGKey(seed), D, m)
        x = rng.randn(*shape).astype(np.float32)
        ref = np.asarray(ref_moe_fwd(p, jnp.asarray(x), m))
        leaves = {"p." + ".".join(k.key for k in path): np.asarray(v)
                  for path, v in jax.tree_util.tree_leaves_with_path(p)}
        np.savez(out / f"{name}.npz", x=x, ref=ref, **leaves)
    (out / "cases.json").write_text(json.dumps(CASES))
    torch_ranks.spawn(WORKER, RANKS, [out], out)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(RANKS)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_fwd_sharded_matches_reference(moe_ranks, case, k):
    m_kw, shape, cp_axis, _ = CASES[case]
    want_mode = "ep" if case == "ep" else "tp"
    for r in moe_ranks:
        got = r[f"{case}-k{k}"]
        assert got["mode"] == want_mode, (r["rank"], got)
        rows = shape[1] // RANKS if want_mode == "ep" else shape[1]
        assert got["shape"] == [shape[0], rows, D], got
        assert got["dtype"] == "torch.float32"
        assert got["err"] < TOL, (r["rank"], case, got["err"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_moe_takes_this_ranks_block(moe_ranks, case):
    m_kw, _, _, _ = CASES[case]
    e, f = m_kw["n_experts"], m_kw["d_ff_expert"]
    want = [e // RANKS, D, f] if case == "ep" else [e, D, f // RANKS]
    for r in moe_ranks:
        assert r[f"{case}-k1"]["w_gate"] == want, (r["rank"], case)


def test_collectives_of_each_mode(moe_ranks):
    """ep: one all-to-all a stage a chunk, two stages (the dispatch and its
    reverse), each sending the whole (E, C, D) buffer over K chunks; tp:
    one all-reduce of the (T, D) output and nothing else."""
    cap = 32        # moe._capacity(4 x 2 local tokens, the ep spec)
    for r in moe_ranks:
        for k in (1, 2):
            ep = r[f"ep-k{k}"]["collectives"]
            assert ep == {"all-to-all": {"count": 2 * k,
                                         "bytes": 2 * 8 * cap * D * 4}}, ep
            tp = r[f"tp-k{k}"]["collectives"]
            assert tp == {"all-reduce": {"count": 1,
                                         "bytes": 4 * 8 * D * 4}}, tp
            dec = r[f"decode-k{k}"]["collectives"]
            assert dec == {"all-reduce": {"count": 1,
                                          "bytes": 8 * 1 * D * 4}}, dec


def test_sharded_moe_refuses_a_full_block():
    """A rank handed the whole MoE (not its block) is refused, naming the
    helper that cuts the block."""
    import torch
    from repro_torch.models.config import MoESpec
    from repro_torch.models.moe import MoE
    from repro_torch.models.moe_sharded import moe_fwd_sharded

    class FakeMesh:
        def axis_size(self, axis):
            return 4

    m = MoESpec(n_experts=8, top_k=2, d_ff_expert=32)
    with pytest.raises(ValueError, match="shard_moe"):
        moe_fwd_sharded(MoE(D, m, "cpu"), torch.zeros(1, 2, D), m,
                        mesh=FakeMesh(), cp_axis="model",
                        tp_axis="model")
