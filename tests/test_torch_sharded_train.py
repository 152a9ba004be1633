"""The port's sharded training on gloo ranks, on the CPU.

* The reference's own case (``tests/test_parallel.py:66-97``): yi-9b at
  smoke size in float32 on a (data 2, model 4) mesh, two
  ``make_train_step`` steps from weights carried across from the
  reference, with each rank reading its batch block of the same
  ``SyntheticDataset`` batches; the losses within rtol 2e-4 of the
  **reference's** meshless losses.
* Every other arch on a (2, 2) mesh (MoE at a capacity factor where no
  pair drops), with mixtral also in the "tp" dispatch (3 experts) and
  yi-9b also over a sequence that does not divide the sequence axis:
  each rank's step-0 gradient blocks within 1e-4 of its leaf's max|ref|
  of its slice of the port's meshless gradients, and the routes
  ``forward`` took on the mesh (the K/V gather along the sequence axis,
  the sharded MoE dispatch, the sequence-parallel scans with their
  halos, the FNet mixer's sequence transpose, the prefix-LM label slice).
* A weight gathered with a one-replica adjoint (``Mesh.gather``, the
  reshard's) gives the wrong weight gradient; the sum adjoint
  (``Mesh.gather_sum``) gives the right one.
* Elastic checkpoints (``tests/test_parallel.py:177-...``): a state
  saved on (2, 2) restores onto (4, 1) with every block equal to its
  slice of the whole state; the save makes no tensor on a rank other
  than 0 that is larger than the rank's own largest block.
* Preemption on a mesh: the trainer (``launch.train.main``) with SIGTERM
  sent to one rank saves the same step on every rank and exits.
"""

import json
import os

import jax
import numpy as np
import pytest

import torch_ranks
from torch_shard_cases import ARCHS_2x2, GRAD_TOL

LOSS_RTOL = 2e-4    # tests/test_parallel.py:96

YI_WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model
from repro_torch.parallel import sharding as sh
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.train.data import SyntheticDataset, batch_sharding
from repro_torch.train.train_step import make_shard_ctx
from torch_shard_cases import config

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
join(rank, port, 8)
mesh = make_local_mesh(model=4, device="cpu")
cfg = config("yi-9b")
weights = np.load(os.path.join(out, "yi.npz"))
model = Model(cfg, device="meta").to_empty(device="cpu")
for name, p in model.named_parameters():
    p.data.copy_(torch.from_numpy(weights[name]))
sh.shard_model(model, mesh)
ocfg = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=8)
state = {"params": model,
         "opt": init_opt_state(dict(model.named_parameters()), ocfg)}
step = make_train_step(cfg, ocfg, mesh, 8, kv_block=32)
ds = SyntheticDataset(cfg.vocab, 32, 8, sharding=batch_sharding(
    make_shard_ctx(mesh, 8), 8, ["tokens"]))
losses = []
for i in range(2):
    batch = ds.batch_at(i)
    assert batch["tokens"].shape == (4, 33)
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"losses": losses, "mesh": mesh.shape,
               "n_tokens": int(m["n_tokens"])}, f)
leave(mesh)
"""

WORKER = r"""
import json, math, os, signal, sys
import numpy as np, torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_ranks import join
from repro_torch.core import make_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params, model as model_lib
from repro_torch.models import moe_sharded, spectral
from repro_torch.parallel import seqscan, sharding as sh
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import synth_tokens
from repro_torch.train.train_step import make_shard_ctx, value_and_grad
from torch_shard_cases import config, rel_err, stub_inputs

class Largest(TorchDispatchMode):
    # the most elements of any tensor an op returns inside the scope
    numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        got = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(got):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return got

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
archs = sys.argv[4].split(",")
torch.set_num_threads(1)
join(rank, port, 4)
mesh = make_local_mesh(model=2, device="cpu")
B, S = 2, 16
rec = {"rank": rank}
import time

# the routes forward takes on the mesh, counted where they are called
routes = {}
def counted(mod, name):
    fn = getattr(mod, name)
    def wrap(*a, **k):
        routes[name] = routes.get(name, 0) + 1
        return fn(*a, **k)
    setattr(mod, name, wrap)
for mod, name in [(model_lib, "_gather_seq"),
                  (moe_sharded, "moe_fwd_sharded"),
                  (seqscan, "cp_vector_recurrence"),
                  (seqscan, "cp_matrix_recurrence"),
                  (seqscan, "cp_halo"),
                  (spectral, "distributed_seq_fft")]:
    counted(mod, name)

for arch in archs:
    t0 = time.perf_counter()
    cfg = config(arch)
    seq = S - 1 if arch.endswith(":odd") else S
    batch = {"tokens": torch.from_numpy(
        synth_tokens(7, 0, B, seq + 1, cfg.vocab))}
    batch.update({k: torch.from_numpy(v)
                  for k, v in stub_inputs(cfg, B).items()})
    full = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss0, _, want = value_and_grad(full, cfg, batch, kv_block=16)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sh.shard_model(model, mesh)
    shard = make_shard_ctx(mesh, B)
    rows = model_lib.batch_rows(shard, B)
    block = {k: v[rows] for k, v in batch.items()}
    routes.clear()
    with mesh.counting() as cnt:
        loss1, metrics, got = value_and_grad(model, cfg, block, shard=shard,
                                             kv_block=16)
    errs = {n: rel_err(g, mesh.block_of(want[n], model.layout.specs[n]))
            for n, g in got.items()}
    rec[arch] = dict(
        loss=[float(loss0), float(loss1)], n_tokens=int(metrics["n_tokens"]),
        worst=max(errs.values()), worst_leaf=max(errs, key=errs.get),
        shapes_ok=all(tuple(g.shape) == tuple(p.shape)
                      for (n, g), p in zip(got.items(), model.parameters())),
        routes=dict(routes), collectives=cnt.collectives,
        seconds=time.perf_counter() - t0)

# a weight gathered with a one-replica adjoint vs the sum adjoint: every
# rank's loss uses the whole weight with its own inputs
w_full = torch.randn(8, 6, generator=torch.Generator().manual_seed(3))
xs = [torch.randn(5, 8, generator=torch.Generator().manual_seed(100 + r))
      for r in range(4)]
spec = ("data", "model")
blk = mesh.block_of(w_full, spec).clone().requires_grad_()
one = mesh.gather(blk, (8, 6), spec)
g_one, = torch.autograd.grad((xs[rank] @ one).square().sum(), blk)
blk = blk.detach().clone().requires_grad_()
summed = mesh.gather_sum(blk, (8, 6), spec, (None, None), ("data", "model"))
g_sum, = torch.autograd.grad((xs[rank] @ summed).square().sum(), blk)
w = w_full.clone().requires_grad_()
g_true, = torch.autograd.grad(sum((x @ w).square().sum() for x in xs), w)
want_blk = mesh.block_of(g_true, spec)
rec["adjoint"] = dict(sum=rel_err(g_sum, want_blk),
                      one_replica=rel_err(g_one, want_blk))

# elastic checkpoint: saved on (2, 2), restored onto (4, 1)
ocfg = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=8)
cfg = config("yi-9b")
state = init_train_state(torch.Generator().manual_seed(0), cfg, ocfg,
                         mesh=mesh, device="cpu")
step = make_train_step(cfg, ocfg, mesh, B, kv_block=16)
state, _ = step(state, {"tokens": synth_tokens(5, 0, B, S + 1, cfg.vocab)})
lay = state["params"].layout
whole = {n: mesh.gather(p.data, lay.shapes[n], lay.specs[n])
         for n, p in state["params"].named_parameters()}
whole_m = {n: mesh.gather(t, lay.shapes[n], lay.specs[n])
           for n, t in state["opt"]["m"].items()}
ckpt = CheckpointManager(os.path.join(out, "ckpt"), async_write=False)
with Largest() as probe:     # every tensor an op makes during the save
    ckpt.save(1, state)
sharded = [n for n, sp in lay.specs.items() if any(sp)]
rec["save"] = dict(
    largest=probe.numel,
    own=max(t.numel() for tree in (dict(state["params"].named_parameters()),
                                   state["opt"]["m"], state["opt"]["v"])
            for t in tree.values()),
    whole=max(math.prod(lay.shapes[n]) for n in sharded))
torch.distributed.barrier()
mesh_b = make_mesh((4, 1), ("data", "model"), device="cpu")
template = init_train_state(torch.Generator().manual_seed(1), cfg, ocfg,
                            mesh=mesh_b, device="cpu")
blocks = sh.param_shardings(template["params"], mesh_b, sh.MeshAxes())
restored = ckpt.restore(template, shardings={
    "params": blocks, "opt": {"m": blocks, "v": blocks, "step": None}})
lay_b = restored["params"].layout
rec["elastic"] = dict(
    params=all(torch.equal(p.data, mesh_b.block_of(whole[n], lay_b.specs[n]))
               for n, p in restored["params"].named_parameters()),
    moments=all(torch.equal(t, mesh_b.block_of(whole_m[n], lay_b.specs[n]))
                for n, t in restored["opt"]["m"].items()),
    step=int(restored["opt"]["step"]),
    blocks_differ=any(tuple(p.shape) != lay_b.shapes[n]
                      for n, p in restored["params"].named_parameters()),
    mesh_b=mesh_b.shape)

# SIGTERM to rank 1 alone, during step 1 of the trainer on its own mesh:
# every rank must save step 2 and exit (the save is a collective)
torch.distributed.barrier()
mesh.close()
mesh_b.close()
from repro_torch.launch import train as train_main
from repro_torch.train import fault
end_step = fault.StragglerMonitor.end_step
def end_step_signalled(self, step):
    if rank == 1 and step == 1:
        os.kill(os.getpid(), signal.SIGTERM)
    return end_step(self, step)
fault.StragglerMonitor.end_step = end_step_signalled
os.environ["WORLD_SIZE"] = "4"
pdir = os.path.join(out, "preempt")
history = train_main.main([
    "--arch", "yi-9b", "--smoke", "--steps", "6", "--global-batch", "2",
    "--seq-len", "16", "--kv-block", "16", "--ckpt-dir", pdir,
    "--ckpt-every", "100", "--log-every", "100", "--device", "cpu",
    "--model-axis", "2"])      # destroys the process group at its end
rec["preempt"] = dict(steps=[h["step"] for h in history])
if rank == 0:
    ck = CheckpointManager(pdir)
    rec["preempt"].update(saved=ck.all_steps(), opt_step=int(np.load(
        os.path.join(pdir, "step_2", "opt__step.npy"))))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
"""


def _ranks(out, n):
    return [json.load(open(os.path.join(str(out), f"rank{r}.json")))
            for r in range(n)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train")
    torch_ranks.spawn(WORKER, 4, [out, ",".join(ARCHS_2x2)], out,
                      timeout=600)
    return _ranks(out, 4)


def test_yi_9b_sharded_losses_match_reference_meshless(tmp_path):
    """The reference's own case on (2, 4), against the reference."""
    import dataclasses
    from repro.configs import get_config as ref_get_config
    from repro.train import OptConfig as RefOptConfig
    from repro.train import init_train_state as ref_init_train_state
    from repro.train import make_train_step as ref_make_train_step
    from repro.train.data import SyntheticDataset as RefSyntheticDataset
    from repro_torch.models.convert import named_from_numpy
    from torch_shard_cases import config

    ref_cfg = dataclasses.replace(ref_get_config("yi-9b", smoke=True),
                                  dtype="float32")
    ocfg = RefOptConfig(lr=1e-3, warmup_steps=1, decay_steps=8)
    state = ref_init_train_state(jax.random.PRNGKey(0), ref_cfg, ocfg, None)
    np.savez(tmp_path / "yi.npz", **named_from_numpy(
        jax.tree.map(np.asarray, state["params"]), config("yi-9b")))
    step = ref_make_train_step(ref_cfg, ocfg, None, 8, kv_block=32,
                               donate=False)
    ds = RefSyntheticDataset(ref_cfg.vocab, 32, 8)
    ref = []
    for i in range(2):
        state, m = step(state, ds.batch_at(i))
        ref.append(float(m["loss"]))
    torch_ranks.spawn(YI_WORKER, 8, [tmp_path], tmp_path, timeout=600)
    recs = _ranks(tmp_path, 8)
    for r in recs:
        assert r["mesh"] == {"data": 2, "model": 4}
        assert r["n_tokens"] == 8 * 32
        np.testing.assert_allclose(r["losses"], ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS_2x2)
def test_sharded_step0_gradients_match_meshless(sharded, arch):
    for r in sharded:
        got = r[arch]
        assert got["shapes_ok"]
        assert got["n_tokens"] == 2 * (15 if arch.endswith(":odd") else 16)
        np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=2e-6)
        assert got["worst"] < GRAD_TOL, (arch, got["worst_leaf"],
                                         got["worst"])
        routes, coll = got["routes"], got["collectives"]
        assert "all-reduce" in coll     # the loss, the gradients
        if arch in ("recurrentgemma-9b", "rwkv6-3b"):
            scan = ("cp_vector_recurrence" if arch.startswith("recurrent")
                    else "cp_matrix_recurrence")
            assert routes.get(scan, 0) > 0 and routes.get("cp_halo", 0) > 0
            assert "collective-permute" in coll
        if arch == "fnet-350m":
            assert routes.get("distributed_seq_fft", 0) > 0
        elif arch == "yi-9b:odd":      # 15 positions stay whole
            assert not routes.get("_gather_seq")
        elif arch != "rwkv6-3b":       # every other arch has attention
            assert routes.get("_gather_seq", 0) > 0
        if arch.startswith(("mixtral-8x22b", "deepseek-v2-236b")):
            assert routes.get("moe_fwd_sharded", 0) > 0


def test_one_replica_adjoint_gives_the_wrong_weight_gradient(sharded):
    for r in sharded:
        assert r["adjoint"]["sum"] < 1e-6
        assert r["adjoint"]["one_replica"] > 0.1


def test_sharded_save_holds_no_whole_leaf_off_rank_0(sharded):
    """Saving a sharded state collects each leaf onto rank 0 only: no op
    on another rank makes a tensor larger than the rank's largest block,
    which is smaller than the largest sharded leaf."""
    for r in sharded:
        s = r["save"]
        assert s["own"] < s["whole"]
        if r["rank"] == 0:
            assert s["largest"] >= s["whole"]
        else:
            assert s["largest"] <= s["own"], s


def test_preemption_of_one_rank_saves_one_step_on_every_rank(sharded):
    """SIGTERM reaches rank 1 alone, in step 1: every rank finishes step 1,
    joins the save of step 2 and exits."""
    for r in sharded:
        assert r["preempt"]["steps"] == [0, 1]
    assert sharded[0]["preempt"]["saved"] == [2]
    assert sharded[0]["preempt"]["opt_step"] == 2


def test_elastic_checkpoint_restores_onto_another_mesh(sharded):
    for r in sharded:
        e = r["elastic"]
        assert e["mesh_b"] == {"data": 4, "model": 1}
        assert e["params"] and e["moments"] and e["step"] == 1
        assert e["blocks_differ"]
