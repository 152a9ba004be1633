"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against
the reference's, on the CPU.

The reference's side runs in one JAX subprocess over 512 placeholder
host devices (``repro.launch.dryrun`` sets them as it is imported):
``input_specs``, ``model_flops_for`` and ``shape_supported`` for every
arch x shape on the 16x16 and the 2x16x16 mesh, and ``lower_fft_cell(
"fft_128", ...)`` for pencil and slab on both.  The port's side runs in
a subprocess of its own too (the dry run joins a fake process group of
256 or 512 ranks, and a process holds one world): the same calls on the
port's production meshes.  Each input's block is the reference's global
shape cut by the batch spec, with the same dtype and the same
``batch_spec``; the FLOP models and the skip reasons are equal; the FFT
cells count the reference's collectives (kind, count, bytes) and
``comm_model_bytes``.

Then the check that the dry run counts what a run sends: on a fake
(data 2, model 2) world, ``count_lm_step`` of smoke-size train, prefill
and decode steps, against 4 real gloo ranks running the same steps
through the entry points a user calls (``init_train_state(mesh=)`` and
``make_train_step``, ``init_caches(mesh=)`` and ``make_serve_steps``),
rank 0's counts equal kind by kind, count and bytes.  Last, the module
refuses to run inside a live process group, ``run_cell`` caches a
finished cell and retries an errored one, and the CLI exits 1 when a
cell errors.
"""

import json
import os
import subprocess
import sys

import pytest

import torch_ranks
from conftest import SRC, run_multidevice
from repro_torch.launch import dryrun

SMOKE = ["yi-9b", "mixtral-8x22b", "whisper-base", "paligemma-3b"]
KINDS = {"train": 32, "prefill": 32, "decode": 32}    # seq_len of each
GB, KV = 4, 16

REFERENCE = r"""
import json
from repro.launch import dryrun as d
from repro.configs import ASSIGNED, SHAPES, get_config, shape_supported
from repro.launch.mesh import make_production_mesh
out = {"inputs": {}, "fft": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for a in ASSIGNED:
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            specs, bspec = d.input_specs(cfg, shape, mesh, mp)
            ok, why = shape_supported(cfg, shape)
            out["inputs"][f"{a}|{s}|{int(mp)}"] = dict(
                specs={k: [list(v.shape), str(v.dtype),
                           [list(e) if isinstance(e, tuple) else e
                            for e in v.sharding.spec]]
                       for k, v in specs.items()},
                batch_spec=list(bspec) if isinstance(bspec, tuple) else bspec,
                flops=d.model_flops_for(cfg, shape), ok=ok, why=why)
    for dec in ("pencil", "slab"):
        r = d.lower_fft_cell("fft_128", mp, dec)
        out["fft"][f"{dec}|{int(mp)}"] = {k: r.get(k) for k in (
            "status", "reason", "collectives", "comm_model_bytes", "mesh",
            "n_devices", "arch", "shape")}
json.dump(out, open(%r, "w"))
print("OK")
"""

PORT = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs import ASSIGNED, SHAPES, ShapeSpec, get_config, shape_supported
from repro_torch.launch import dryrun as d
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
out_path, smoke, kinds, gb, kv = sys.argv[1], sys.argv[2].split(","), json.loads(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
out = {"inputs": {}, "fft": {}, "counts": {}}
for mp in (False, True):
    with d.fake_world(512 if mp else 256):
        mesh = make_production_mesh(multi_pod=mp, device="cpu")
        for a in ASSIGNED:
            cfg = get_config(a)
            for s, shape in SHAPES.items():
                specs, bspec = d.input_specs(cfg, shape, mesh, mp)
                ok, why = shape_supported(cfg, shape)
                out["inputs"][f"{a}|{s}|{int(mp)}"] = dict(
                    specs={k: [list(v.shape), str(v.dtype).removeprefix("torch."),
                               v.device.type] for k, v in specs.items()},
                    batch_spec=list(bspec) if isinstance(bspec, tuple) else bspec,
                    flops=d.model_flops_for(cfg, shape), ok=ok, why=why)
        mesh.close()
    for dec in ("pencil", "slab"):
        r = d.lower_fft_cell("fft_128", mp, dec)
        out["fft"][f"{dec}|{int(mp)}"] = r
with d.fake_world(4):
    mesh = make_local_mesh(model=2, device="cpu")
    for a in smoke:
        cfg = get_config(a, smoke=True)
        for kind, seq in kinds.items():
            got = d.count_lm_step(cfg, ShapeSpec(kind, kind, seq, gb), mesh, kv)
            out["counts"][f"{a}|{kind}"] = got["collectives"]
            out["counts"][f"{a}|{kind}|flops"] = got["flops"]
    mesh.close()
# a live process group: the dry run refuses to join another
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    d.lower_fft_cell("fft_128", False)
    out["refused"] = None
except RuntimeError as e:
    out["refused"] = str(e)
dist.destroy_process_group()
json.dump(out, open(out_path, "w"))
print("OK")
"""

WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_caches, init_params
from repro_torch.parallel import sharding as sh
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train import cast_to_compute, make_serve_steps
from repro_torch.train.data import synth_tokens
from torch_shard_cases import stub_inputs

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
smoke, kinds = sys.argv[4].split(","), json.loads(sys.argv[5])
gb, kv = int(sys.argv[6]), int(sys.argv[7])
torch.set_num_threads(1)
join(rank, port, 4)
mesh = make_local_mesh(model=2, device="cpu")
axes = sh.mesh_axes(mesh)
rec = {"rank": rank}
for a in smoke:
    cfg = get_config(a, smoke=True)
    gen = lambda: torch.Generator().manual_seed(0)
    for kind, seq in kinds.items():
        stub = {k: torch.from_numpy(v) for k, v in stub_inputs(cfg, gb).items()}
        if kind == "train":
            ocfg = OptConfig(moment_dtype="bfloat16")
            state = init_train_state(gen(), cfg, ocfg, mesh=mesh, axes=axes)
            step = make_train_step(cfg, ocfg, mesh, gb, kv_block=kv)
            batch = {"tokens": torch.from_numpy(
                synth_tokens(0, 0, gb, seq + 1, cfg.vocab)), **stub}
            with mesh.counting() as cnt:
                step(state, batch)
        else:
            max_len = seq + (cfg.n_frontend_tokens if cfg.prefix_lm else 0)
            model = sh.shard_model(init_params(cfg, gen(), "cpu"), mesh, axes)
            cast_to_compute(model, cfg.dtype)
            caches = init_caches(
                cfg, gb, max_len,
                enc_len=cfg.n_frontend_tokens if cfg.encoder else 0,
                dtype=torch.bfloat16, device="cpu", mesh=mesh)
            prefill, decode = make_serve_steps(cfg, gb, max_len, kv_block=kv,
                                               mesh=mesh)
            with mesh.counting() as cnt:
                if kind == "prefill":
                    prefill(model, torch.from_numpy(
                        synth_tokens(0, 0, gb, seq, cfg.vocab)), caches, **stub)
                else:
                    decode(model, torch.zeros(gb, 1, dtype=torch.int32),
                           caches, seq - 1)
        rec[f"{a}|{kind}"] = cnt.collectives
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = os.path.join(str(tmp_path_factory.mktemp("dryrun_ref")),
                        "ref.json")
    run_multidevice(REFERENCE % path, n_devices=512, timeout=600)
    return json.load(open(path))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = os.path.join(str(tmp_path_factory.mktemp("dryrun_port")),
                        "port.json")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", PORT, path, ",".join(SMOKE),
         json.dumps(KINDS), str(GB), str(KV)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    return json.load(open(path))


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_real")
    torch_ranks.spawn(WORKER, 4, [out, ",".join(SMOKE), json.dumps(KINDS),
                                  GB, KV], out)
    return json.load(open(os.path.join(str(out), "rank0.json")))


@pytest.mark.parametrize("mp", [0, 1])
def test_input_specs_match_reference(reference, port, mp):
    keys = [k for k in reference["inputs"] if k.endswith(f"|{mp}")]
    assert len(keys) == 40 and set(keys) <= set(port["inputs"])
    dp = {0: 16, 1: 32}[mp]
    for k in keys:
        want, got = reference["inputs"][k], port["inputs"][k]
        assert got["batch_spec"] == want["batch_spec"], k
        assert set(got["specs"]) == set(want["specs"]), k
        for name, (shape, dtype, spec) in want["specs"].items():
            block = list(shape)
            if spec[0] is not None:
                block[0] //= dp
            assert got["specs"][name] == [block, dtype, "cpu"], (k, name)


@pytest.mark.parametrize("mp", [0, 1])
def test_model_flops_and_skips_match_reference(reference, port, mp):
    for k, want in reference["inputs"].items():
        if not k.endswith(f"|{mp}"):
            continue
        got = port["inputs"][k]
        assert got["flops"] == want["flops"], k
        assert (got["ok"], got["why"]) == (want["ok"], want["why"]), k


@pytest.mark.parametrize("cell", ["pencil|0", "pencil|1", "slab|0",
                                  "slab|1"])
def test_fft_cells_match_reference(reference, port, cell):
    want, got = reference["fft"][cell], port["fft"][cell]
    assert got["status"] == want["status"], (got, want)
    if want["status"] == "skip":
        assert got["reason"] == want["reason"]
        return
    assert got["collectives"] == want["collectives"]
    assert got["comm_model_bytes"] == want["comm_model_bytes"]
    for k in ("mesh", "n_devices", "arch", "shape"):
        assert got[k] == want[k], k
    assert got["count_s"] >= 0.0
    r = got["roofline"]
    assert r["collective_bytes_per_device"] == want["comm_model_bytes"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["bytes_source"] == "cost_model"


@pytest.mark.parametrize("case", [f"{a}|{k}" for a in SMOKE for k in KINDS])
def test_fake_count_equals_real_run(port, real, case):
    assert port["counts"][case] == real[case]
    assert port["counts"][case]["all-to-all"]["count"] > 0
    if case.endswith("train"):
        assert port["counts"][case + "|flops"] > 0


def test_dry_run_refuses_a_live_group(port):
    assert port["refused"] is not None
    assert "process group" in port["refused"]


def test_run_cell_caches_and_retries(tmp_path, capsys):
    calls = []

    def ok():
        calls.append("ok")
        return {"status": "ok", "count_s": 0.5, "roofline": {
            "compute_s": 1.0, "memory_s": 0.5, "collective_s": 0.25,
            "bottleneck": "compute"}}

    def bad():
        calls.append("bad")
        raise ValueError("no such mesh")

    out = str(tmp_path)
    assert dryrun.run_cell("a", ok, out, False)["status"] == "ok"
    assert dryrun.run_cell("a", ok, out, False)["status"] == "ok"
    assert calls == ["ok"]                       # the second was cached
    assert dryrun.run_cell("a", ok, out, True)["status"] == "ok"
    assert calls == ["ok", "ok"]                 # --force runs it again
    rec = dryrun.run_cell("b", bad, out, False)
    assert rec["status"] == "error"
    assert rec["error"] == "ValueError: no such mesh"
    assert "Traceback" in rec["traceback"]
    assert json.load(open(os.path.join(out, "b.json")))["status"] == "error"
    dryrun.run_cell("b", bad, out, False)
    assert calls == ["ok", "ok", "bad", "bad"]   # an error always retries
    assert "[cached] a: ok" in capsys.readouterr().out


def test_cli_exits_1_on_an_error(tmp_path):
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1
    rec = json.load(open(os.path.join(str(tmp_path),
                                      "no-such-arch-train_4k-sp.json")))
    assert rec["status"] == "error" and "KeyError" in rec["error"]
