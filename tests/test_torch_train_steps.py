"""The port's LM train step against the JAX package, on the CPU, and its
command line.

``make_train_step`` over 5 steps from one converted state (the
reference's ``init_train_state`` carried across with
``params_from_numpy`` and ``opt_state_from_numpy``) on the same
``SyntheticDataset`` batches: the loss trajectory within rtol 1e-4 in
float32 and 5e-2 in bf16, and falling (``tests/test_models_smoke.py:48``)
for yi-9b and mixtral-8x22b.  Then resuming from a checkpoint against an
uninterrupted run (rtol 1e-6, ``tests/test_substrate.py:187``), the
optimizer state's conversion, and ``launch.train`` run as a user runs
it (``--device cpu``), in a subprocess.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import REPO, SRC
from repro.configs import get_config as ref_get_config
from repro.train import OptConfig as RefOptConfig
from repro.train import init_train_state as ref_init_train_state
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import (named_from_numpy,
                                        opt_state_from_numpy)
from repro_torch.train import (OptConfig, init_train_state, make_shard_ctx,
                               make_train_step)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset

from torch_train_cases import check_trajectory


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b"])
def test_trajectory_matches_reference_and_falls(arch, dtype):
    losses = check_trajectory(arch, dtype)
    assert losses[-1] < losses[0]


def test_resume_matches_uninterrupted_run(tmp_path):
    """tests/test_substrate.py:161-187 on the port: 4 straight steps, and
    2 steps, save, restore into a fresh state, 2 more."""
    cfg = get_config("yi-9b", smoke=True)
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=8)
    step_fn = make_train_step(cfg, ocfg, None, 2, kv_block=32)
    ds = SyntheticDataset(cfg.vocab, 32, 2)

    def fresh():
        return init_train_state(torch.Generator().manual_seed(0), cfg, ocfg,
                                device="cpu")

    state = fresh()
    full = [float(step_fn(state, ds.batch_at(i))[1]["loss"])
            for i in range(4)]
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state2 = fresh()
    for i in range(2):
        step_fn(state2, ds.batch_at(i))
    mgr.save(2, state2)
    state3 = mgr.restore(fresh())
    assert int(state3["opt"]["step"]) == 2
    resumed = [float(step_fn(state3, ds.batch_at(i))[1]["loss"])
               for i in range(2, 4)]
    np.testing.assert_allclose(resumed, full[2:], rtol=1e-6)


def test_opt_state_from_numpy_bitwise_in_parameter_order():
    """bf16 moments and the step cross bitwise, keyed in the order of
    ``Model.named_parameters()`` (the order ``params_from_numpy`` fills)."""
    ref_cfg = ref_get_config("deepseek-v2-236b", smoke=True)
    cfg = get_config("deepseek-v2-236b", smoke=True)
    ocfg = RefOptConfig(moment_dtype="bfloat16")
    shapes = jax.eval_shape(
        lambda k: ref_init_train_state(k, ref_cfg, ocfg)["opt"],
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    opt = jax.tree.map(lambda a: np.asarray(
        rng.randn(*a.shape) if a.shape else 7).astype(a.dtype), shapes)
    got = opt_state_from_numpy(opt, cfg, device="cpu")
    names = [n for n, _ in Model(cfg, device="meta").named_parameters()]
    assert list(got["m"]) == names and list(got["v"]) == names
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    for mom in ("m", "v"):
        want = named_from_numpy(opt[mom], cfg)
        for k, t in got[mom].items():
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                want[k].view(np.uint16).view(np.int16))


def test_train_step_keeps_fp32_masters_and_meshless_only():
    cfg = get_config("h2o-danube-3-4b", smoke=True)      # bf16 compute
    ocfg = OptConfig(moment_dtype="bfloat16")
    state = init_train_state(torch.Generator().manual_seed(1), cfg, ocfg,
                             device="cpu")
    make_train_step(cfg, ocfg, None, 2, kv_block=16)(
        state, SyntheticDataset(cfg.vocab, 16, 2).batch_at(0))
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in state["params"].parameters())
    assert all(m.dtype == torch.bfloat16 for m in state["opt"]["m"].values())
    # meshless stays meshless; a mesh gets the reference's context, the
    # batch replicated where it does not divide over the data axis
    assert make_shard_ctx(None, 2) is None

    class Stub:
        shape = {"data": 2, "model": 4}
        axis_names = ("data", "model")
    assert tuple(make_shard_ctx(Stub, 4))[1:] == ("data", "model", "model")
    assert make_shard_ctx(Stub, 3).dp is None

    # the pod axis splits the batch where the mesh has one, as the
    # caches (init_caches(mesh=)) split it
    class Pods:
        shape = {"pod": 2, "data": 2, "model": 4}
        axis_names = ("pod", "data", "model")
    assert make_shard_ctx(Pods, 8).dp == ("pod", "data")
    assert make_shard_ctx(Pods, 2).dp is None


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_launch_train_cli_resumes(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``: 4
    steps with a checkpoint at 2 and at the end; a second run of 6 steps
    resumes at 4 and writes its metrics."""
    base = ["-m", "repro_torch.launch.train", "--arch", "yi-9b", "--smoke",
            "--device", "cpu", "--global-batch", "2", "--seq-len", "32",
            "--kv-block", "16", "--log-every", "1", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    lines = _run(base + ["--steps", "4"])
    print("\n".join(lines[-2:]))
    assert lines[-1].startswith("final loss")
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]
    out = tmp_path / "m.json"
    lines = _run(base + ["--steps", "6", "--metrics-out", str(out)])
    assert "resumed from checkpoint at step 4" in lines
    assert [r["step"] for r in json.loads(out.read_text())] == [4, 5]
