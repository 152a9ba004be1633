"""The port's spectral-filter train step against the JAX package, on the
CPU: ``make_spectral_train_step`` (SGD over the real ``gate`` and
``filter`` of ``F(gate . x) . filter``, through the plan's adjoint) from
the reference example's init and target (``examples/train_lm.py``).

  * meshless at 16^3: the loss at every step and both params after 5
    steps within ``1e-5·max|ref|``, with the default local FFT and with
    ``local_impl="pallas"`` (the kernels' plain versions on the CPU);
  * on 4 gloo ranks against a 4-device JAX run, both planned by
    ``Croft3D.tuned(..., grad=True, mode="model")`` on a (2, 2) ("y",
    "x") mesh (the port's tuner with the reference's cost-model
    constants): byte-equal plan tokens, then each rank's blocks of the
    params after 5 steps and the summed loss of every step within the
    same tolerance;
  * ``examples/train_lm_torch.py --device cpu``, both workloads, run in
    a subprocess as a user runs it: each prints "OK" once its loss fell.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conftest import REPO, SRC, run_multidevice
from repro.core import Croft3D as RefCroft3D
from repro.models.spectral import (init_spectral_filter_params as
                                   ref_init_params,
                                   spectral_filter_apply as ref_apply)
from repro.train import make_spectral_train_step as ref_make_step
from repro.tuning import cost_model as ref_cost
from repro_torch.core import Croft3D, FFTOptions
from repro_torch.models.spectral import (init_spectral_filter_params,
                                         spectral_filter_apply)
from repro_torch.train import make_spectral_train_step

N = 16
STEPS = 5
LR = 0.05
TOL = 1e-5      # x max|ref|
# the reference's cost-model constants, patched into the port's tuner so
# that model mode prices the candidates as the reference does (the port's
# own priors are the H100's)
CONSTANTS = {name: getattr(ref_cost, name) for name in (
    "IMPL_EFFICIENCY", "_DEFAULT_EFFICIENCY", "LOCAL_PASSES",
    "COLLECTIVE_LATENCY_S", "REPLAN_PASSES", "PEAK_FLOPS", "HBM_BW",
    "LINK_BW")}


def _problem(shape, spectrum_shape):
    """examples/train_lm.py:85-89: x and the true params from
    RandomState(0)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    gate = (1.0 + 0.3 * rng.randn(*shape)).astype(np.float32)
    filt = (1.0 + 0.3 * rng.randn(*spectrum_shape)).astype(np.float32)
    return x, gate, filt


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def reference_meshless():
    shape = (N,) * 3
    plan = RefCroft3D(shape, problem="r2c")
    x, gate, filt = _problem(shape, plan.spectrum_shape)
    target = ref_apply(plan, {"gate": jnp.asarray(gate),
                              "filter": jnp.asarray(filt)}, jnp.asarray(x))
    step, _ = ref_make_step(plan, lr=LR)
    params = ref_init_params(jax.random.PRNGKey(1), plan)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, jnp.asarray(x), target)
        losses.append(float(loss))
    return {"losses": losses, "target": np.asarray(target),
            **{k: np.asarray(v) for k, v in params.items()}}


@pytest.mark.parametrize("opts", [None, "pallas"])
def test_meshless_step_matches_reference(reference_meshless, opts):
    ref = reference_meshless
    kw = {} if opts is None else {
        "strategy": "packed", "opts": FFTOptions(local_impl="pallas")}
    plan = Croft3D((N,) * 3, problem="r2c", device="cpu", **kw)
    x, gate, filt = _problem(plan.shape, plan.spectrum_shape)
    x = torch.from_numpy(x)
    with torch.no_grad():
        target = spectral_filter_apply(plan, {
            "gate": torch.from_numpy(gate),
            "filter": torch.from_numpy(filt)}, x)
    assert _rel(target.numpy(), ref["target"]) < TOL
    step, _ = make_spectral_train_step(plan, lr=LR)
    params = init_spectral_filter_params(None, plan)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, x, target)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"], rtol=TOL)
    assert losses[-1] < losses[0]
    for k in ("gate", "filter"):
        assert _rel(params[k].numpy(), ref[k]) < TOL, k


def test_loss_fn_gradients_are_the_references(reference_meshless):
    """The raw ``loss_fn``'s gradients at the identity init against
    ``jax.grad`` of the reference's (the update's only input)."""
    shape = (N,) * 3
    rplan = RefCroft3D(shape, problem="r2c")
    x, _, _ = _problem(shape, rplan.spectrum_shape)
    target = jnp.asarray(reference_meshless["target"])
    _, ref_loss = ref_make_step(rplan)
    p0 = ref_init_params(jax.random.PRNGKey(1), rplan)
    want = jax.grad(ref_loss)(p0, jnp.asarray(x), target)
    plan = Croft3D(shape, problem="r2c", device="cpu")
    _, loss_fn = make_spectral_train_step(plan)
    params = {k: v.requires_grad_()
              for k, v in init_spectral_filter_params(None, plan).items()}
    loss_fn(params, torch.from_numpy(x),
            torch.from_numpy(reference_meshless["target"].copy())).backward()
    for k in ("gate", "filter"):
        assert _rel(params[k].grad.numpy(), want[k]) < TOL, k


REFERENCE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.core import Croft3D
from repro.models.spectral import (init_spectral_filter_params,
                                   place_spectral_filter_params,
                                   spectral_filter_apply)
from repro.train import make_spectral_train_step
N, STEPS, LR, out = %d, %d, %r, %r
mesh = jax.make_mesh((2, 2), ("y", "x"))
shape = (N, N, N)
plan = Croft3D.tuned(shape, mesh, mode="model", problem="r2c", grad=True)
rng = np.random.RandomState(0)
x = rng.randn(*shape).astype(np.float32)
true = {"gate": (1.0 + 0.3 * rng.randn(*shape)).astype(np.float32),
        "filter": (1.0 + 0.3 * rng.randn(*plan.spectrum_shape)).astype(
            np.float32)}
xj = jax.device_put(jnp.asarray(x, plan.input_dtype), plan.input_sharding)
target = spectral_filter_apply(
    plan, place_spectral_filter_params(plan, {k: jnp.asarray(v)
                                              for k, v in true.items()}), xj)
step, _ = make_spectral_train_step(plan, lr=LR)
params = place_spectral_filter_params(
    plan, init_spectral_filter_params(jax.random.PRNGKey(1), plan))
losses = []
for _ in range(STEPS):
    params, loss = step(params, xj, target)
    losses.append(float(loss))
np.savez(out + ".npz", gate=np.asarray(params["gate"]),
         filter=np.asarray(params["filter"]))
json.dump({"decomp": plan.decomp.to_token(), "opts": plan.opts.to_token(),
           "strategy": plan.strategy, "losses": losses},
          open(out + ".json", "w"))
print("OK reference")
"""

WORKER = r"""
import json, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.core import Croft3D, make_mesh
from repro_torch.models.spectral import (init_spectral_filter_params,
                                         place_spectral_filter_params,
                                         spectral_filter_apply)
from repro_torch.train import make_spectral_train_step
from repro_torch.tuning import cost_model
for k, v in %r.items():
    setattr(cost_model, k, v)
rank, port, ref, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
N, STEPS, LR = int(sys.argv[5]), int(sys.argv[6]), float(sys.argv[7])
join(rank, port, 4)
mesh = make_mesh((2, 2), ("y", "x"), device="cpu")
shape = (N, N, N)
plan = Croft3D.tuned(shape, mesh, mode="model", problem="r2c", grad=True)
rng = np.random.RandomState(0)
x = rng.randn(*shape).astype(np.float32)
true = {"gate": torch.from_numpy((1.0 + 0.3 * rng.randn(*shape)).astype(
            np.float32)),
        "filter": torch.from_numpy((1.0 + 0.3 * rng.randn(
            *plan.spectrum_shape)).astype(np.float32))}
xl = torch.from_numpy(np.ascontiguousarray(x[plan.input_sharding]))
with torch.no_grad():
    target = spectral_filter_apply(plan, place_spectral_filter_params(
        plan, true), xl)
step, _ = make_spectral_train_step(plan, lr=LR)
params = place_spectral_filter_params(plan,
                                      init_spectral_filter_params(None, plan))
losses = []
for _ in range(STEPS):
    params, loss = step(params, xl, target)
    losses.append(float(loss))
want = np.load(ref + ".npz")
rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
rec = {"decomp": plan.decomp.to_token(), "opts": plan.opts.to_token(),
       "strategy": plan.strategy, "losses": losses,
       "gate": rel(params["gate"].numpy(), want["gate"][plan.input_sharding]),
       "filter": rel(params["filter"].numpy(),
                     want["filter"][plan.output_sharding])}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    d = tmp_path_factory.mktemp("spectral")
    ref = str(d / "ref")
    run_multidevice(REFERENCE % (N, STEPS, LR, ref), n_devices=4)
    torch_ranks.spawn(WORKER % (CONSTANTS,), 4, [ref, d, N, STEPS, LR], d)
    with open(ref + ".json") as f:
        want = json.load(f)
    return want, [json.loads((d / f"rank{r}.json").read_text())
                  for r in range(4)]


def test_distributed_plan_tokens_byte_equal(distributed):
    want, ranks = distributed
    for rec in ranks:
        assert (rec["decomp"], rec["opts"], rec["strategy"]) == (
            want["decomp"], want["opts"], want["strategy"])


def test_distributed_step_matches_reference(distributed):
    want, ranks = distributed
    for rec in ranks:
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=TOL)
        assert rec["gate"] < TOL and rec["filter"] < TOL, rec
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("args", [
    ["--steps", "5", "--size", "16"],
    ["--workload", "lm", "--steps", "12"],
])
def test_train_lm_example(args):
    lines = _run_example(["examples/train_lm_torch.py", "--device", "cpu",
                          *args])
    print("\n".join(lines[-2:]))
    assert lines[-1] == "OK"


def _run_example(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()
