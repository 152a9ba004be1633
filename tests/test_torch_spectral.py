"""The port's FNet spectral mixer (``models/spectral.py``) and the
fnet-350m model against the JAX reference, on the CPU.

* ``spectral_mixer`` against ``repro.models.spectral.spectral_mixer`` on
  the same numpy input, within ``2e-4·max|ref|`` (float32; a bf16 input
  within ``5e-2``), past the six-step radix too;
* ``distributed_seq_fft`` on a 2x2 gloo mesh (batch over ``data``,
  sequence over ``model``) against the local mixer within 2e-4
  (``tests/test_parallel.py:126``), K in {1, 2};
* the fnet-350m smoke config: parameters carried across from the
  reference's ``init_params`` by ``params_from_numpy``, logits in
  float32 within ``2e-4·max|ref|`` (``tests/test_models_smoke.py:111``);
* the learned spectral-filter helpers against the reference's on one
  meshless plan (c2c and packed r2c), and placed on a mesh;
* the config registry, the shape table and ``shape_supported``
  (``tests/test_configs.py:108``); the serve CLI refusing the
  encoder-only model; ``examples/serve_lm_torch.py`` on the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import shape_supported as ref_shape_supported
from repro.core import Croft3D as RefCroft3D
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import spectral as ref_spectral
from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 shape_supported)
from repro_torch.core import Croft3D
from repro_torch.models import forward, init_caches, params_from_numpy
from repro_torch.models import spectral

ARCH = "fnet-350m"
TOL = 2e-4          # tests/test_parallel.py:126, tests/test_models_smoke.py:111
BF16_TOL = 5e-2     # bf16 rounding differs between the two frameworks
FILT_TOL = 1e-5     # tests/test_kernels_fft.py:68


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# --- the mixer ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 32, 64), (2, 128, 16), (1, 8192, 8)])
def test_spectral_mixer_matches_reference(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = ref_spectral.spectral_mixer(jnp.asarray(x))
    got = spectral.spectral_mixer(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got, want, TOL)


def test_spectral_mixer_bf16_matches_reference():
    x = np.random.RandomState(1).randn(2, 64, 32).astype(np.float32)
    want = ref_spectral.spectral_mixer(jnp.asarray(x, jnp.bfloat16))
    got = spectral.spectral_mixer(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL)


@pytest.mark.parametrize("shape", [(2, 16, 8), (2, 128, 64), (1, 8192, 4)])
def test_spectral_mixer_gradient_matches_the_einsum_formula(shape):
    """The mixer's gradient through the matmul local FFT (products into
    ``out=`` tensors, under ``grad.vjp.Linear``) against autograd through
    the same DFTs written as one ``einsum``, in float64."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, requires_grad=True)
    r = torch.randn(shape, generator=g)
    (spectral.spectral_mixer(x) * r).sum().backward()

    def dft(n):
        k = torch.arange(n, dtype=torch.float64)
        return torch.exp(-2j * torch.pi * torch.outer(k, k) / n)

    x64 = x.detach().double().requires_grad_()
    y = torch.einsum("ts,bsd,de->bte", dft(shape[1]),
                     x64.to(torch.complex128), dft(shape[2])).real
    (y * r.double()).sum().backward()
    _close(x.grad, x64.grad.numpy(), TOL)


WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.core import make_mesh
from repro_torch.models import spectral

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
join(rank, port, 4)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
rng = np.random.RandomState(0)
x = rng.randn(4, 32, 64).astype(np.float32)
ref = spectral.spectral_mixer(torch.from_numpy(x))
c = mesh.coords
b, s = slice(2 * c["data"], 2 * c["data"] + 2), slice(
    16 * c["model"], 16 * c["model"] + 16)
rec = {"rank": rank}
for k in (1, 2):
    got = spectral.spectral_mixer(torch.from_numpy(x[b, s]).contiguous(),
                                  seq_axis_name="model", mesh=mesh,
                                  batch_spec="data", overlap_k=k)
    want = ref[b, s]
    rec[f"k{k}"] = dict(shape=list(got.shape), err=float(
        (got - want).abs().max() / ref.abs().max()))

# the learned filter placed on the mesh against the meshless layer
from repro_torch.core import Croft3D, Decomposition
shape = (8, 8, 8)
plan = Croft3D(shape, mesh, Decomposition("pencil", ("data", "model")))
local = Croft3D(shape, device="cpu")
params = spectral.init_spectral_filter_params(
    torch.Generator().manual_seed(3), plan, scale=0.5)
xf = torch.complex(torch.from_numpy(rng.randn(*shape).astype(np.float32)),
                   torch.from_numpy(rng.randn(*shape).astype(np.float32)))
placed = spectral.place_spectral_filter_params(plan, params)
got = spectral.spectral_filter_apply(plan, placed,
                                     xf[plan.input_sharding].contiguous())
want = spectral.spectral_filter_apply(local, params, xf)
rec["filter"] = dict(
    gate=list(placed["gate"].shape) == list(plan.local_input_shape()),
    err=float((got - want[plan.output_sharding]).abs().max()
              / want.abs().max()))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def seq_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn(WORKER, 4, [out], out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("k", [1, 2])
def test_distributed_seq_fft_matches_local_mixer(seq_ranks, k):
    for r in seq_ranks:
        got = r[f"k{k}"]
        assert got["shape"] == [2, 16, 64], got
        assert got["err"] < TOL, (r["rank"], got)


def test_spectral_filter_placed_on_a_mesh(seq_ranks):
    for r in seq_ranks:
        assert r["filter"]["gate"], r["rank"]
        assert r["filter"]["err"] < FILT_TOL, (r["rank"], r["filter"])


# --- the fnet-350m model -----------------------------------------------------

def _pair(dtype="float32", seed=0):
    ref_cfg = dataclasses.replace(ref_get_config(ARCH, smoke=True),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    ref_params = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                              device="cpu")
    return ref_cfg, ref_params, cfg, model


def _tokens(b, s, vocab, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("b,s", [(2, 32), (1, 64)])
def test_fnet_logits_match_reference(b, s):
    ref_cfg, ref_params, cfg, model = _pair()
    tokens = _tokens(b, s, cfg.vocab)
    want, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                          mode="train")
    got, none = forward(model, cfg, torch.from_numpy(tokens), mode="train")
    assert none is None and got.shape == (b, s, cfg.vocab)
    _close(got, want, TOL)


def test_fnet_bf16_logits_match_reference():
    ref_cfg, ref_params, cfg, model = _pair("bfloat16")
    tokens = _tokens(2, 32, cfg.vocab)
    want, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                          mode="train")
    got, _ = forward(model, cfg, torch.from_numpy(tokens), mode="train")
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL)


def test_fnet_layers_carry_no_mixer_parameters():
    _, ref_params, cfg, model = _pair()
    layer = model.stages[0][0]
    assert layer.mixer is None
    assert set(ref_params["stages"][0]["p0"]) == {"ln1", "ln2", "ffn"}
    n_ref = sum(v.size for v in jax.tree.leaves(ref_params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_fnet_prefill_keeps_no_cache_state():
    """Encoder-only: a spectral layer's cache is empty, as in the
    reference, and a prefill pass gives the train pass's logits."""
    _, _, cfg, model = _pair()
    caches = init_caches(cfg, 2, 32, dtype=torch.float32, device="cpu")
    assert all(c == {} for stage in caches for c in stage)
    tokens = torch.from_numpy(_tokens(2, 32, cfg.vocab))
    train, _ = forward(model, cfg, tokens, mode="train")
    pre, _ = forward(model, cfg, tokens, mode="prefill", caches=caches)
    assert torch.equal(train, pre)


def test_fnet_sharded_forward_still_raises():
    """A shard that is not a ``ShardCtx`` is refused (the sharded FNet
    forward itself runs in ``tests/test_torch_sharded_train.py``)."""
    _, _, cfg, model = _pair()
    with pytest.raises(TypeError, match="ShardCtx"):
        forward(model, cfg, torch.zeros((1, 8), dtype=torch.int32),
                shard=object())


# --- the learned spectral filter ---------------------------------------------

@pytest.mark.parametrize("problem", ["c2c", "r2c"])
def test_spectral_filter_apply_matches_reference(problem):
    shape = (8, 8, 8)
    rng = np.random.RandomState(2)
    ref_plan = RefCroft3D(shape, problem=problem)
    plan = Croft3D(shape, problem=problem, device="cpu")
    assert spectral.spectral_filter_shapes(plan) == \
        ref_spectral.spectral_filter_shapes(ref_plan)
    gshape, fshape = spectral.spectral_filter_shapes(plan)
    params = {"gate": rng.randn(*gshape).astype(np.float32),
              "filter": rng.randn(*fshape).astype(np.float32)}
    x = rng.randn(*shape).astype(np.float32)
    if problem == "c2c":
        x = (x + 1j * rng.randn(*shape)).astype(np.complex64)
    want = ref_spectral.spectral_filter_apply(
        ref_plan, ref_spectral.place_spectral_filter_params(
            ref_plan, {k: jnp.asarray(v) for k, v in params.items()}),
        jnp.asarray(x))
    placed = spectral.place_spectral_filter_params(
        plan, {k: torch.from_numpy(v) for k, v in params.items()})
    got = spectral.spectral_filter_apply(plan, placed, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FILT_TOL * np.abs(want).max())


def test_init_spectral_filter_params_identity_and_seeded():
    plan = Croft3D((8, 8, 8), problem="r2c", device="cpu")
    ident = spectral.init_spectral_filter_params(None, plan)
    assert ident["gate"].shape == (8, 8, 8)
    assert ident["filter"].shape == (8, 8, 5)
    assert all(bool((v == 1).all()) for v in ident.values())
    a, b = (spectral.init_spectral_filter_params(
        torch.Generator().manual_seed(7), plan, scale=0.1) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not bool((a["gate"] == 1).all())
    x = torch.randn((8, 8, 8), generator=torch.Generator().manual_seed(8))
    np.testing.assert_allclose(
        spectral.spectral_filter_apply(plan, ident, x).numpy(),
        plan.forward(x).numpy(), rtol=0, atol=1e-6)


# --- configs, the serve CLI and the example ----------------------------------

def test_fnet_config_matches_reference():
    assert set(ARCHS) == set(REF_ARCHS)
    for smoke in (False, True):
        got, want = get_config(ARCH, smoke=smoke), ref_get_config(
            ARCH, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = get_config(ARCH)
    assert (full.d_model, full.d_ff, full.vocab, full.n_layers) == (
        1024, 4096, 32768, 24)
    assert full.stages[0].pattern[0].mixer == "spectral"


def test_shape_table_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert SHAPES["prefill_32k"].seq_len == 32768
    assert SHAPES["prefill_32k"].lowers_serve_step


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
def test_shape_supported_matches_reference(shape):
    for arch in ("fnet-350m", "h2o-danube-3-4b"):
        got = shape_supported(get_config(arch), SHAPES[shape])
        assert got == ref_shape_supported(ref_get_config(arch),
                                          REF_SHAPES[shape]), (arch, shape)
    # fnet is encoder-only: no decode shapes at all
    ok, _ = shape_supported(get_config(ARCH), SHAPES["decode_32k"])
    assert not ok


def test_serve_cli_refuses_the_encoder_only_model():
    from repro_torch.launch import serve
    args = argparse.Namespace(arch=ARCH, smoke=True, device="cpu", seed=0,
                              batch=1, prompt_len=8, gen_len=2, kv_block=8,
                              temperature=0.0)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.lm_main(args)


def test_serve_lm_example_on_cpu():
    root = os.path.dirname(torch_ranks.TESTS)
    sys.path.insert(0, os.path.join(root, "examples"))
    try:
        import serve_lm_torch
    finally:
        sys.path.pop(0)
    got = serve_lm_torch.serve_users(users=3, layers=2, seq=32, dmodel=16,
                                     device="cpu")
    assert got["worst"] < 1e-2 * max(got["scale"], 1.0), got
    assert got["stats"]["requests"] == 6
