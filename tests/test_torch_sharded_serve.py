"""The port's sharded serving on 4 gloo ranks, on the CPU.

A (data 2, model 2) mesh from ``make_local_mesh``: every rank holds the
whole model, its batch block and its slots of the caches
(``init_caches(mesh=)``, by ``cache_specs``).  For every arch that
decodes, at smoke size in float32 (MoE at a capacity factor where no
pair drops), a 32-token prefill and 4 greedy-fed decode steps through
``make_serve_steps(mesh=)`` against the port's meshless steps, each
rank's logits within ``2e-4·max|ref|`` (``tests/test_models_smoke.py:
111-113``) of its rows of the meshless ones.  The cases cover the GQA
ring cache (h2o, mixtral: window 32, the decode wraps), the MLA latent
cache (deepseek), both recurrent caches (recurrentgemma, rwkv6), the
cross cache (whisper) and the prefix-LM (paligemma).  After the steps
each rank's slot block equals its slots of the meshless cache.

The flash-decoding contract (``tests/test_parallel.py:141-174``): a
decode step gathers no cache.  Under ``Mesh.counting()`` it issues one
all-reduce per attention over a slot-sharded cache, each carrying the
ranks' float32 partial softmaxes (max, sum, acc) and nothing else: its
bytes scale with the query heads, never with the slots.  With a cache
of 1024 slots (yi-9b, 512 a rank) a whole step's counted bytes stay
under one slot block.  At the smoke windows the blocks are too short for
that (recurrentgemma's 16-slot ring holds 8 slots of one kv head a rank,
less than one combine of its 4 query heads); the chip phase holds it at
2048-slot blocks.
"""

import json
import os

import pytest

import torch_ranks

TF_TOL = 2e-4       # tests/test_models_smoke.py:111-113
ARCHS = ["deepseek-v2-236b", "gemma3-4b", "h2o-danube-3-4b", "mixtral-8x22b",
         "paligemma-3b", "recurrentgemma-9b", "rwkv6-3b", "whisper-base",
         "yi-34b", "yi-9b"]
LONG = "yi-9b:1024"     # a long cache: 512 slots a rank

WORKER = r"""
import json, os, sys
import numpy as np, torch
from torch_ranks import join, leave
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_caches, init_params
from repro_torch.models.model import batch_rows
from repro_torch.train import make_serve_steps
from repro_torch.train.data import synth_tokens
from repro_torch.train.train_step import make_shard_ctx
from torch_shard_cases import config, rel_err, stub_inputs

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
archs = sys.argv[4].split(",")
torch.set_num_threads(1)
join(rank, port, 4)
mesh = make_local_mesh(model=2, device="cpu")
B, S, GEN = 4, 32, 4
rec = {"rank": rank}


def leaves(caches):
    for si, stage in enumerate(caches):
        for li, layer in enumerate(stage):
            for part, c in layer.items():
                for name, t in c.items():
                    yield (si, li, part, name), t


for case in archs:
    arch, _, cache_len = case.partition(":")
    cfg = config(arch)
    prefix = cfg.n_frontend_tokens if cfg.prefix_lm else 0
    max_len = int(cache_len) if cache_len else prefix + S + GEN
    enc_len = cfg.n_frontend_tokens if cfg.encoder is not None else 0
    tokens = synth_tokens(3, 0, B, S + GEN, cfg.vocab)
    stub = stub_inputs(cfg, B)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pre0, dec0 = make_serve_steps(cfg, B, max_len, kv_block=16, device="cpu")
    pre1, dec1 = make_serve_steps(cfg, B, max_len, kv_block=16, mesh=mesh)
    c0 = init_caches(cfg, B, max_len, enc_len, torch.float32, device="cpu")
    c1 = init_caches(cfg, B, max_len, enc_len, torch.float32, device="cpu",
                     mesh=mesh)
    rows = batch_rows(make_shard_ctx(mesh, B), B)
    want, _ = pre0(model, tokens[:, :S], c0, **stub)
    got, _ = pre1(model, tokens[:, :S], c1, **stub)
    errs = [rel_err(got, want[rows])]
    steps = []
    for i in range(GEN):
        t = prefix + S + i
        tok = tokens[:, S + i:S + i + 1]
        want, _ = dec0(model, tok, c0, t)
        with mesh.counting() as cnt:
            got, _ = dec1(model, tok[rows], c1, t)
        errs.append(rel_err(got, want[rows]))
        steps.append(cnt.collectives)
    # the rank's slots of every slot-sharded cache, and its state rows
    me = mesh.coords["model"]
    full = dict(leaves(c0))
    cache_err, slot_bytes, sharded = 0.0, [], 0
    for key, t in leaves(c1):
        w = full[key]
        if key[-1] == "pos":
            cache_err = max(cache_err, float((t != w).any()))
            continue
        w = w[rows]
        if key[-1] in ("k", "v", "latent") and t.shape[1] < w.shape[1]:
            n = t.shape[1]
            w = w[:, me * n:(me + 1) * n]
            sharded += 1
            slot_bytes.append(t.numel() * t.element_size())
        cache_err = max(cache_err, rel_err(t, w) if w.abs().max() else
                        float((t - w).abs().max()))
    # what one attention's combine carries: (max, sum, acc) of B_loc rows
    combine = []
    for si, stage in enumerate(cfg.stages):
        for li in range(stage.repeat * len(stage.pattern)):
            sp = stage.pattern[li % len(stage.pattern)]
            layer = c1[si][li]
            for part in ("self", "cross"):
                c = layer.get(part)
                if c is None:
                    continue
                buf = c.get("latent", c.get("k"))
                if buf.shape[1] == c["pos"].shape[0]:
                    continue
                a = sp.attn
                heads = a.n_heads
                if a.kind == "mla":
                    width = a.kv_lora_rank
                else:
                    width = a.head_dim
                combine.append(2 * buf.shape[0] * heads * (width + 2) * 4)
    rec[case] = dict(errs=errs, steps=steps, cache_err=cache_err,
                     slot_bytes=slot_bytes, sharded=sharded, combine=combine)
# the production meshes need 256 / 512 ranks: this world has 4
from repro_torch.launch.mesh import fft_mesh_axes, make_production_mesh
refused = []
for multi_pod in (False, True):
    try:
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    except ValueError as e:
        refused.append(str(e))
rec["production"] = dict(refused=refused, fft_axes=list(fft_mesh_axes(mesh)))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
leave(mesh)
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_serve")
    torch_ranks.spawn(WORKER, 4, [out, ",".join(ARCHS + [LONG])], out,
                      timeout=600)
    return [json.load(open(os.path.join(str(out), f"rank{r}.json")))
            for r in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_meshless(served, arch):
    for r in served:
        got = r[arch]
        assert len(got["errs"]) == 5
        assert max(got["errs"]) < TF_TOL, got["errs"]
        assert got["cache_err"] < TF_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_gathers_no_cache(served, arch):
    for r in served:
        got = r[arch]
        if arch == "rwkv6-3b":        # no attention cache: nothing to move
            assert got["sharded"] == 0
            assert all(step == {} for step in got["steps"])
            continue
        assert got["sharded"] > 0
        for step in got["steps"]:
            assert set(step) == {"all-reduce"}
            assert step["all-reduce"]["count"] == len(got["combine"])
            # the partial softmaxes and nothing else
            assert step["all-reduce"]["bytes"] == sum(got["combine"])


def test_sharded_decode_step_moves_less_than_a_slot_block(served):
    for r in served:
        got = r[LONG]
        assert max(got["errs"]) < TF_TOL
        assert min(got["slot_bytes"]) >= 512 * 2 * 4
        for step in got["steps"]:
            assert step["all-reduce"]["bytes"] == sum(got["combine"])
            assert step["all-reduce"]["bytes"] < min(got["slot_bytes"])


def test_production_meshes_need_their_worlds(served):
    for r in served:
        got = r["production"]
        assert len(got["refused"]) == 2
        assert "256 ranks" in got["refused"][0]
        assert "512 ranks" in got["refused"][1]
        assert got["fft_axes"] == ["data", "model"]
