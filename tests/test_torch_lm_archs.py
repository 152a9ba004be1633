"""The five archs this slice serves against the JAX package, on the CPU:
gemma3-4b, yi-9b and yi-34b (dense GQA; gemma3's five local layers to one
global, with a tail stage), recurrentgemma-9b (two RG-LRU layers to one
local-attention layer, with a tail stage) and rwkv6-3b (RWKV-6 time mix
and channel mix).

At their smoke sizes the JAX ``init_params`` tree is carried across with
``params_from_numpy`` (recurrent layers under ``stages[si]["p{pi}"]``,
tail stages, the RWKV channel mix: ``convert`` needed no change), the
same tokens go through JAX ``forward`` and the port's, and the logits of
the train, prefill and decode modes are held within ``2e-4·max|ref|``
(``tests/test_models_smoke.py:111-113``) in float32, the caches layer by
layer, and bf16 serving within ``5e-2·max|ref|``.  ``lm_main`` gives the
reference loop's greedy ids for the two recurrent models.  Each config
equals the reference's at both sizes, and the full models build on the
meta device with the reference tree's parameter count.
"""

import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import forward as ref_forward
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.train import make_serve_steps as ref_make_serve_steps
from repro.train.data import synth_tokens as ref_synth_tokens
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (Model, forward, init_caches,
                                params_from_numpy)
from repro_torch.models import recurrent as rec
from repro_torch.train import cast_to_compute, make_serve_steps

TF_TOL = 2e-4       # tests/test_models_smoke.py:111-113
BF16_TOL = 5e-2     # bf16 rounding differs between the two frameworks
ARCHS = ["gemma3-4b", "yi-9b", "yi-34b", "recurrentgemma-9b", "rwkv6-3b"]
RECURRENT = ["recurrentgemma-9b", "rwkv6-3b"]


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(arch, dtype="float32", seed=0):
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    ref_params = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = params_from_numpy(_tree(ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, model


def _tokens(b, s, vocab, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _check_caches(cfg, caches, ref_caches):
    """Every layer's cache against the reference's stacked one: the same
    keys, equal positions, states and k/v within 1e-5 of max|ref|."""
    for si, stage in enumerate(cfg.stages):
        n = len(stage.pattern)
        for li, c in enumerate(caches[si]):
            t, pi = divmod(li, n)
            ref_c = jax.tree.map(lambda a: np.asarray(a)[t],
                                 ref_caches[si][f"p{pi}"])
            assert set(c) == set(ref_c), (si, li)
            for part, tensors in c.items():
                assert set(tensors) == set(ref_c[part]), (si, li, part)
                for name, got in tensors.items():
                    want = ref_c[part][name]
                    if name == "pos":
                        np.testing.assert_array_equal(got.numpy(), want)
                    else:
                        assert got.dtype == torch.float32
                        _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_prefill_decode_match_reference(arch):
    """The reference's teacher-forcing case (B 2, S 24, past the smoke
    models' 16-token windows): the train, prefill and decode logits
    against JAX ``forward``'s, the caches layer by layer (the recurrent
    states written in place), and decode == train at S."""
    ref_cfg, ref_params, cfg, model = _pair(arch)
    b, s = 2, 24
    tokens = _tokens(b, s + 1, cfg.vocab)
    ref, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                         mode="train", kv_block=16)
    got, none = forward(model, cfg, _t(tokens), mode="train", kv_block=16)
    assert none is None
    _close(got, ref, TF_TOL)

    ref_caches = ref_init_caches(ref_cfg, b, max_len=64, dtype=jnp.float32)
    ref_pre, ref_caches = ref_forward(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, :s]),
                                      mode="prefill", caches=ref_caches,
                                      kv_block=16)
    caches = init_caches(cfg, b, max_len=64, dtype=torch.float32,
                         device="cpu")
    tensors = [t for layers in caches for c in layers
               for part in c.values() for t in part.values()]
    pre, out = forward(model, cfg, _t(tokens[:, :s]), mode="prefill",
                       caches=caches, kv_block=16)
    assert out is caches
    assert [t for layers in out for c in layers for part in c.values()
            for t in part.values()] == tensors   # the same tensors
    _close(pre, ref_pre, TF_TOL)
    _check_caches(cfg, caches, ref_caches)

    ref_dec, ref_caches = ref_forward(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, s:]),
                                      mode="decode", caches=ref_caches,
                                      start=s, kv_block=16)
    dec, _ = forward(model, cfg, _t(tokens[:, s:]), mode="decode",
                     caches=caches, start=s, kv_block=16)
    _close(dec, ref_dec, TF_TOL)
    _check_caches(cfg, caches, ref_caches)
    _close(dec[:, 0], got[:, s].numpy(), TF_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("scan_chunk", [None, 5])
def test_scan_chunk_override_matches_reference(arch, scan_chunk):
    """``forward``'s ``scan_chunk`` reaches the mixers as the reference's
    does (5 does not divide 30: the chunk falls to 5, then 3)."""
    ref_cfg, ref_params, cfg, model = _pair(arch, seed=2)
    tokens = _tokens(2, 30, cfg.vocab, seed=3)
    ref, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                         mode="train", kv_block=16, scan_chunk=scan_chunk)
    got, _ = forward(model, cfg, _t(tokens), mode="train", kv_block=16,
                     scan_chunk=scan_chunk)
    _close(got, ref, TF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_matches_reference(arch):
    ref_cfg, ref_params, cfg, model = _pair(arch, "bfloat16")
    cast_to_compute(model, cfg.dtype)
    b, s = 2, 40
    tokens = _tokens(b, s + 1, cfg.vocab, seed=2)
    ref_prefill, ref_decode = ref_make_serve_steps(ref_cfg, None, b, 64,
                                                   kv_block=16)
    prefill, decode = make_serve_steps(cfg, b, 64, kv_block=16, device="cpu")
    ref_caches = ref_init_caches(ref_cfg, b, 64, dtype=jnp.bfloat16)
    caches = init_caches(cfg, b, 64, dtype=torch.bfloat16, device="cpu")
    ref_last, ref_caches = ref_prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                       ref_caches)
    last, caches = prefill(model, tokens[:, :s], caches)
    assert last.dtype == torch.bfloat16 and last.shape == (b, cfg.vocab)
    _close(last, ref_last, BF16_TOL)
    ref_dec, _ = ref_decode(ref_params, jnp.asarray(tokens[:, s:]),
                            ref_caches, s)
    dec, _ = decode(model, tokens[:, s:], caches, s)
    _close(dec, ref_dec, BF16_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_lm_main_matches_reference_greedy_loop(monkeypatch, arch):
    """``lm_main --arch ... --smoke --device cpu`` end to end: the tokens
    of a JAX prefill + greedy decode loop from the same weights, float32
    (the reference's own example, ``src/repro/launch/serve.py:12``)."""
    b, prompt_len, gen_len, seed = 2, 20, 6, 3
    ref_cfg, ref_params, cfg, model = _pair(arch, seed=seed)
    monkeypatch.setattr("repro_torch.configs.get_config",
                        lambda arch, smoke=False: cfg)
    monkeypatch.setattr("repro_torch.models.init_params",
                        lambda cfg, generator=None, device=None: model)
    args = argparse.Namespace(arch=arch, smoke=True, batch=b,
                              prompt_len=prompt_len, gen_len=gen_len,
                              temperature=0.0, kv_block=16, seed=seed,
                              device="cpu")
    got = serve.lm_main(args)

    max_len = prompt_len + gen_len
    ref_prefill, ref_decode = ref_make_serve_steps(ref_cfg, None, b, max_len,
                                                   kv_block=16)
    caches = ref_init_caches(ref_cfg, b, max_len, dtype=jnp.float32)
    prompts = ref_synth_tokens(seed, 0, b, prompt_len, cfg.vocab)
    logits, caches = ref_prefill(ref_params, jnp.asarray(prompts), caches)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(gen_len - 1):
        logits, caches = ref_decode(ref_params, tok, caches, prompt_len + i)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(tok)
    np.testing.assert_array_equal(
        got, np.concatenate([np.asarray(t) for t in want], axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    out = capsys.readouterr().out
    assert f"model: {arch}-smoke (bfloat16)" in out and "decode :" in out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference(arch, smoke):
    cfg, ref_cfg = get_config(arch, smoke=smoke), ref_get_config(arch,
                                                                 smoke=smoke)
    assert repr(cfg) == repr(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    for stage, ref_stage in zip(cfg.stages, ref_cfg.stages):
        assert stage.repeat == ref_stage.repeat
        for spec, ref_spec in zip(stage.pattern, ref_stage.pattern):
            assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_model_builds_on_meta(arch):
    """The full model on the meta device (no memory) holds the
    reference tree's parameters, name for name (``jax.eval_shape`` of
    its ``init_params``, no memory either); the tail stages of gemma3
    (34 = 5 x 6 + 4) and recurrentgemma (38 = 3 x 12 + 2) included."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    ref = jax.eval_shape(lambda k: ref_init_params(k, ref_get_config(arch)),
                         jax.random.PRNGKey(0))
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(ref))
    assert sum(p.numel() for p in model.parameters()) == want
    tails = {"gemma3-4b": (5, 4), "recurrentgemma-9b": (12, 2)}
    if arch in tails:
        assert [s.repeat for s in cfg.stages] == [tails[arch][0], 1]
        assert len(model.stages[1]) == tails[arch][1]
    kinds = {type(layer.mixer).__name__ for stage in model.stages
             for layer in stage}
    assert kinds == {"gemma3-4b": {"GQA"}, "yi-9b": {"GQA"},
                     "yi-34b": {"GQA"},
                     "recurrentgemma-9b": {"GQA", "RGLRU"},
                     "rwkv6-3b": {"RWKV6"}}[arch]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_caches_are_the_reference_layout(arch):
    """``init_caches`` builds each recurrent layer's state with the
    reference's names, shapes and dtypes (the state float32, the shift
    inputs in the cache dtype)."""
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                                smoke=True)
    ref = ref_init_caches(ref_cfg, 2, 32, dtype=jnp.bfloat16)
    got = init_caches(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    for si, stage in enumerate(cfg.stages):
        n = len(stage.pattern)
        for li, c in enumerate(got[si]):
            ref_c = ref[si][f"p{li % n}"]
            assert set(c) == set(ref_c)
            for part in c:
                for name, t in c[part].items():
                    a = ref_c[part][name]
                    assert tuple(t.shape) == a.shape[1:], (part, name)
                    assert str(t.dtype).split(".")[-1] == str(a.dtype)
    mixer = rec.RWKV6 if arch == "rwkv6-3b" else rec.RGLRU
    assert any(isinstance(layer.mixer, mixer) for layer in
               Model(cfg, device="meta").stages[0])


def test_rwkv_bf16_teacher_forcing_drifts_with_depth_in_the_reference_too():
    """Why ``chip_smoke.py`` holds rwkv6-3b's bf16 teacher forcing at 2
    layers and only reads it at 32: the seeded RWKV-6 stack amplifies
    bf16 rounding with depth in the reference itself.  At width 128,
    S 128, the first decode step against the train pass is within
    5e-2·max|ref| at 2 layers in both packages, and past it at 16 layers
    in both (the reference: 0.13; the port: 0.22)."""
    from repro.models.config import Stage as RefStage
    from repro_torch.models import Stage

    def cut(cfg, stage_cls, layers):
        spec = cfg.stages[0].pattern[0]
        spec = dataclasses.replace(spec, recurrent=dataclasses.replace(
            spec.recurrent, n_heads=2, chunk=64))
        return dataclasses.replace(cfg, d_model=128, d_ff=448, vocab=4096,
                                   stages=(stage_cls((spec,), layers),),
                                   dtype="bfloat16")

    s = 128
    tokens = _tokens(2, s + 1, 4096)
    for layers, drifts in ((2, False), (16, True)):
        ref_cfg = cut(ref_get_config("rwkv6-3b", smoke=True), RefStage,
                      layers)
        cfg = cut(get_config("rwkv6-3b", smoke=True), Stage, layers)
        ref_p = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
        model = cast_to_compute(params_from_numpy(_tree(ref_p), cfg,
                                                  device="cpu"), cfg.dtype)
        ref_p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                             if a.ndim >= 2 else a, ref_p)
        train, _ = ref_forward(ref_p, ref_cfg, jnp.asarray(tokens),
                               mode="train", kv_block=512)
        caches = ref_init_caches(ref_cfg, 2, s + 1, dtype=jnp.bfloat16)
        _, caches = ref_forward(ref_p, ref_cfg, jnp.asarray(tokens[:, :s]),
                                mode="prefill", caches=caches, kv_block=512)
        dec, _ = ref_forward(ref_p, ref_cfg, jnp.asarray(tokens[:, s:]),
                             mode="decode", caches=caches, start=s,
                             kv_block=512)
        want = np.asarray(train[:, s], np.float32)
        ref_err = np.abs(np.asarray(dec[:, 0], np.float32) - want).max() \
            / np.abs(want).max()
        got, _ = forward(model, cfg, _t(tokens), mode="train", kv_block=512)
        caches = init_caches(cfg, 2, s + 1, dtype=torch.bfloat16,
                             device="cpu")
        forward(model, cfg, _t(tokens[:, :s]), mode="prefill",
                caches=caches, kv_block=512)
        step, _ = forward(model, cfg, _t(tokens[:, s:]), mode="decode",
                          caches=caches, start=s, kv_block=512)
        top = got[:, s].float().abs().max().item()
        err = (step[:, 0].float() - got[:, s].float()).abs().max().item() \
            / top
        assert (ref_err > BF16_TOL) == drifts, (layers, ref_err)
        assert (err > BF16_TOL) == drifts, (layers, err)
