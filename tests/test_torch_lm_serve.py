"""The port's LM serving path against the JAX package, on the CPU.

h2o-danube-3-4b at its smoke size (2 layers, d 64, window 32): the JAX
``init_params`` tree is carried across with ``params_from_numpy``, the
same tokens go through JAX ``forward`` and the port's, and the logits of
the train, prefill and decode modes are held within ``2e-4·max|ref|``
(``tests/test_models_smoke.py:111-113``) in float32.  A bf16 run is held
within ``5e-2·max|ref|``: both frameworks accumulate bf16 products in
float32 but round and order them differently.  The prefill and train
passes reach the flash-attention kernel's plain version here; the
kernel itself is held against it on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import argparse
import dataclasses

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
from repro.train.train_step import cast_to_compute as ref_cast_to_compute
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.convert import named_from_numpy
from repro_torch.models.model import stacked_names
from repro_torch.models import (Model, forward, init_caches, init_params,
                                params_from_numpy)
from repro_torch.train import (cast_to_compute, greedy_sample,
                               make_serve_steps, temperature_sample)
from repro_torch.train.data import synth_tokens
from repro_torch.launch import serve

ARCH = "h2o-danube-3-4b"
TF_TOL = 2e-4       # tests/test_models_smoke.py:111-113
BF16_TOL = 5e-2     # bf16 rounding differs between the two frameworks


def _pair(dtype="float32", seed=0):
    """The JAX config and params, and the port's config and model."""
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


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("b,s", [(2, 24), (1, 48)])
def test_train_prefill_decode_match_reference(b, s):
    """b=2, s=24 is the reference's teacher-forcing case; b=1, s=48 its
    long decode past the 32-token window (ring cache,
    tests/test_models_smoke.py:116-132)."""
    ref_cfg, ref_params, cfg, model = _pair()
    tokens = _tokens(b, s + 1, cfg.vocab)
    ref, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                         mode="train", kv_block=16)
    got, none = forward(model, cfg, torch.from_numpy(tokens), mode="train",
                        kv_block=16)
    assert none is None
    _close(got, ref, TF_TOL)

    ref_caches = ref_init_caches(ref_cfg, b, max_len=64, dtype=jnp.float32)
    ref_pre, ref_caches = ref_forward(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, :s]),
                                      mode="prefill", caches=ref_caches,
                                      kv_block=16)
    caches = init_caches(cfg, b, max_len=64, dtype=torch.float32,
                         device="cpu")
    pre, caches = forward(model, cfg, torch.from_numpy(tokens[:, :s]),
                          mode="prefill", caches=caches, kv_block=16)
    _close(pre, ref_pre, TF_TOL)
    # the caches agree layer by layer (the reference stacks them per stage)
    for li in range(cfg.n_layers):
        ref_c = jax.tree.map(lambda a: np.asarray(a)[li],
                             ref_caches[0]["p0"]["self"])
        c = caches[0][li]["self"]
        np.testing.assert_array_equal(c["pos"].numpy(), ref_c["pos"])
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name].numpy(), ref_c[name],
                                       atol=1e-5)

    ref_dec, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens[:, s:]),
                             mode="decode", caches=ref_caches, start=s,
                             kv_block=16)
    dec, _ = forward(model, cfg, torch.from_numpy(tokens[:, s:]),
                     mode="decode", caches=caches, start=s, kv_block=16)
    _close(dec, ref_dec, TF_TOL)
    # teacher forcing inside the port: decode at s == train at s
    _close(dec[:, 0], got[:, s].numpy(), TF_TOL)


def test_bf16_serving_matches_reference():
    ref_cfg, ref_params, cfg, model = _pair("bfloat16")
    cast_to_compute(model, cfg.dtype)
    b, s = 2, 40
    tokens = _tokens(b, s + 1, cfg.vocab, seed=2)
    ref_prefill, ref_decode = ref_make_serve_steps(ref_cfg, None, b, 64,
                                                   kv_block=16)
    prefill, decode = make_serve_steps(ref_cfg, b, 64, kv_block=16,
                                       device="cpu")
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


def test_cast_to_compute_keeps_norms_float32():
    """The final norm (unstacked in the reference) stays float32; a
    layer's norm scales are cast, as the reference's stacked leaves are,
    and every 2-D parameter is cast."""
    _, _, cfg, model = _pair()
    cast_to_compute(model, "bfloat16")
    stacked = stacked_names(model)
    for name, p in model.named_parameters():
        want = torch.float32 if p.ndim + (name in stacked) < 2 \
            else torch.bfloat16
        assert p.dtype == want, name
    assert model.final_norm.scale.dtype == torch.float32
    assert model.stages[0][0].ln1.scale.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cast_to_compute_casts_as_the_reference(arch):
    """Serving's cast gives each leaf the dtype the reference's
    ``cast_to_compute`` gives it on the carried weights, for every arch:
    a layer's norm scales, biases, ``mu``, RG-LRU ``lam``/``b_rg``/
    ``b_ig`` and RWKV ``decay_base`` are 2-D on its repeat axis there."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
    cast = ref_cast_to_compute(ref_params, "bfloat16")
    want = {k: str(v.dtype) for k, v in named_from_numpy(
        jax.tree.map(np.asarray, cast), cfg).items()}
    model = cast_to_compute(params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu"), "bfloat16")
    got = {k: str(p.dtype).removeprefix("torch.")
           for k, p in model.named_parameters()}
    assert got == want
    # the cast values are the reference's, bit for bit
    for name, arr in named_from_numpy(jax.tree.map(np.asarray, cast),
                                      cfg).items():
        p = model.get_parameter(name)
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(arr, np.float32), name)


def test_recurrentgemma_bf16_serving_matches_reference():
    """recurrentgemma-9b's bf16 prefill and decode logits against the
    reference's bf16 serving steps, from carried weights.  RG-LRU's
    ``lam`` (uniform in [2, 6]) is the leaf init leaves inexact in bf16:
    serving now rounds it as the reference does."""
    arch = "recurrentgemma-9b"
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
    model = cast_to_compute(params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu"), cfg.dtype)
    lam = model.stages[0][0].mixer.lam
    assert lam.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lam.float().numpy(), np.asarray(ref_params["stages"][0]["p0"][
            "mixer"]["lam"][0].astype(jnp.bfloat16), np.float32))
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
    _close(last, ref_last, BF16_TOL)
    ref_dec, _ = ref_decode(ref_params, jnp.asarray(tokens[:, s:]),
                            ref_caches, s)
    dec, _ = decode(model, tokens[:, s:], caches, s)
    _close(dec, ref_dec, BF16_TOL)


def test_lm_main_matches_reference_greedy_loop(monkeypatch):
    """``lm_main`` end to end on the CPU gives the tokens of a JAX
    prefill + greedy decode loop, in float32, from the same weights: the
    config and the weights ``lm_main`` loads are swapped for the float32
    smoke config and the JAX weights carried across."""
    b, prompt_len, gen_len, seed = 2, 36, 6, 3
    ref_cfg, ref_params, cfg, model = _pair("float32", seed=seed)
    monkeypatch.setattr("repro_torch.configs.get_config",
                        lambda arch, smoke=False: cfg)
    monkeypatch.setattr("repro_torch.models.init_params",
                        lambda cfg, generator=None, device=None: model)
    args = argparse.Namespace(arch=ARCH, smoke=True, batch=b,
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


def test_serve_cli_and_its_refusals(capsys):
    gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert "prefill:" in capsys.readouterr().out
    # without --arch the transform service runs (on the CPU when asked;
    # without --device it wants the card)
    stats = serve.main(["--device", "cpu", "--shape", "8,8,8",
                        "--requests", "6"])
    assert stats["requests"] == 6 and stats["pending"] == 0
    assert "served 6 requests" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main([])
    # the encoder-decoder serves too; an encoder-only model
    # still has no decode step
    gen = serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert gen.shape == (2, 4)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "fnet-350m", "--smoke", "--device", "cpu"])


def test_synth_tokens_are_the_reference_tokens():
    for args in ((0, 0, 2, 33, 256), (7, 3, 3, 100, 32000)):
        np.testing.assert_array_equal(synth_tokens(*args),
                                      ref_synth_tokens(*args))


def test_sampling():
    logits = torch.tensor([[0.0, 3.0, 1.0], [5.0, -1.0, 0.0]])
    assert greedy_sample(logits).tolist() == [1, 0]
    assert temperature_sample(None, logits, 0.0).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([temperature_sample(gen, logits, 1.0)
                         for _ in range(2000)])
    assert draws.dtype == torch.int32
    # row 1: p(0) = e^5 / (e^5 + e^-1 + 1) = 0.991
    assert 0.97 < (draws[:, 1] == 0).float().mean().item() <= 1.0
    # row 0: the softmax of (0, 3, 1) puts 0.844 on token 1
    assert 0.8 < (draws[:, 0] == 1).float().mean().item() < 0.89


def test_serve_steps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no CUDA card")
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_steps(cfg, 1, 8)


@pytest.mark.parametrize("build", ["init_params", "Model", "init_caches",
                                   "params_from_numpy"])
def test_model_constructors_default_to_the_card(monkeypatch, build):
    """With no device the constructors build on the current CUDA card, and
    where there is none they raise naming ``device='cpu'``; with
    ``device="cpu"`` they build on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    calls = {
        "init_params": lambda **kw: init_params(cfg, **kw),
        "Model": lambda **kw: Model(cfg, **kw),
        "init_caches": lambda **kw: init_caches(cfg, 1, 8, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(
            jax.tree.map(np.asarray, ref_init_params(
                jax.random.PRNGKey(0), ref_get_config(ARCH, smoke=True))),
            cfg, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[build]()
    built = calls[build](device="cpu")
    if isinstance(built, Model):
        tensors = list(built.parameters())
    else:
        tensors = [t for layers in built for cache in layers
                   for t in cache["self"].values()]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_serve_steps_check_their_inputs():
    cfg = get_config(ARCH, smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prefill, decode = make_serve_steps(cfg, 2, 8, device="cpu")
    caches = init_caches(cfg, 2, 8, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        prefill(model, np.zeros((2, 9), np.int32), caches)
    with pytest.raises(ValueError, match=r"expected \(2, S\)"):
        decode(model, np.zeros((3, 1), np.int32), caches, 0)
    tokens = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs caches"):
        forward(model, cfg, tokens, mode="prefill")
    with pytest.raises(TypeError, match="ShardCtx"):
        forward(model, cfg, tokens, shard=object())
    # prefix embeddings are accepted; the logits cover the tokens only
    logits, _ = forward(model, cfg, tokens,
                        prefix_embeds=torch.zeros(2, 3, 64))
    assert logits.shape == (2, 4, cfg.vocab)
    with pytest.raises(ValueError, match="exceeds max_len"):
        prefill(model, np.zeros((2, 6), np.int32), caches,
                prefix_embeds=np.zeros((2, 3, 64), np.float32))


def test_params_from_numpy_checks_the_tree():
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray,
                        ref_init_params(jax.random.PRNGKey(0), ref_cfg))
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.stages[0][1].mixer.wq.shape == (64, 4, 16)
    np.testing.assert_array_equal(model.stages[0][1].ffn.w_up.numpy(),
                                  tree["stages"][0]["p0"]["ffn"]["w_up"][1])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    bad = jax.tree.map(lambda a: a, tree)
    del bad["stages"][0]["p0"]["ffn"]["w_gate"]
    with pytest.raises(ValueError, match="w_gate"):
        params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["tok"] = bad["embed"]["tok"][:, :32]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, cfg, device="cpu")


def test_full_config_param_count_without_allocating():
    """The full 24-layer model: the port's analytic count equals the
    reference's, and the modules built on the meta device (no memory)
    hold that many parameters plus the final norm's d_model, which the
    analytic count leaves out."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.n_layers == 24 and cfg.stages[0].pattern[0].attn.head_dim == 120
    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model
    assert abs(cfg.param_count() - 3.96e9) / 3.96e9 < 0.01
    smoke = Model(get_config(ARCH, smoke=True), device="meta")
    assert sum(p.numel() for p in smoke.parameters()) == \
        ref_get_config(ARCH, smoke=True).param_count() + 64
