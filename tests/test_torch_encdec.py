"""The encoder-decoder and the prefix-LM archs against the JAX package,
on the CPU: whisper-base (an encoder stack over stub frames, decoder
layers with cross-attention and its cache) and paligemma-3b (stub patch
embeddings ahead of the prompt, prefix-LM attention over them).

At their smoke sizes (whisper 2 + 2 layers, d 64, 32 frames; paligemma 2
layers, 8 patches) the JAX ``init_params`` tree is carried across with
``params_from_numpy``, frames and patches are drawn from a seed with
numpy, and the same inputs go through the reference and the port:
``encode`` and the train, prefill and decode logits within
``2e-4·max|ref|`` (``tests/test_models_smoke.py:111-113``) in float32,
every cache layer by layer (``cross`` included) within 1e-5, bf16
serving within ``5e-2·max|ref|``, ``lm_main``'s greedy ids equal to the
reference loop's.  The route: the encoder's and whisper's decoder
prefill's self-attention call ``flash_attention`` (its plain version on
the CPU); cross-attention and paligemma's prefix-LM passes never do.
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
from repro.models import encode as ref_encode
from repro.models import forward as ref_forward
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.train import make_serve_steps as ref_make_serve_steps
from repro.train.data import synth_tokens as ref_synth_tokens
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (Model, encode, forward, init_caches,
                                params_from_numpy)
from repro_torch.models import attention as attn_mod
from repro_torch.train import cast_to_compute, make_serve_steps

TF_TOL = 2e-4       # tests/test_models_smoke.py:111-113
BF16_TOL = 5e-2     # bf16 rounding differs between the two frameworks
WHISPER, PALI = "whisper-base", "paligemma-3b"
ARCHS = [WHISPER, PALI]


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


def _stub(cfg, b, seed=5):
    """Frames or patch embeddings (B, n_frontend_tokens, d_model)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model), np.float32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _check_caches(cfg, caches, ref_caches):
    """Every layer's cache against the reference's stacked one: the same
    parts and names, equal positions, k/v within 1e-5 of max|ref|."""
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


def _inputs(arch, cfg, ref_params, ref_cfg, model, b):
    """(reference forward kwargs, port forward kwargs, enc_len, prefix)."""
    stub = _stub(cfg, b)
    if arch == WHISPER:
        ref_enc = ref_encode(ref_params, ref_cfg, jnp.asarray(stub))
        enc = encode(model, cfg, _t(stub))
        _close(enc, ref_enc, TF_TOL)
        return ({"enc_out": ref_enc}, {"enc_out": enc},
                cfg.n_frontend_tokens, 0)
    return ({"prefix_embeds": jnp.asarray(stub)},
            {"prefix_embeds": _t(stub)}, 0, cfg.n_frontend_tokens)


def test_encode_matches_reference():
    """The encoder stack over seeded frames, float32 and bf16 (weights
    cast once), against the reference's ``encode``."""
    for dtype, tol in (("float32", TF_TOL), ("bfloat16", BF16_TOL)):
        ref_cfg, ref_params, cfg, model = _pair(WHISPER, dtype, seed=4)
        frames = _stub(cfg, 2, seed=6)
        if dtype == "bfloat16":
            cast_to_compute(model, dtype)
            ref_params = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                                      if a.ndim >= 2 else a, ref_params)
        ref = ref_encode(ref_params, ref_cfg, jnp.asarray(frames))
        got = encode(model, cfg, _t(frames))
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == (2, cfg.n_frontend_tokens, cfg.d_model)
        _close(got, ref, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_prefill_decode_match_reference(arch):
    """The reference's own case (B 2, S 24, decode at S + prefix): the
    train, prefill and decode logits against JAX ``forward``'s, every
    cache layer by layer (whisper's cross caches, paligemma's prefix
    positions), and decode == train at S."""
    ref_cfg, ref_params, cfg, model = _pair(arch)
    b, s = 2, 24
    tokens = _tokens(b, s + 1, cfg.vocab)
    ref_kw, kw, enc_len, prefix = _inputs(arch, cfg, ref_params, ref_cfg,
                                          model, b)
    ref, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                         mode="train", kv_block=16, **ref_kw)
    got, none = forward(model, cfg, _t(tokens), mode="train", kv_block=16,
                        **kw)
    assert none is None and got.shape == (b, s + 1, cfg.vocab)
    _close(got, ref, TF_TOL)

    ref_caches = ref_init_caches(ref_cfg, b, max_len=64, enc_len=enc_len,
                                 dtype=jnp.float32)
    ref_pre, ref_caches = ref_forward(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, :s]),
                                      mode="prefill", caches=ref_caches,
                                      kv_block=16, **ref_kw)
    caches = init_caches(cfg, b, max_len=64, enc_len=enc_len,
                         dtype=torch.float32, device="cpu")
    tensors = [t for layers in caches for c in layers
               for part in c.values() for t in part.values()]
    pre, out = forward(model, cfg, _t(tokens[:, :s]), mode="prefill",
                       caches=caches, kv_block=16, **kw)
    assert out is caches
    assert [t for layers in out for c in layers for part in c.values()
            for t in part.values()] == tensors   # the same tensors
    assert pre.shape == (b, s, cfg.vocab)       # the token positions only
    _close(pre, ref_pre, TF_TOL)
    _check_caches(cfg, caches, ref_caches)

    ref_dec, ref_caches = ref_forward(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, s:]),
                                      mode="decode", caches=ref_caches,
                                      start=s + prefix, kv_block=16)
    dec, _ = forward(model, cfg, _t(tokens[:, s:]), mode="decode",
                     caches=caches, start=s + prefix, kv_block=16)
    _close(dec, ref_dec, TF_TOL)
    _check_caches(cfg, caches, ref_caches)
    _close(dec[:, 0], got[:, s].numpy(), TF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_matches_reference(arch):
    """``make_serve_steps`` with ``frames=`` / ``prefix_embeds=`` against
    the reference's, bf16, the prefill's last logits and a decode step at
    prompt + prefix."""
    ref_cfg, ref_params, cfg, model = _pair(arch, "bfloat16")
    cast_to_compute(model, cfg.dtype)
    b, s = 2, 40
    tokens = _tokens(b, s + 1, cfg.vocab, seed=2)
    stub = _stub(cfg, b, seed=3)
    key = "frames" if arch == WHISPER else "prefix_embeds"
    prefix = cfg.n_frontend_tokens if cfg.prefix_lm else 0
    enc_len = cfg.n_frontend_tokens if cfg.encoder is not None else 0
    max_len = prefix + 64
    ref_prefill, ref_decode = ref_make_serve_steps(ref_cfg, None, b, max_len,
                                                   kv_block=16)
    prefill, decode = make_serve_steps(cfg, b, max_len, kv_block=16,
                                       device="cpu")
    ref_caches = ref_init_caches(ref_cfg, b, max_len, enc_len=enc_len,
                                 dtype=jnp.bfloat16)
    caches = init_caches(cfg, b, max_len, enc_len=enc_len,
                         dtype=torch.bfloat16, device="cpu")
    ref_last, ref_caches = ref_prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                       ref_caches,
                                       **{key: jnp.asarray(stub)})
    last, caches = prefill(model, tokens[:, :s], caches, **{key: stub})
    assert last.dtype == torch.bfloat16 and last.shape == (b, cfg.vocab)
    _close(last, ref_last, BF16_TOL)
    ref_dec, _ = ref_decode(ref_params, jnp.asarray(tokens[:, s:]),
                            ref_caches, s + prefix)
    dec, _ = decode(model, tokens[:, s:], caches, s + prefix)
    _close(dec, ref_dec, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_main_matches_reference_greedy_loop(monkeypatch, arch):
    """``lm_main --arch ... --smoke --device cpu`` end to end: the tokens
    of the reference's loop (its frames or patches from
    ``default_rng(seed)``, decode at prefix + prompt + i) from the same
    weights, float32."""
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

    prefix = cfg.n_frontend_tokens if cfg.prefix_lm else 0
    max_len = prefix + prompt_len + gen_len
    enc_len = cfg.n_frontend_tokens if cfg.encoder is not None else 0
    ref_prefill, ref_decode = ref_make_serve_steps(ref_cfg, None, b, max_len,
                                                   kv_block=16)
    caches = ref_init_caches(ref_cfg, b, max_len, enc_len=enc_len,
                             dtype=jnp.float32)
    prompts = ref_synth_tokens(seed, 0, b, prompt_len, cfg.vocab)
    stub = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model), np.float32))
    kw = {"frames": stub} if arch == WHISPER else {"prefix_embeds": stub}
    logits, caches = ref_prefill(ref_params, jnp.asarray(prompts), caches,
                                 **kw)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(gen_len - 1):
        logits, caches = ref_decode(ref_params, tok, caches,
                                    prefix + prompt_len + i)
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
    if cfg.encoder is not None:
        assert dataclasses.asdict(cfg.encoder) == dataclasses.asdict(
            ref_cfg.encoder)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_model_builds_on_meta(arch):
    """The full model on the meta device holds the reference tree's
    parameters (``jax.eval_shape`` of its ``init_params``), name for
    name: whisper's 6 encoder layers and final norm, its decoder layers'
    ``ln_cross`` and ``cross``; no positional table on either side
    (the config's ``param_count`` counts one for the encoder, so it is not
    the yardstick)."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    ref = jax.eval_shape(lambda k: ref_init_params(k, ref_get_config(arch)),
                         jax.random.PRNGKey(0))
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(ref))
    assert sum(p.numel() for p in model.parameters()) == want
    if arch == WHISPER:
        assert len(model.encoder.layers) == 6
        layer = model.stages[0][0]
        assert layer.cross.wq.shape == (512, 8, 64)
        assert not hasattr(model.encoder.layers[0], "cross")
        names = {n.split(".", 1)[1] for n, _ in model.encoder.named_parameters()
                 if n.startswith("final_norm")}
        assert names == {"scale", "bias"}
    else:
        assert not hasattr(model, "encoder")
        assert model.stages[0][0].mixer.wk.shape == (2048, 1, 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_are_the_reference_layout(arch):
    """``init_caches(enc_len=)`` builds the reference's parts, names,
    shapes and dtypes: whisper's ``cross`` k/v (B, enc_len, KV, hd) in
    the cache dtype and ``pos = arange(enc_len)``."""
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                                smoke=True)
    enc_len = cfg.n_frontend_tokens if cfg.encoder is not None else 0
    ref = ref_init_caches(ref_cfg, 2, 32, enc_len=enc_len,
                          dtype=jnp.bfloat16)
    got = init_caches(cfg, 2, 32, enc_len=enc_len, dtype=torch.bfloat16,
                      device="cpu")
    for si, stage in enumerate(cfg.stages):
        n = len(stage.pattern)
        for li, c in enumerate(got[si]):
            ref_c = ref[si][f"p{li % n}"]
            assert set(c) == set(ref_c)
            for part in c:
                for name, t in c[part].items():
                    a = np.asarray(ref_c[part][name])
                    assert tuple(t.shape) == a.shape[1:], (part, name)
                    assert str(t.dtype).split(".")[-1] == str(a.dtype)
                    if name == "pos":
                        np.testing.assert_array_equal(t.numpy(), a[0])
    assert ("cross" in got[0][0]) == (arch == WHISPER)


def _count_flash(monkeypatch):
    calls = []
    real = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda q, k, v, **kw: calls.append(
                            (q.shape[1], k.shape[1], kw["causal"]))
                        or real(q, k, v, **kw))
    return calls


def test_whisper_attention_route(monkeypatch):
    """The encoder's self-attention is a non-causal segment at 0 and the
    decoder prefill's a causal one: both call ``flash_attention`` (its
    plain version on the CPU), one call a layer.  Cross-attention and
    decode never do; the blockwise core takes them."""
    calls = _count_flash(monkeypatch)
    ref_cfg, ref_params, cfg, model = _pair(WHISPER)
    b, s, t = 2, 12, cfg.n_frontend_tokens
    frames = _stub(cfg, b)
    enc = encode(model, cfg, _t(frames))
    assert calls == [(t, t, False)] * cfg.encoder.n_layers
    calls.clear()
    caches = init_caches(cfg, b, 32, enc_len=t, dtype=torch.float32,
                         device="cpu")
    tokens = _t(_tokens(b, s + 1, cfg.vocab))
    forward(model, cfg, tokens[:, :s], mode="prefill", caches=caches,
            enc_out=enc, kv_block=16)
    assert calls == [(s, s, True)] * cfg.n_layers
    calls.clear()
    forward(model, cfg, tokens[:, s:], mode="decode", caches=caches,
            start=s, kv_block=16)
    assert not calls
    calls.clear()
    prefill, _ = make_serve_steps(cfg, b, 32, kv_block=16, device="cpu")
    prefill(model, tokens[:, :s], caches, frames=frames)
    assert calls == ([(t, t, False)] * cfg.encoder.n_layers
                     + [(s, s, True)] * cfg.n_layers)


def test_paligemma_prefix_lm_never_reaches_the_kernel(monkeypatch):
    """A prefix-LM pass carries a prefix span, so its self-attention takes
    the blockwise core in every mode (and paligemma's full head_dim 256
    would take it anyway)."""
    calls = _count_flash(monkeypatch)
    _, _, cfg, model = _pair(PALI)
    b, s, p = 2, 12, cfg.n_frontend_tokens
    tokens = _t(_tokens(b, s + 1, cfg.vocab))
    prefix = _t(_stub(cfg, b))
    logits, _ = forward(model, cfg, tokens, prefix_embeds=prefix,
                        kv_block=16)
    assert logits.shape == (b, s + 1, cfg.vocab)
    caches = init_caches(cfg, b, 32, dtype=torch.float32, device="cpu")
    forward(model, cfg, tokens[:, :s], mode="prefill", caches=caches,
            prefix_embeds=prefix, kv_block=16)
    forward(model, cfg, tokens[:, s:], mode="decode", caches=caches,
            start=p + s, kv_block=16)
    assert not calls
    # without the prefix the same model is a plain causal LM at 0
    forward(model, cfg, tokens, kv_block=16)
    assert len(calls) == cfg.n_layers


def test_encdec_inputs_are_checked():
    """What the port refuses: a cross cache without ``enc_len`` or of
    another length than the memory, cross-attention without ``enc_out``,
    a prefill without frames or past ``max_len`` with its prefix, stub
    embeddings of the wrong shape, and an encoder missing from the tree
    (or a tree's encoder for a config without one)."""
    ref_cfg, ref_params, cfg, model = _pair(WHISPER)
    b, t = 2, cfg.n_frontend_tokens
    with pytest.raises(ValueError, match="enc_len"):
        init_caches(cfg, b, 16, dtype=torch.float32, device="cpu")
    tokens = torch.zeros(b, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs enc_out"):
        forward(model, cfg, tokens)
    caches = init_caches(cfg, b, 16, enc_len=t - 1, dtype=torch.float32,
                         device="cpu")
    enc = encode(model, cfg, _t(_stub(cfg, b)))
    with pytest.raises(ValueError, match="enc_len"):
        forward(model, cfg, tokens, mode="prefill", caches=caches,
                enc_out=enc)
    prefill, _ = make_serve_steps(cfg, b, 16, device="cpu")
    caches = init_caches(cfg, b, 16, enc_len=t, dtype=torch.float32,
                         device="cpu")
    with pytest.raises(ValueError, match="needs frames"):
        prefill(model, tokens, caches)
    with pytest.raises(ValueError, match="frames: expected"):
        prefill(model, tokens, caches, frames=np.zeros((b, t, 8), np.float32))

    _, pali_params, pali_cfg, pali = _pair(PALI)
    p = pali_cfg.n_frontend_tokens
    prefill, _ = make_serve_steps(pali_cfg, b, p + 4, device="cpu")
    caches = init_caches(pali_cfg, b, p + 4, dtype=torch.float32,
                         device="cpu")
    with pytest.raises(ValueError, match="after 8 prefix positions exceeds"):
        prefill(pali, torch.zeros(b, 5, dtype=torch.int32), caches,
                prefix_embeds=_stub(pali_cfg, b))
    logits, _ = prefill(pali, tokens, caches,
                        prefix_embeds=_stub(pali_cfg, b))
    assert logits.shape == (b, pali_cfg.vocab)

    tree = _tree(ref_params)
    del tree["encoder"]
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy({**_tree(pali_params), "encoder": {}}, pali_cfg,
                          device="cpu")
    tree = _tree(ref_params)
    del tree["encoder"]["layers"]["ffn"]["w_up"]
    with pytest.raises(ValueError, match="w_up"):
        params_from_numpy(tree, cfg, device="cpu")
