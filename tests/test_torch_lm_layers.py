"""The port's LM layers against ``repro.models`` on the same inputs, on
the CPU: norms, RoPE, the dense FFNs, embeddings and logits, the
blockwise attention core and its masks, the GQA layer (through the
flash-attention kernel's plain version and through the blockwise core),
and the ring-cache write.  Tolerances are ``tests/test_layers.py``'s:
2e-5 for attention, rtol 1e-4 for the norms.  Inputs are made with
numpy; parameters come from the reference's ``init_*`` and are carried
across as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import kvcache as ref_kc
from repro.models import layers as ref_L
from repro.models.config import AttentionSpec as RefAttentionSpec
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import kvcache as kc
from repro_torch.models import layers as L
from repro_torch.models.attention import (MLA, MaskSpec,
                                          attention_fwd,
                                          blockwise_attention, gqa_fwd,
                                          gqa_project_kv, init_attention)
from repro_torch.models.config import AttentionSpec, LayerSpec
from repro_torch.models.convert import load_tree

ATTN_TOL = 2e-5   # tests/test_layers.py


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _tree(p):
    return jax.tree.map(np.asarray, p)


# --------------------------------------------------------------------------
# norms, rope, ffn, embeddings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x = _np(0, 2, 3, 16, scale=5.0) + 3.0
    ref_p = {"scale": _np(1, 16) + 1.0}
    p = L.init_norm(kind, 16)
    if kind == "layernorm":
        ref_p["bias"] = _np(2, 16)
    load_tree(p, ref_p, kind)
    want = np.asarray(ref_L.norm_fwd(ref_p, jnp.asarray(x), kind))
    got = L.norm_fwd(p, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    # bf16 in, bf16 out, float32 inside
    xb = torch.from_numpy(x).bfloat16()
    assert L.norm_fwd(p, xb, kind).dtype == torch.bfloat16


def test_rope_matches_reference():
    pos = np.arange(40, dtype=np.int32)
    x = _np(3, 2, 40, 3, 16)
    cos, sin = ref_L.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    want = np.asarray(ref_L.apply_rope(jnp.asarray(x), cos, sin))
    c, s = L.rope_angles(torch.from_numpy(pos), 16, 10_000.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sin), atol=1e-6)
    got = L.apply_rope(torch.from_numpy(x), c, s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_reference(kind):
    ref_p = ref_L.init_ffn(jax.random.PRNGKey(0), 16, 32, kind)
    if kind == "gelu":   # non-zero biases, so the test sees them
        ref_p = {**ref_p, "b_up": jnp.asarray(_np(4, 32)),
                 "b_down": jnp.asarray(_np(5, 16))}
    p = L.init_ffn(16, 32, kind)
    load_tree(p, _tree(ref_p), kind)
    x = _np(6, 2, 5, 16)
    want = np.asarray(ref_L.ffn_fwd(ref_p, jnp.asarray(x), kind))
    got = L.ffn_fwd(p, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_rwkv_channel_mix_waits_for_its_slice():
    """Its slice has come: the RWKV channel mix, from the reference's
    tree, against the reference's ``ffn_fwd`` (the token-shifted input
    from ``token_shift``)."""
    ref_p = ref_L.init_ffn(jax.random.PRNGKey(0), 16, 32, "rwkv_cm")
    p = L.init_ffn(16, 32, "rwkv_cm")
    load_tree(p, _tree(ref_p), "rwkv_cm")
    x = _np(6, 2, 5, 16)
    prev = _np(7, 2, 16)
    want = ref_L.ffn_fwd(ref_p, jnp.asarray(x), "rwkv_cm",
                         x_prev=ref_L.token_shift(jnp.asarray(x),
                                                  jnp.asarray(prev)))
    got = L.ffn_fwd(p, torch.from_numpy(x), "rwkv_cm",
                    x_prev=L.token_shift(torch.from_numpy(x),
                                         torch.from_numpy(prev)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("tie,softcap,scale_by_dim", [(False, 0.0, False),
                                                      (True, 30.0, True)])
def test_embedding_and_logits_match_reference(tie, softcap, scale_by_dim):
    ref_p = ref_L.init_embedding(jax.random.PRNGKey(1), 50, 16, tie)
    p = L.init_embedding(50, 16, tie)
    load_tree(p, _tree(ref_p), "embed")
    tokens = np.random.RandomState(7).randint(0, 50, (2, 9)).astype(np.int32)
    want = ref_L.embed_fwd(ref_p, jnp.asarray(tokens), jnp.float32,
                           scale_by_dim)
    got = L.embed_fwd(p, torch.from_numpy(tokens), torch.float32,
                      scale_by_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    want = ref_L.logits_fwd(ref_p, want * 4.0, softcap)
    got = L.logits_fwd(p, got * 4.0, softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# blockwise attention and its masks
# --------------------------------------------------------------------------

def _blockwise_pair(q, k, v, ms, q_pos, k_pos, kv_block):
    want = ref_attn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        ref_attn.MaskSpec(*ms), jnp.asarray(q_pos), jnp.asarray(k_pos),
        kv_block=kv_block)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), ms,
                              torch.from_numpy(q_pos),
                              torch.from_numpy(k_pos), kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)
    return got


@pytest.mark.parametrize("ms,kv_block", [
    (MaskSpec(causal=True), 4), (MaskSpec(causal=True), 8),
    (MaskSpec(causal=True), 32), (MaskSpec(causal=True, window=8), 8),
    (MaskSpec(causal=True, prefix_len=6), 8), (MaskSpec(causal=False), 12),
    (MaskSpec(causal=False, window=5), 7),
])
def test_blockwise_matches_reference(ms, kv_block):
    s = 32
    pos = np.arange(s, dtype=np.int32)
    _blockwise_pair(_np(8, 2, s, 4, 8), _np(9, 2, s, 2, 8), _np(10, 2, s, 2, 8),
                    ms, pos, pos, kv_block)


def test_blockwise_empty_slots_masked():
    """pos == -1 (empty ring-cache slots) contributes nothing."""
    q, k, v = _np(11, 1, 1, 2, 8), _np(12, 1, 4, 2, 8), _np(13, 1, 4, 2, 8)
    k_pos = np.asarray([0, 1, -1, -1], np.int32)
    got = _blockwise_pair(q, k, v, MaskSpec(causal=True),
                          np.asarray([5], np.int32), k_pos, 4)
    only = _blockwise_pair(q, k[:, :2], v[:, :2], MaskSpec(causal=True),
                           np.asarray([5], np.int32), k_pos[:2], 4)
    np.testing.assert_allclose(got.numpy(), only.numpy(), atol=ATTN_TOL)


# --------------------------------------------------------------------------
# the GQA layer: kernel path and blockwise path
# --------------------------------------------------------------------------

def _gqa_pair(window=16, head_dim=16):
    a = AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2,
                      head_dim=head_dim, window=window)
    ref_a = RefAttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2,
                             head_dim=head_dim, window=window)
    ref_p = ref_attn.init_gqa(jax.random.PRNGKey(2), 32, ref_a)
    p = init_attention(32, a)
    load_tree(p, _tree(ref_p), "gqa")
    return a, ref_a, ref_p, p


@pytest.mark.parametrize("start,prefix_len", [(0, 0), (5, 0), (0, 4)])
def test_gqa_self_attention_matches_reference(start, prefix_len):
    """start 0 without a prefix-LM span takes the flash-attention kernel
    (its plain version on the CPU); the others the blockwise core."""
    a, ref_a, ref_p, p = _gqa_pair()
    x = _np(14, 2, 40, 32)
    pos = start + np.arange(40, dtype=np.int32)
    ms = MaskSpec(causal=True, window=16, prefix_len=prefix_len)
    want, (rk, rv) = ref_attn.gqa_fwd(ref_p, jnp.asarray(x), ref_a,
                                      ref_attn.MaskSpec(*ms),
                                      jnp.asarray(pos), kv_block=16)
    got, (k, v) = attention_fwd(p, torch.from_numpy(x), a, ms,
                                torch.from_numpy(pos), start=start,
                                kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-5)


def test_gqa_kernel_dispatch_is_one_case(monkeypatch):
    """Only a segment at the Python int 0 with no prefix-LM span reaches
    the kernel."""
    import repro_torch.models.attention as attn_mod
    calls = []
    real = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a, _, _, p = _gqa_pair()
    x = torch.from_numpy(_np(15, 1, 8, 32))
    pos = torch.arange(8, dtype=torch.int32)
    for start, ms, want in ((0, MaskSpec(window=16), 1),
                            (None, MaskSpec(window=16), 0),
                            (torch.tensor(0), MaskSpec(window=16), 0),
                            (0, MaskSpec(prefix_len=2), 0)):
        calls.clear()
        gqa_fwd(p, x, a, ms, pos, start=start)
        assert len(calls) == want, (start, ms)
    calls.clear()
    gqa_fwd(p, x[:, :1], a, MaskSpec(window=16), pos[:1],
            kv=gqa_project_kv(p, x, a, pos), k_pos=pos, start=0)
    assert not calls
    # head dims past the kernel's D_MAX (gemma3, recurrentgemma: 256) take
    # the blockwise core, on the CPU as on the card
    a, _, _, p = _gqa_pair(head_dim=256)
    for start, ms in ((0, MaskSpec(window=16)), (0, MaskSpec())):
        gqa_fwd(p, x, a, ms, pos, start=start)
    assert not calls


@pytest.mark.parametrize("window", [16, None])
def test_gqa_head_dim_256_matches_reference(monkeypatch, window):
    """The segment at 0 that the kernel would take at head_dim <= 128
    goes to the blockwise core at 256, and gives the reference's
    ``gqa_fwd``."""
    import repro_torch.models.attention as attn_mod
    monkeypatch.setattr(attn_mod, "flash_attention", None)   # never called
    a, ref_a, ref_p, p = _gqa_pair(window=window, head_dim=256)
    x = _np(19, 2, 40, 32)
    pos = np.arange(40, dtype=np.int32)
    ms = MaskSpec(causal=True, window=window)
    want, _ = ref_attn.gqa_fwd(ref_p, jnp.asarray(x), ref_a,
                               ref_attn.MaskSpec(*ms), jnp.asarray(pos),
                               kv_block=16)
    got, _ = attention_fwd(p, torch.from_numpy(x), a, ms,
                           torch.from_numpy(pos), start=0, kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


def test_gqa_decode_over_a_ring_cache_matches_reference():
    a, ref_a, ref_p, p = _gqa_pair(window=8)
    x = _np(16, 2, 1, 32)
    kbuf, vbuf = _np(17, 2, 8, 2, 16), _np(18, 2, 8, 2, 16)
    k_pos = np.asarray([8, 9, 10, 3, 4, 5, 6, 7], np.int32)
    q_pos = np.asarray([10], np.int32)
    ms = MaskSpec(causal=True, window=8)
    want, _ = ref_attn.gqa_fwd(ref_p, jnp.asarray(x), ref_a,
                               ref_attn.MaskSpec(*ms), jnp.asarray(q_pos),
                               kv=(jnp.asarray(kbuf), jnp.asarray(vbuf)),
                               k_pos=jnp.asarray(k_pos), kv_block=8)
    got, _ = attention_fwd(p, torch.from_numpy(x), a, ms,
                           torch.from_numpy(q_pos),
                           kv=(torch.from_numpy(kbuf), torch.from_numpy(vbuf)),
                           k_pos=torch.from_numpy(k_pos), kv_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


def test_mla_waits_for_its_slice():
    """MLA's slice has come: the attention, its dispatch and its latent
    cache are served (``tests/test_torch_mla_moe.py`` holds them against
    the reference)."""
    a = AttentionSpec(kind="mla", n_heads=4, n_kv_heads=4, head_dim=24,
                      q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16)
    p = init_attention(32, a, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(p, MLA) and p.w_dkv.shape == (32, 16)
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
    y, latent = attention_fwd(p, x, a, MaskSpec(), torch.arange(5))
    assert y.shape == (2, 5, 32) and latent.shape == (2, 5, 16)
    cache = kc.init_attn_cache(a, 1, 8, torch.float32)
    assert set(cache) == {"latent", "pos"}
    assert cache["latent"].shape == (1, 8, 16)


# --------------------------------------------------------------------------
# the ring-cache write: its three cases
# --------------------------------------------------------------------------

def _cache_pair(window, max_len):
    a = AttentionSpec(kind="gqa", n_heads=2, n_kv_heads=2, head_dim=4,
                      window=window)
    ref_a = RefAttentionSpec(kind="gqa", n_heads=2, n_kv_heads=2, head_dim=4,
                             window=window)
    return (kc.init_attn_cache(a, 2, max_len, torch.float32),
            ref_kc.init_attn_cache(ref_a, 2, max_len, jnp.float32))


def _write_both(cache, ref_cache, s_new, start, seed):
    k, v = _np(seed, 2, s_new, 2, 4), _np(seed + 1, 2, s_new, 2, 4)
    ref_cache = ref_kc.write_attn_cache(ref_cache, jnp.asarray(k),
                                        jnp.asarray(v), jnp.int32(start))
    out = kc.write_attn_cache(cache, torch.from_numpy(k), torch.from_numpy(v),
                              start)
    assert out is cache     # written in place
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(ref_cache[name]))
    return ref_cache


@pytest.mark.parametrize("window,prompt", [
    (8, 13),      # longer than the ring: the trailing window, rolled
    (8, 8),       # exactly the ring
    (8, 5),       # a non-wrapping multi-token write
    (None, 5),    # a full cache (slots == positions)
])
def test_write_attn_cache_matches_reference(window, prompt):
    cache, ref_cache = _cache_pair(window, 20)
    assert cache["pos"].dtype == torch.int32
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    ref_cache = _write_both(cache, ref_cache, prompt, 0, seed=20)
    for t in range(prompt, prompt + 11):   # one-token decode, past the ring
        ref_cache = _write_both(cache, ref_cache, 1, t, seed=t)


def test_write_attn_cache_refuses_a_wrapping_segment():
    cache, _ = _cache_pair(8, 20)
    k = torch.zeros(2, 3, 2, 4)
    with pytest.raises(ValueError, match="wraps"):
        kc.write_attn_cache(cache, k, k, 6)


def test_layer_cache_of_unported_layers_raises():
    """Every layer's cache is ported now; the ones that need a size refuse
    to be built without it: a recurrent layer's without ``d_model``, a
    cross-attention layer's without ``enc_len``.  Given it, the cross
    cache is the reference's layout: ``self`` beside ``cross`` k/v (B,
    enc_len, KV, hd) in the cache dtype and ``pos = arange(enc_len)``."""
    from repro.models import kvcache as ref_kc
    with pytest.raises(ValueError, match="d_model"):
        kc.init_layer_cache(LayerSpec(mixer="rglru"), 1, 8, torch.float32)
    spec = LayerSpec(attn=AttentionSpec(n_heads=4, n_kv_heads=2,
                                        head_dim=16), cross_attn=True)
    with pytest.raises(ValueError, match="enc_len"):
        kc.init_layer_cache(spec, 1, 8, torch.float32)
    got = kc.init_layer_cache(spec, 2, 8, torch.bfloat16, enc_len=5)
    ref = ref_kc.init_layer_cache(spec, 64, 2, 8, 5, 2, jnp.bfloat16)
    assert set(got) == set(ref) == {"self", "cross"}
    for part in got:
        assert set(got[part]) == set(ref[part])
        for name, t in got[part].items():
            assert tuple(t.shape) == ref[part][name].shape, (part, name)
            assert str(t.dtype).split(".")[-1] == str(ref[part][name].dtype)
    np.testing.assert_array_equal(got["cross"]["pos"].numpy(),
                                  np.asarray(ref["cross"]["pos"]))
    assert not got["cross"]["k"].any()


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

def test_registry_knows_every_reference_arch():
    from repro.configs import ARCHS as REF_ARCHS
    assert list(ARCHS) == list(REF_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")
    # every arch is ported: each smoke and full config comes back
    for arch in ARCHS:
        assert get_config(arch, smoke=True).name.startswith(arch)
        assert get_config(arch).name == arch


@pytest.mark.parametrize("smoke", [False, True])
def test_h2o_config_is_the_reference(smoke):
    from repro.configs import get_config as ref_get_config
    cfg = get_config("h2o-danube-3-4b", smoke=smoke)
    ref_cfg = ref_get_config("h2o-danube-3-4b", smoke=smoke)
    assert repr(cfg) == repr(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
