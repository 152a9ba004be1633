"""The port's MLA attention, latent cache and MoE FFN against
``repro.models`` on the same inputs, on the CPU, and the two models that
need them (deepseek-v2-236b, mixtral-8x22b) at their smoke sizes.

Tolerances are the reference tests' own: absorbed vs decompressed MLA
within 2e-6 with equal latents (``tests/test_perf_paths.py:13-26``),
attention 2e-5 (``tests/test_layers.py``), ``moe_fwd`` 1e-5 and its
dense oracle 1e-4 (``tests/test_layers.py:162-182``), the logits of the
train, prefill and decode passes 2e-4·max|ref| at capacity factor 16
(``tests/test_models_smoke.py:68-117``), bf16 5e-2·max|ref|.  Inputs
are made with numpy; parameters come from the reference's ``init_*`` and
are carried across as numpy arrays.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import forward as ref_forward
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.models import kvcache as ref_kc
from repro.models import moe as ref_moe
from repro.models.config import AttentionSpec as RefAttentionSpec
from repro.models.config import MoESpec as RefMoESpec
from repro.models.config import Stage as RefStage
from repro.train import make_serve_steps as ref_make_serve_steps
from repro.train.data import synth_tokens as ref_synth_tokens
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (Model, Stage, forward, init_caches,
                                params_from_numpy)
from repro_torch.models import kvcache as kc
from repro_torch.models import moe
from repro_torch.models.attention import (MLA, MaskSpec, attention_fwd,
                                          init_mla, mla_fwd,
                                          mla_project_latent)
from repro_torch.models.config import AttentionSpec, MoESpec
from repro_torch.models.convert import load_tree
from repro_torch.train import cast_to_compute, make_serve_steps

ABSORB_TOL = 2e-6   # tests/test_perf_paths.py:24
ATTN_TOL = 2e-5     # tests/test_layers.py
MOE_TOL = 1e-5      # tests/test_perf_paths.py:64
ORACLE_TOL = 1e-4   # tests/test_layers.py:182
TF_TOL = 2e-4       # tests/test_models_smoke.py:111-113
BF16_TOL = 5e-2     # bf16 rounding differs between the two frameworks
MOE_ARCHS = ["deepseek-v2-236b", "mixtral-8x22b"]

MLA_DIMS = dict(kind="mla", n_heads=4, n_kv_heads=4, head_dim=24,
                kv_lora_rank=8, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def _mla_pair(q_lora_rank=16, absorb="always", seed=0, d=32):
    a = AttentionSpec(**MLA_DIMS, q_lora_rank=q_lora_rank, mla_absorb=absorb)
    ref_a = RefAttentionSpec(**MLA_DIMS, q_lora_rank=q_lora_rank,
                             mla_absorb=absorb)
    ref_p = ref_attn.init_mla(jax.random.PRNGKey(seed), d, ref_a)
    p = MLA(d, a, "cpu")
    load_tree(p, _tree(ref_p), "mla")
    return a, ref_a, ref_p, p


def test_absorbed_mla_equals_decompressed():
    """tests/test_perf_paths.py:13-26 on the port: one function, two
    routes, and the latent is the same tensor either way."""
    a, _, _, p = _mla_pair()
    x = torch.from_numpy(_np(1, 2, 8, 32))
    pos = torch.arange(8)
    y_abs, lat_a = mla_fwd(p, x, a, MaskSpec(causal=True), pos, absorbed=True)
    y_dec, lat_d = mla_fwd(p, x, a, MaskSpec(causal=True), pos,
                           absorbed=False)
    np.testing.assert_allclose(y_abs.numpy(), y_dec.numpy(), atol=ABSORB_TOL)
    assert torch.equal(lat_a, lat_d)


@pytest.mark.parametrize("absorb", ["always", "never", "decode"])
@pytest.mark.parametrize("q_lora_rank", [16, 0])
@pytest.mark.parametrize("s", [8, 1])
def test_mla_self_attention_matches_reference(absorb, q_lora_rank, s):
    """Every ``mla_absorb`` mode, low-rank and full queries, a segment and
    a single token, through ``attention_fwd``'s dispatch."""
    a, ref_a, ref_p, p = _mla_pair(q_lora_rank, absorb)
    x = _np(2, 2, s, 32)
    q_pos = np.arange(3, 3 + s, dtype=np.int32)
    ms = MaskSpec(causal=True)
    want, want_lat = ref_attn.attention_fwd(
        ref_p, jnp.asarray(x), ref_a, ref_attn.MaskSpec(causal=True),
        jnp.asarray(q_pos), kv_block=4)
    got, lat = attention_fwd(p, _t(x), a, ms, _t(q_pos), kv_block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), atol=1e-6)


@pytest.mark.parametrize("absorb", ["always", "never", "decode"])
def test_mla_decode_over_a_latent_buffer_with_empty_slots(absorb):
    """A query over a latent buffer whose empty slots sit at -1 (rope of a
    negative position stays finite; the slots are masked), against the
    reference."""
    a, ref_a, ref_p, p = _mla_pair(absorb=absorb)
    x = _np(3, 2, 1, 32)
    latent = _np(4, 2, 12, 16)
    k_pos = np.array([0, 1, 2, 3, 4, 5, 6, -1, -1, -1, -1, -1], np.int32)
    q_pos = np.array([6], np.int32)
    want, _ = ref_attn.attention_fwd(
        ref_p, jnp.asarray(x), ref_a, ref_attn.MaskSpec(causal=True),
        jnp.asarray(q_pos), kv=jnp.asarray(latent), k_pos=jnp.asarray(k_pos),
        kv_block=12)
    got, echoed = attention_fwd(p, _t(x), a, MaskSpec(causal=True), _t(q_pos),
                                kv=_t(latent), k_pos=_t(k_pos), kv_block=12)
    assert torch.isfinite(got).all() and echoed is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)
    # the masked slots carry no weight: garbage there changes nothing
    poisoned = latent.copy()
    poisoned[:, 7:] = 1e4
    again, _ = attention_fwd(p, _t(x), a, MaskSpec(causal=True), _t(q_pos),
                             kv=_t(poisoned), k_pos=_t(k_pos), kv_block=12)
    assert torch.equal(again, got)


def test_mla_init_and_latent_projection():
    a = AttentionSpec(**MLA_DIMS, q_lora_rank=16)
    p = init_mla(32, a, torch.Generator().manual_seed(0), "cpu")
    names = {n: tuple(t.shape) for n, t in p.named_parameters()}
    ref = _tree(ref_attn.init_mla(jax.random.PRNGKey(0), 32, RefAttentionSpec(
        **MLA_DIMS, q_lora_rank=16)))
    assert names == {k: v.shape for k, v in ref.items()}
    assert "wq" in dict(init_mla(32, AttentionSpec(**MLA_DIMS), None,
                                 "cpu").named_parameters())
    # truncated at two standard deviations
    assert p.w_dkv.abs().max() <= 2 * 32 ** -0.5
    x = torch.from_numpy(_np(5, 2, 3, 32))
    want = ref_attn.mla_project_latent(ref, jnp.asarray(x.numpy()), None)
    load_tree(p, ref, "mla")
    np.testing.assert_allclose(mla_project_latent(p, x, a).numpy(),
                               np.asarray(want), atol=1e-6)


# --------------------------------------------------------------------------
# the latent cache
# --------------------------------------------------------------------------

def _latent_cache_pair(max_len):
    a = AttentionSpec(**MLA_DIMS, q_lora_rank=16)
    ref_a = RefAttentionSpec(**MLA_DIMS, q_lora_rank=16)
    return (kc.init_attn_cache(a, 2, max_len, torch.float32),
            ref_kc.init_attn_cache(ref_a, 2, max_len, jnp.float32))


def test_latent_cache_writes_match_reference():
    cache, ref_cache = _latent_cache_pair(20)
    assert cache["pos"].dtype == torch.int32
    for name in ("latent", "pos"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(ref_cache[name]))

    def write(s_new, start, seed):
        lat = _np(seed, 2, s_new, 16)
        want = ref_kc.write_latent_cache(ref_cache, jnp.asarray(lat),
                                         jnp.int32(start))
        assert kc.write_latent_cache(cache, _t(lat), start) is cache
        for name in ("latent", "pos"):
            np.testing.assert_array_equal(cache[name].numpy(),
                                          np.asarray(want[name]))
        return want

    ref_cache = write(7, 0, seed=10)                 # prefill
    for t in range(7, 20):                            # one-token decode
        ref_cache = write(1, t, seed=t)
    assert cache["pos"].tolist() == list(range(20))


def test_latent_cache_refuses_a_wrapping_segment():
    cache, _ = _latent_cache_pair(8)
    with pytest.raises(ValueError, match="wraps"):
        kc.write_latent_cache(cache, torch.zeros(2, 3, 16), 6)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_pair(d, m_kw, seed=0):
    m, ref_m = MoESpec(**m_kw), RefMoESpec(**m_kw)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(seed), d, ref_m)
    p = moe.MoE(d, m, "cpu")
    load_tree(p, _tree(ref_p), "moe")
    return m, ref_m, ref_p, p


MOE_CASES = {
    "no-drop": (16, dict(n_experts=4, top_k=2, d_ff_expert=32,
                         capacity_factor=8.0), (2, 8)),
    "drops": (16, dict(n_experts=4, top_k=2, d_ff_expert=32,
                       capacity_factor=0.5), (2, 32)),
    "shared": (16, dict(n_experts=6, top_k=2, n_shared=1, d_ff_expert=32,
                        capacity_factor=16.0), (4, 8)),
    "deepseek-like": (24, dict(n_experts=16, top_k=6, n_shared=2,
                               d_ff_expert=8, capacity_factor=1.25), (2, 40)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_fwd_matches_reference(case):
    d, m_kw, (b, s) = MOE_CASES[case]
    m, ref_m, ref_p, p = _moe_pair(d, m_kw)
    x = _np(1, b, s, d)
    want = np.asarray(ref_moe.moe_fwd(ref_p, jnp.asarray(x), ref_m))
    got = moe.moe_fwd(p, _t(x), m)
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=MOE_TOL)


def test_moe_no_drop_equals_dense_reference():
    """tests/test_layers.py:162-182: every expert on every token, weighted
    by the renormalised gates, in numpy."""
    d, e, k = 16, 4, 2
    m, _, ref_p, p = _moe_pair(d, dict(n_experts=e, top_k=k, d_ff_expert=32,
                                       capacity_factor=8.0))
    x = _np(2, 2, 8, d)
    y = moe.moe_fwd(p, _t(x), m).numpy()
    w = _tree(ref_p)
    xt = x.reshape(-1, d)
    logits = xt @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, -1)[:, :k]
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        gs = probs[t, top[t]] / probs[t, top[t]].sum()
        for j, eid in enumerate(top[t]):
            h = xt[t] @ w["w_gate"][eid]
            g = h / (1.0 + np.exp(-h))
            ref[t] += gs[j] * (g * (xt[t] @ w["w_up"][eid])) @ w["w_down"][eid]
    np.testing.assert_allclose(y.reshape(-1, d), ref, atol=ORACLE_TOL)


def test_moe_capacity_drops_the_same_tokens():
    """tests/test_layers.py:185-193: at capacity factor 0.1 most tokens are
    dropped, and exactly the reference's rows are zero."""
    m, ref_m, ref_p, p = _moe_pair(8, dict(n_experts=2, top_k=1,
                                           d_ff_expert=16,
                                           capacity_factor=0.1), seed=1)
    x = _np(3, 4, 64, 8)
    want = np.asarray(ref_moe.moe_fwd(ref_p, jnp.asarray(x), ref_m))
    got = moe.moe_fwd(p, _t(x), m).numpy()
    zero = np.all(got.reshape(-1, 8) == 0, axis=-1)
    assert zero.sum() > 100
    np.testing.assert_array_equal(
        zero, np.all(want.reshape(-1, 8) == 0, axis=-1))
    np.testing.assert_allclose(got, want, atol=MOE_TOL)


def test_moe_bf16_matches_reference():
    d, m_kw, (b, s) = MOE_CASES["shared"]
    m, ref_m, ref_p, p = _moe_pair(d, m_kw)
    x = _np(4, b, s, d)
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a,
                      ref_p)
    want = np.asarray(ref_moe.moe_fwd(bf, jnp.asarray(x, jnp.bfloat16),
                                      ref_m).astype(jnp.float32))
    cast_to_compute(p, "bfloat16")
    got = moe.moe_fwd(p, _t(x).bfloat16(), m)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


def test_moe_aux_loss_matches_reference():
    m, ref_m, ref_p, p = _moe_pair(8, dict(n_experts=4, top_k=2,
                                           d_ff_expert=16), seed=2)
    x = _np(5, 2, 32, 8)
    want = float(ref_moe.aux_load_balance_loss(ref_p, jnp.asarray(x), ref_m))
    got = moe.aux_load_balance_loss(p, _t(x), m)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("tokens", [1, 2, 37, 4096, 8192, 12288])
def test_capacity_matches_reference(tokens):
    for kw in (dict(n_experts=160, top_k=6, capacity_factor=1.25),
               dict(n_experts=8, top_k=2, capacity_factor=1.25),
               dict(n_experts=8, top_k=2, capacity_factor=16.0)):
        assert moe._capacity(tokens, MoESpec(**kw)) == \
            ref_moe._capacity(tokens, RefMoESpec(**kw))


def test_moe_init_draws_the_reference_tree():
    m = MoESpec(n_experts=6, top_k=2, n_shared=2, d_ff_expert=8)
    p = moe.init_moe(16, m, torch.Generator().manual_seed(0), "cpu")
    ref = _tree(ref_moe.init_moe(jax.random.PRNGKey(0), 16, RefMoESpec(
        n_experts=6, top_k=2, n_shared=2, d_ff_expert=8)))
    got = {n: tuple(t.shape) for n, t in p.named_parameters()}
    assert got == {"router": (16, 6), "w_gate": (6, 16, 8),
                   "w_up": (6, 16, 8), "w_down": (6, 8, 16),
                   "shared.w_gate": (16, 16), "shared.w_up": (16, 16),
                   "shared.w_down": (16, 16)}
    load_tree(p, ref, "moe")        # the reference's names and shapes
    assert p.w_down.abs().max() <= 2 * 8 ** -0.5


# --------------------------------------------------------------------------
# the two models at their smoke sizes
# --------------------------------------------------------------------------

def _high_capacity(cfg, stage_cls):
    """tests/test_models_smoke.py:68-77: no drops, so teacher forcing
    holds across the three modes."""
    stages = tuple(stage_cls(tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=16.0)) if sp.moe else sp
        for sp in st.pattern), st.repeat) for st in cfg.stages)
    return dataclasses.replace(cfg, stages=stages)


def _pair(arch, dtype="float32", seed=0, high_capacity=True):
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if high_capacity:
        ref_cfg, cfg = (_high_capacity(ref_cfg, RefStage),
                        _high_capacity(cfg, Stage))
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_prefill_decode_match_reference(arch):
    """The reference's teacher-forcing case (B 2, S 24, capacity factor
    16): the port's train, prefill and decode logits against JAX
    ``forward``'s, the caches layer by layer, and decode == train at S."""
    ref_cfg, ref_params, cfg, model = _pair(arch)
    b, s = 2, 24
    tokens = _tokens(b, s + 1, cfg.vocab)
    ref, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens),
                         mode="train", kv_block=16)
    got, _ = forward(model, cfg, _t(tokens), mode="train", kv_block=16)
    _close(got, ref, TF_TOL)

    ref_caches = ref_init_caches(ref_cfg, b, max_len=64, dtype=jnp.float32)
    ref_pre, ref_caches = ref_forward(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, :s]),
                                      mode="prefill", caches=ref_caches,
                                      kv_block=16)
    caches = init_caches(cfg, b, max_len=64, dtype=torch.float32,
                         device="cpu")
    pre, caches = forward(model, cfg, _t(tokens[:, :s]), mode="prefill",
                          caches=caches, kv_block=16)
    _close(pre, ref_pre, TF_TOL)
    for si, stage in enumerate(cfg.stages):
        for li in range(stage.repeat):
            ref_c = jax.tree.map(lambda a: np.asarray(a)[li],
                                 ref_caches[si]["p0"]["self"])
            c = caches[si][li]["self"]
            assert set(c) == set(ref_c)
            np.testing.assert_array_equal(c["pos"].numpy(), ref_c["pos"])
            for name in set(c) - {"pos"}:
                np.testing.assert_allclose(c[name].numpy(), ref_c[name],
                                           atol=1e-5)

    ref_dec, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(tokens[:, s:]),
                             mode="decode", caches=ref_caches, start=s,
                             kv_block=16)
    dec, _ = forward(model, cfg, _t(tokens[:, s:]), mode="decode",
                     caches=caches, start=s, kv_block=16)
    _close(dec, ref_dec, TF_TOL)
    _close(dec[:, 0], got[:, s].numpy(), TF_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_serving_matches_reference(arch):
    """The configs' own capacity (drops and all, the same in both) in
    bf16 through the serve steps."""
    ref_cfg, ref_params, cfg, model = _pair(arch, "bfloat16",
                                            high_capacity=False)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_main_matches_reference_greedy_loop(monkeypatch, arch):
    """``lm_main --arch ... --smoke --device cpu`` end to end: the tokens
    of a JAX prefill + greedy decode loop from the same weights, float32,
    at the smoke config's own capacity."""
    b, prompt_len, gen_len, seed = 2, 20, 5, 3
    ref_cfg, ref_params, cfg, model = _pair(arch, seed=seed,
                                            high_capacity=False)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    out = capsys.readouterr().out
    assert f"model: {arch}-smoke (bfloat16)" in out and "decode :" in out


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference(arch, smoke):
    cfg, ref_cfg = get_config(arch, smoke=smoke), ref_get_config(arch,
                                                                 smoke=smoke)
    assert repr(cfg) == repr(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_model_builds_on_meta(arch):
    """The full model on the meta device (no memory): the analytic count
    plus the final norm's d_model, MLA and MoE modules included."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model
    layer = model.stages[-1][0]
    assert isinstance(layer.ffn, moe.MoE)
    assert isinstance(layer.mixer, MLA) == (arch == "deepseek-v2-236b")
