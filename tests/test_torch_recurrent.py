"""The port's recurrent layers against ``repro.models.recurrent`` on the
same inputs, on the CPU: the two chunked scans, the RG-LRU and RWKV-6
mixers (float32, and bf16 after ``cast_to_compute``), decode against
prefill, the causal conv, token shift and the RWKV channel mix.

Tolerances are ``tests/test_layers.py``'s: the scans within 2e-5
(``:208-244``), decode against prefill within 3e-5 (RG-LRU) and 3e-4
(RWKV-6) (``:247-279``); the mixers within 2e-5 of max|ref| in float32
and 5e-2 in bf16 (both frameworks accumulate bf16 products in float32
but round and order them differently).  Inputs are made with numpy;
parameters come from the reference's ``init_*`` and are carried across
by ``convert.load_tree``.  Widths stay at 64 or less.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_L
from repro.models import recurrent as ref_rec
from repro.models.config import RecurrentSpec as RefRecurrentSpec
from repro_torch.models import layers as L
from repro_torch.models import recurrent as rec
from repro_torch.models.config import RecurrentSpec
from repro_torch.models.convert import load_tree
from repro_torch.train import cast_to_compute

SCAN_TOL = 2e-5      # tests/test_layers.py:220,243
RGLRU_STEP_TOL = 3e-5   # tests/test_layers.py:259-262
RWKV_STEP_TOL = 3e-4    # tests/test_layers.py:276-279
MIX_TOL = 2e-5       # float32 mixers, relative to max|ref|
BF16_TOL = 5e-2      # bf16 rounding differs between the two frameworks


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# --------------------------------------------------------------------------
# the two scans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(37, 8), (64, 16), (1, 256)])
def test_vector_recurrence_matches_reference(t, chunk):
    """T 37 with chunk 8 falls to chunks of 1 (37 is prime): the
    reference's own case; 64/16 runs four scans of 4 rounds."""
    la = -np.abs(_np(0, 2, t, 5)) * 0.3
    b, h0 = _np(1, 2, t, 5), _np(2, 2, 5)
    want, want_last = ref_rec.vector_recurrence(
        jnp.asarray(la), jnp.asarray(b), jnp.asarray(h0), chunk)
    got, last = rec.vector_recurrence(_t(la), _t(b), _t(h0), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=SCAN_TOL)


def test_vector_recurrence_against_a_loop():
    la = -np.abs(_np(3, 2, 40, 6)) * 0.3
    b, h0 = _np(4, 2, 40, 6), _np(5, 2, 6)
    got, last = rec.vector_recurrence(_t(la), _t(b), _t(h0), 16)
    h = h0.copy()
    for t in range(40):
        h = np.exp(la[:, t]) * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, atol=SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), h, atol=SCAN_TOL)


def _matrix_inputs(seed, b=2, t=24, h=3, k=4, v=4, decay=0.5):
    rs = np.random.RandomState(seed)
    lw = (-np.abs(rs.randn(b, t, h, k)) * decay).astype(np.float32)
    return (lw, *(rs.randn(*s).astype(np.float32) for s in (
        (b, t, h, k), (b, t, h, v), (b, t, h, k), (h, k), (b, h, k, v))))


@pytest.mark.parametrize("chunk", [1, 4, 6, 24])
def test_matrix_recurrence_matches_reference(chunk):
    args = _matrix_inputs(6)
    want, want_s = ref_rec.matrix_recurrence(*map(jnp.asarray, args),
                                             chunk=chunk)
    got, s = rec.matrix_recurrence(*map(_t, args), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=SCAN_TOL)


def test_matrix_recurrence_masks_overflowing_exponents():
    """Decays of -60 a step: over a 24-token chunk the masked exponents
    d_prev[t] - dcum[s] (s >= t) reach +1380, far past float32's range.
    They are masked before ``exp``, so no inf or NaN reaches ``o``, and
    the output is the reference's."""
    lw, k, v, r, u, s0 = _matrix_inputs(7)
    lw = np.full_like(lw, -60.0)
    assert 60.0 * 23 > np.log(np.finfo(np.float32).max)
    want, want_s = ref_rec.matrix_recurrence(
        *map(jnp.asarray, (lw, k, v, r, u, s0)), chunk=24)
    got, s = rec.matrix_recurrence(*map(_t, (lw, k, v, r, u, s0)), chunk=24)
    assert torch.isfinite(got).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=SCAN_TOL)


# --------------------------------------------------------------------------
# conv, token shift, channel mix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 7])
def test_causal_conv_matches_reference(t):
    x, w, prev = _np(8, 2, t, 6), _np(9, 4, 6), _np(10, 2, 3, 6)
    want = ref_rec._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(prev))
    got = rec._causal_conv(_t(x), _t(w), _t(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift_matches_reference(with_prev):
    x, prev = _np(11, 2, 5, 4), _np(12, 2, 4)
    want = ref_L.token_shift(jnp.asarray(x),
                             jnp.asarray(prev) if with_prev else None)
    got = L.token_shift(_t(x), _t(prev) if with_prev else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rwkv_channel_mix_matches_reference():
    ref_p = ref_L.init_ffn(jax.random.PRNGKey(3), 16, 32, "rwkv_cm")
    ref_p = {**ref_p, "mu_k": jnp.asarray(_np(13, 16) * 0.3 + 0.5),
             "mu_r": jnp.asarray(_np(14, 16) * 0.3 + 0.5)}
    p = L.init_ffn(16, 32, "rwkv_cm", torch.Generator().manual_seed(0))
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == {
        "mu_k": (16,), "mu_r": (16,), "w_k": (16, 32), "w_v": (32, 16),
        "w_r": (16, 16)}
    load_tree(p, _tree(ref_p), "rwkv_cm")
    x, prev = _np(15, 2, 5, 16), _np(16, 2, 5, 16)
    want = ref_L.ffn_fwd(ref_p, jnp.asarray(x), "rwkv_cm",
                         x_prev=jnp.asarray(prev))
    got = L.ffn_fwd(p, _t(x), "rwkv_cm", x_prev=_t(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="x_prev"):
        L.ffn_fwd(p, _t(x), "rwkv_cm")


# --------------------------------------------------------------------------
# the mixers
# --------------------------------------------------------------------------

RGLRU = dict(kind="rglru", d_state=48, conv_width=4, chunk=8)
RWKV = dict(kind="rwkv6", n_heads=4, chunk=8)


def _mixer_pair(kind, d=32, seed=0):
    """(spec, ref_spec, ref_params, module) with the reference's
    parameters carried across."""
    kw = RGLRU if kind == "rglru" else RWKV
    spec, ref_spec = RecurrentSpec(**kw), RefRecurrentSpec(**kw)
    key = jax.random.PRNGKey(seed)
    if kind == "rglru":
        ref_p = ref_rec.init_rglru(key, d, ref_spec)
        p = rec.RGLRU(d, spec, "cpu")
    else:
        ref_p = ref_rec.init_rwkv6(key, d, ref_spec)
        # non-trivial token-shift mixes, so the test sees them
        ref_p = {**ref_p, "mu_base": jnp.asarray(_np(17, d) * 0.2 + 0.5),
                 "mu_rkvwg": jnp.asarray(_np(18, 5, d) * 0.2 + 0.5)}
        p = rec.RWKV6(d, spec, "cpu")
    load_tree(p, _tree(ref_p), kind)
    return spec, ref_spec, ref_p, p


def _ref_fwd(kind):
    return ref_rec.rglru_fwd if kind == "rglru" else ref_rec.rwkv6_fwd


def _fwd(kind):
    return rec.rglru_fwd if kind == "rglru" else rec.rwkv6_fwd


def _state_pair(kind, spec, d, b, dtype, seed):
    """A non-zero entry state in both packages."""
    if kind == "rglru":
        h, conv = _np(seed, b, 48), _np(seed + 1, b, 3, 48)
        return (ref_rec.RGLRUState(jnp.asarray(h),
                                   jnp.asarray(conv).astype(dtype[0])),
                rec.RGLRUState(_t(h), _t(conv).to(dtype[1])))
    s, xp = _np(seed, b, 4, d // 4, d // 4), _np(seed + 1, b, d)
    return (ref_rec.RWKVState(jnp.asarray(s), jnp.asarray(xp).astype(
                dtype[0])),
            rec.RWKVState(_t(s), _t(xp).to(dtype[1])))


@pytest.mark.parametrize("kind", ["rglru", "rwkv6"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mixer_matches_reference(kind, with_state):
    spec, ref_spec, ref_p, p = _mixer_pair(kind)
    x = _np(20, 2, 24, 32)
    ref_state, state = (_state_pair(kind, spec, 32, 2,
                                    (jnp.float32, torch.float32), 21)
                        if with_state else (None, None))
    want, want_new = _ref_fwd(kind)(ref_p, jnp.asarray(x), ref_spec,
                                    ref_state)
    got, new = _fwd(kind)(p, _t(x), spec, state)
    _close(got, want, MIX_TOL)
    for a, b_ in zip(new, want_new):
        assert a.dtype == torch.float32
        _close(a, b_, MIX_TOL)


@pytest.mark.parametrize("kind", ["rglru", "rwkv6"])
def test_mixer_bf16_after_cast_to_compute(kind):
    """The weights cast as serving casts them (float32 parameters with
    ndim >= 2 to bf16), bf16 activations: the reference promotes its
    float32-activation products to float32, and so does the port."""
    spec, ref_spec, ref_p, p = _mixer_pair(kind, seed=1)
    cast_to_compute(p, "bfloat16")
    ref_p = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2
                         else a, ref_p)
    x = _np(22, 2, 24, 32)
    ref_state, state = _state_pair(kind, spec, 32, 2,
                                   (jnp.bfloat16, torch.bfloat16), 23)
    want, want_new = _ref_fwd(kind)(ref_p, jnp.asarray(x, jnp.bfloat16),
                                    ref_spec, ref_state)
    got, new = _fwd(kind)(p, _t(x).bfloat16(), spec, state)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    for a, b_ in zip(new, want_new):
        assert a.dtype == {jnp.float32: torch.float32,
                           jnp.bfloat16: torch.bfloat16}[b_.dtype.type]
        _close(a, b_, BF16_TOL)


@pytest.mark.parametrize("kind,tol", [("rglru", RGLRU_STEP_TOL),
                                      ("rwkv6", RWKV_STEP_TOL)])
def test_decode_matches_prefill(kind, tol):
    """tests/test_layers.py:247-279 on the port: step-by-step decode ==
    one prefill pass over the same tokens, outputs and state."""
    d = 16
    kw = dict(kind="rglru", d_state=d, conv_width=4, chunk=4) \
        if kind == "rglru" else dict(kind="rwkv6", n_heads=2, chunk=4)
    spec = RecurrentSpec(**kw)
    gen = torch.Generator().manual_seed(0)
    init = rec.init_rglru if kind == "rglru" else rec.init_rwkv6
    p = init(d, spec, gen, "cpu")
    b, t = (2, 12) if kind == "rglru" else (1, 8)
    x = _t(_np(24, b, t, d))
    state0 = (rec.rglru_init_state(b, d, 4, torch.float32)
              if kind == "rglru" else
              rec.rwkv6_init_state(b, d, 2, torch.float32))
    y_all, st_all = _fwd(kind)(p, x, spec, state0)
    st, ys = state0, []
    for i in range(t):
        y, st = _fwd(kind)(p, x[:, i:i + 1], spec, st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(),
                               atol=tol)
    np.testing.assert_allclose(st[0].numpy(), st_all[0].numpy(), atol=tol)
    np.testing.assert_allclose(st[1].numpy(), st_all[1].numpy(), atol=tol)


@pytest.mark.parametrize("kind", ["rglru", "rwkv6"])
def test_init_draws_the_reference_tree(kind):
    """The seeded init has the reference's names, shapes and constants."""
    d = 64
    kw = dict(RGLRU, d_state=None) if kind == "rglru" else RWKV
    spec = RecurrentSpec(**kw)
    init = rec.init_rglru if kind == "rglru" else rec.init_rwkv6
    p = init(d, spec, torch.Generator().manual_seed(0), "cpu")
    ref_init = ref_rec.init_rglru if kind == "rglru" else ref_rec.init_rwkv6
    ref = _tree(ref_init(jax.random.PRNGKey(0), d, RefRecurrentSpec(**kw)))
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == \
        {n: a.shape for n, a in ref.items()}
    for name, t in p.named_parameters():
        if name in ("lam",):
            assert 2.0 <= t.min() and t.max() <= 6.0
        elif np.all(ref[name] == ref[name].flat[0]):     # a constant
            np.testing.assert_array_equal(t.numpy(), ref[name])
        else:   # truncated normal at the reference's std: within 2 std
            bound = np.abs(ref[name]).max()
            assert 0 < t.abs().max() <= bound * 1.05 + 1e-6, name
    load_tree(p, ref, kind)


def test_chunk_rule_is_the_reference():
    for t, c in ((37, 8), (64, 16), (4096, 256), (6, 4), (1, 64)):
        want = min(c, t)
        while t % want:
            want -= 1
        assert rec._chunk_len(t, c) == want
