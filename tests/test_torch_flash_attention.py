"""The flash-attention kernel's plain version against the JAX package, on
the CPU.

The plain version (``repro_torch.kernels.flash_attention``) is what a CPU
tensor reaches and what the card holds the CUDA kernel against
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).  Here it is
held against the Pallas kernel in interpret mode at the reference test's
four configurations (atol 5e-5) and its bf16 case (atol 3e-2,
``tests/test_kernels_fft.py:84-115``, and each element within 2**-6 of
its value plus 5e-5), against the reference oracle
``ref_flash_attention`` at the model's head_dim of 120 and at ragged
lengths the Pallas kernel does not take, and against the port's
``blockwise_attention`` on the model path's case.  The same numpy inputs
go through both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import ref_flash_attention as ref_oracle
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.attention import MaskSpec, blockwise_attention

ATTN_TOL = 5e-5       # tests/test_kernels_fft.py:103
ATTN_BF16_TOL = 3e-2  # tests/test_kernels_fft.py:115
# and per element: both sides work in float32 and round the result to
# bf16 at the end, each within 2**-8 of the value
ATTN_BF16_REL = 2.0 ** -6


def _qkv(b, sq, skv, h, kv, d, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(dtype),
            rng.randn(b, skv, kv, d).astype(dtype),
            rng.randn(b, skv, kv, d).astype(dtype))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("cfg", [
    dict(b=2, sq=256, skv=256, h=4, kv=2, d=64, causal=True, win=None),
    dict(b=1, sq=128, skv=256, h=8, kv=8, d=32, causal=True, win=64),
    dict(b=1, sq=256, skv=256, h=2, kv=1, d=64, causal=False, win=None),
    dict(b=1, sq=128, skv=128, h=4, kv=4, d=128, causal=True, win=32),
])
def test_plain_matches_pallas_kernel(cfg):
    q, k, v = _qkv(cfg["b"], cfg["sq"], cfg["skv"], cfg["h"], cfg["kv"],
                   cfg["d"])
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=cfg["causal"], window=cfg["win"], q_block=128,
                     kv_chunk=128)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=cfg["causal"],
                                window=cfg["win"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, seed=1)
    want = ref_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), q_block=128, kv_chunk=64)
    got = flash_attention_plain(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATTN_BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ATTN_BF16_REL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("b,sq,skv,h,kv,d,causal,win", [
    (1, 200, 200, 8, 2, 120, True, 64),     # the model's head_dim, ragged S
    (2, 77, 200, 4, 1, 120, True, None),    # Sq != Skv, neither a multiple
    (1, 130, 130, 4, 2, 120, False, 50),    # non-causal window
    (1, 150, 40, 2, 1, 32, True, 16),       # rows with no valid key at all
])
def test_plain_matches_reference_oracle(b, sq, skv, h, kv, d, causal, win):
    q, k, v = _qkv(b, sq, skv, h, kv, d, seed=2)
    want = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=win))
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                window=win, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL)
    # the port's oracle is the reference's
    np.testing.assert_allclose(
        ref.ref_flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                window=win).numpy(), want, atol=ATTN_TOL)


def test_fully_masked_rows_average_every_value():
    """With no valid key (positions past skv + window - 1) a row's scores
    are all NEG_INF: the softmax is uniform over the keys, as in the
    reference, never NaN."""
    q, k, v = _qkv(1, 12, 4, 1, 1, 8, seed=3)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=True, window=2,
                                kv_chunk=2)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0, 10:, 0].numpy(),
                               np.broadcast_to(v[0, :, 0].mean(0), (2, 8)),
                               atol=1e-6)
    assert NEG_INF == -2.0 ** 30


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, ATTN_BF16_TOL)])
def test_model_path_equals_blockwise(dtype, tol):
    """The model passes q pre-scaled (in its dtype) with scale 1; over
    positions 0..S-1 the kernel's function is ``blockwise_attention``'s,
    which casts p to v's dtype where the kernel keeps it in float32."""
    q, k, v = _qkv(2, 70, 70, 8, 2, 120, seed=4)
    q, k, v = _t(q, dtype) * 120 ** -0.5, _t(k, dtype), _t(v, dtype)
    pos = torch.arange(70)
    ms = MaskSpec(causal=True, window=32)
    want = blockwise_attention(q, k, v, ms, pos, pos, kv_block=16)
    got = flash_attention(q, k, v, causal=True, window=32, scale=1.0)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               want.to(dtype).float().numpy(), atol=tol)


def test_cpu_tensor_takes_the_plain_version():
    q, k, v = (_t(a) for a in _qkv(1, 33, 33, 4, 2, 16, seed=5))
    assert torch.equal(flash_attention(q, k, v, window=8),
                       flash_attention_plain(q, k, v, window=8))
    # the default scale is head_dim ** -0.5
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_plain(q, k, v, scale=0.25))


def test_shape_checks():
    q, k, v = (_t(a) for a in _qkv(1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, k, v)
    q, k, v = (_t(a) for a in _qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="incompatible"):
        flash_attention(q, k[..., :8], v)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="expected q"):
        flash_attention(q[0], k, v)


def _attention_p_rounded(q, k, v, p_terms, *, causal=True, window=None,
                         kv_chunk=64):
    """The plain version's online softmax with p replaced before the P·V
    product by ``p_terms(p)``, a list of bf16 terms whose products with v
    are summed in float32 (the tensor-core kernel's choice of operands)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf, kf, vf = q.float() * d ** -0.5, k.float(), v.float()
    q_pos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    for c0 in range(0, skv, kv_chunk):
        kc, vc = kf[:, c0:c0 + kv_chunk], vf[:, c0:c0 + kv_chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc)
        k_pos = torch.arange(c0, c0 + kc.shape[1])[None, :]
        mask = torch.ones(sq, kc.shape[1], dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = sum(torch.einsum("bhqk,bkhd->bhqd", t.float(), vc)
                 for t in p_terms(p))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _split(p):
    hi = p.to(torch.bfloat16)
    return [hi, (p - hi.float()).to(torch.bfloat16)]


@pytest.mark.parametrize("p_terms,holds", [
    (_split, True),                                  # the kernel's design
    (lambda p: [p.to(torch.bfloat16)], False),       # one rounding of p
])
def test_bf16_p_split_holds_the_per_element_bound(p_terms, holds):
    """Why the tensor-core kernel splits p into bf16 hi and lo terms: at
    the reference's bf16 case, against the Pallas kernel in interpret
    mode, the split holds every element within 2**-6 of its value plus
    5e-5; a single bf16 rounding of p does not."""
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, seed=1)
    want = ref_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), q_block=128, kv_chunk=64)
    want = np.asarray(want, np.float32)
    got = _attention_p_rounded(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                               _t(v, torch.bfloat16), p_terms)
    share = (np.abs(got.float().numpy() - want)
             / (ATTN_BF16_REL * np.abs(want) + ATTN_TOL)).max()
    assert (share <= 1.0) == holds, share


def test_variant_rule():
    """Which CUDA kernel a call takes is a rule of dtype, head dims and
    alignment (the rule reads only shapes and pointers, so CPU tensors
    show it): bf16 with head dims that are multiples of 8 and 16-byte
    aligned bases goes to the tensor cores, everything else to FFMA."""
    from repro_torch.kernels import flash_attention as fa

    def qkv(d, dtype, dv=None, offset=0):
        buf = torch.zeros(offset + 2 * 8 * 4 * d, dtype=dtype)
        q = buf[offset:].view(2, 8, 4, d)
        k = torch.zeros(2, 8, 2, d, dtype=dtype)
        return q, k, torch.zeros(2, 8, 2, dv or d, dtype=dtype)

    assert fa.variant(*qkv(120, torch.bfloat16)) == fa.TC
    assert fa.variant(*qkv(64, torch.bfloat16, dv=128)) == fa.TC
    assert fa.variant(*qkv(120, torch.float32)) == fa.FFMA
    assert fa.variant(*qkv(36, torch.bfloat16)) == fa.FFMA
    assert fa.variant(*qkv(64, torch.bfloat16, dv=60)) == fa.FFMA
    assert fa.variant(*qkv(64, torch.bfloat16, offset=1)) == fa.FFMA
