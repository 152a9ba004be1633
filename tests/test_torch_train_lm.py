"""The port's LM loss and its gradients against the JAX package, on the
CPU: ``train_step.loss_fn`` differentiated with respect to the
compute-dtype leaves (``value_and_grad``, the train step's own path)
against ``jax.value_and_grad`` of the reference's ``loss_fn``, float32,
at the smoke configs of the dense attention archs (window, softcap and
tied head, head_dim 256, the encoder and its frames, the prefix-LM and
its patches; the MoE and recurrent archs are in
``test_torch_train_moe.py`` and ``test_torch_train_recurrent.py``).  The
loss within 2e-4 relative, each gradient leaf within ``1e-4·max|ref|``.  Then the training route: a grad-taking pass reaches
``blockwise_attention`` and never the forward-only ``flash_attention``,
while a no-grad pass at position 0 still reaches the kernel (its plain
version on the CPU); and remat (per layer, per kv block, both policies)
changes no value.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import forward
from repro_torch.train.train_step import loss_fn, value_and_grad

from torch_train_cases import (KV_BLOCK, N_CHUNKS, check_loss_and_grads,
                               lm_batch, pair)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "yi-9b", "yi-34b",
                                  "gemma3-4b", "whisper-base",
                                  "paligemma-3b"])
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


def _counting(monkeypatch):
    calls = {"flash": 0, "blockwise": 0}
    real_flash, real_block = (attn_mod.flash_attention,
                              attn_mod.blockwise_attention)

    def flash(*a, **kw):
        calls["flash"] += 1
        return real_flash(*a, **kw)

    def block(*a, **kw):
        calls["blockwise"] += 1
        return real_block(*a, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", flash)
    monkeypatch.setattr(attn_mod, "blockwise_attention", block)
    return calls


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "whisper-base"])
def test_grad_pass_never_reaches_flash_attention(monkeypatch, arch):
    """The train step's pass (leaves requiring grad, remat on) runs every
    self-attention on the blockwise core, forward and recompute; the
    same pass under no_grad calls the kernel once a self-attention layer
    (whisper: the encoder's and the decoder's)."""
    calls = _counting(monkeypatch)
    _, _, cfg, model = pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()}
    value_and_grad(model, cfg, batch, kv_block=KV_BLOCK,
                   n_loss_chunks=N_CHUNKS)
    n_self = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
    assert calls["flash"] == 0
    assert calls["blockwise"] >= n_self
    calls.update(flash=0, blockwise=0)
    with torch.no_grad():
        loss_fn(model, cfg, batch, kv_block=KV_BLOCK,
                n_loss_chunks=N_CHUNKS)
    assert calls["flash"] == n_self
    cross = cfg.n_layers if cfg.encoder else 0
    assert calls["blockwise"] == cross


def _masters_grads(model, cfg, tokens, **kw):
    """Gradients of sum(hidden^2) with respect to the masters, which this
    test alone sets to require grad."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    hidden, _, _ = forward(model, cfg, tokens, mode="train",
                           kv_block=KV_BLOCK, return_hidden=True, **kw)
    hidden.square().sum().backward()
    out = {k: p.grad.clone() for k, p in params.items()
           if p.grad is not None}
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return hidden.detach(), out


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b", "rwkv6-3b"])
def test_remat_changes_no_value(arch):
    """Per-layer remat (both policies) and the per-kv-block remat inside
    it give the values and gradients of the pass without remat."""
    _, _, cfg, model = pair(arch, capacity=16.0)
    tokens = torch.from_numpy(lm_batch(cfg)["tokens"][:, :-1])
    want_h, want = _masters_grads(model, cfg, tokens, remat=False)
    for policy in ("nothing", "dots"):
        h, got = _masters_grads(model, cfg, tokens, remat=True,
                                remat_policy=policy)
        torch.testing.assert_close(h, want_h, rtol=1e-6, atol=0)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, msg=k)


def test_blockwise_remat_step_gradients_equal():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((2, 24, 4, 8), (2, 24, 2, 8), (2, 24, 2, 8)))
    pos = torch.arange(24, dtype=torch.int32)
    ms = attn_mod.MaskSpec(causal=True, window=10)
    grads = []
    for remat in (False, True):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn_mod.blockwise_attention(*xs, ms, pos, pos, kv_block=8,
                                           remat_step=remat)
        out.square().sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_rwkv_scan_same_values_with_and_without_grad():
    """The scan's in-place chain (no grad) and its out-of-place form
    (under autograd) compute the same values."""
    from repro_torch.models.recurrent import matrix_recurrence
    rng = np.random.RandomState(3)
    b, t, h, kd = 2, 16, 2, 4
    lw = -torch.from_numpy(np.abs(rng.randn(b, t, h, kd)).astype(np.float32))
    k, v, r = (torch.from_numpy(rng.randn(b, t, h, kd).astype(np.float32))
               for _ in range(3))
    u = torch.from_numpy(rng.randn(h, kd).astype(np.float32))
    s0 = torch.zeros(b, h, kd, kd)
    with torch.no_grad():
        o_ng, s_ng = matrix_recurrence(lw, k, v, r, u, s0, chunk=8)
    kk = k.clone().requires_grad_()
    o, s = matrix_recurrence(lw, kk, v, r, u, s0, chunk=8)
    o.sum().backward()
    assert torch.equal(o.detach(), o_ng) and torch.equal(s.detach(), s_ng)
    assert torch.isfinite(kk.grad).all()
