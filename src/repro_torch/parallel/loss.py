"""Chunked fused softmax-cross-entropy.

Port of ``repro/parallel/loss.py``, meshless.  The (B, S, vocab) logits
are never held at once: the sequence is cut into ``n_chunks`` chunks, and
each chunk's float32 logits live only inside its own step.  Under
autograd every chunk runs in ``torch.utils.checkpoint``, so its logits
are recomputed in the backward instead of kept: the peak stays one
chunk's logits (gemma3's vocabulary is 262144).  The sharded form
(``axes``, the reference's vocab-over-``model`` layout) waits for
``ROADMAP.md`` queue 1 item 8e.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _chunk(xi, yi, head_w, softcap: float, label_smoothing: float):
    """One chunk -> (sum of nll, sum of lse^2 over valid labels, valid
    count, correct count)."""
    logits = (xi @ head_w).float()                          # (B, Sc, V)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    lse = torch.logsumexp(logits, dim=-1)
    valid = yi >= 0
    index = torch.where(valid, yi, 0).long()[..., None]
    lab_logit = torch.gather(logits, -1, index)[..., 0]
    lab_logit = torch.where(valid, lab_logit, 0.0)
    nll = lse - lab_logit
    if label_smoothing:
        mean_logit = logits.mean(-1)
        nll = (1 - label_smoothing) * nll \
            + label_smoothing * (lse - mean_logit)
    nll = torch.where(valid, nll, 0.0)
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum(valid & (pred == yi)).to(torch.int32)
    z = torch.where(valid, lse, 0.0)
    return (nll.sum(), z.square().sum(), valid.sum().to(torch.int32),
            correct)


def chunked_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                          head_w: torch.Tensor, *, n_chunks: int = 8,
                          axes: Optional[object] = None,
                          softcap: float = 0.0, z_loss: float = 0.0,
                          label_smoothing: float = 0.0):
    """hidden (B,S,D), labels (B,S) -> (mean_nll, metrics dict).

    ``head_w`` (D, V).  Ignores label == -1 (padding).  Metrics: ``nll``,
    ``n_tokens`` (int32) and ``accuracy``, as tensors.
    """
    if axes is not None:
        raise NotImplementedError(
            "the sharded loss (axes): ROADMAP.md queue 1 item 8e")
    s = hidden.shape[1]
    nc = min(n_chunks, s)
    while s % nc:
        nc -= 1
    sc = s // nc
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or head_w.requires_grad)
    nll_sum = z_sum = 0.0
    cnt = correct = 0
    for ci in range(nc):
        args = (hidden[:, ci * sc:(ci + 1) * sc],
                labels[:, ci * sc:(ci + 1) * sc], head_w, softcap,
                label_smoothing)
        if remat:
            out = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            out = _chunk(*args)
        nll_sum = nll_sum + out[0]
        z_sum = z_sum + out[1]
        cnt = cnt + out[2]
        correct = correct + out[3]
    denom = torch.clamp(cnt, min=1).to(torch.float32)
    loss = nll_sum / denom
    if z_loss:
        loss = loss + z_loss * z_sum / denom
    metrics = {"nll": (nll_sum / denom).detach(), "n_tokens": cnt,
               "accuracy": correct / denom}
    return loss, metrics
