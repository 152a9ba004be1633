"""Chunked fused softmax-cross-entropy.

Port of ``repro/parallel/loss.py``.  The (B, S, vocab) logits are never
held at once: the sequence is cut into ``n_chunks`` chunks, and each
chunk's float32 logits live only inside its own step.  Under autograd
every chunk runs in ``torch.utils.checkpoint``, so its logits are
recomputed in the backward instead of kept: the peak stays one chunk's
logits (gemma3's vocabulary is 262144).

On a mesh (``axes``) ``hidden`` and ``labels`` are this rank's block of
the batch and sequence, and the head is whole (the reference keeps the
(B, S) token structure sharded and psums each chunk over the vocab
shards; a block-per-rank port sums once).  Each rank sums its block's
token losses and valid counts, and one counted all-reduce over the
mesh forms the global mean.  The loss's value is that mean on every
rank; its gradient is this rank's share (its own tokens' losses over
the global count), so the ranks' gradients sum to the mean's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import MeshAxes


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
                          axes: Optional[MeshAxes] = None,
                          softcap: float = 0.0, z_loss: float = 0.0,
                          label_smoothing: float = 0.0, mesh=None,
                          over=None):
    """hidden (B,S,D), labels (B,S) -> (mean_nll, metrics dict).

    ``head_w`` (D, V).  Ignores label == -1 (padding).  Metrics: ``nll``,
    ``n_tokens`` (int32) and ``accuracy``, as tensors.

    ``axes`` switches the sharded loss on; it then needs ``mesh`` (the
    port's: the block-per-rank mesh whose collectives sum) and ``over``,
    the axes whose ranks hold disjoint blocks of the tokens
    (``models.model.grad_axes`` of the pass's context; ``()`` when every
    rank holds them all).  ``hidden`` and ``labels`` are this rank's
    block, and the sums are all-reduced over ``over``.  A rank's block
    may be empty (S 0).
    """
    s = hidden.shape[1]
    nc = min(n_chunks, s)
    while nc and s % nc:
        nc -= 1
    sc = s // nc if nc else 0
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or head_w.requires_grad)
    nll_sum = z_sum = 0.0
    cnt = correct = 0
    if nc == 0:        # an empty block: zero sums, still in the graph
        nll_sum = z_sum = hidden.sum() * 0.0 + head_w.sum() * 0.0
        cnt = correct = torch.zeros((), dtype=torch.int32,
                                    device=hidden.device)
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
    if axes is not None:
        if mesh is None or over is None:
            raise ValueError("a sharded loss (axes) needs the mesh and "
                             "the axes its token blocks split over")
        from repro_torch.core.mesh import axis_arg
        over = axis_arg(over)
        local = torch.stack([nll_sum.detach().float(), z_sum.detach().float(),
                             cnt.float(), correct.float()])
        tot = local if over is None else mesh.all_reduce(local, over).wait()
        denom = torch.clamp(tot[2], min=1.0)
        loss = nll_sum / denom
        value = tot[0] / denom
        if z_loss:
            loss = loss + z_loss * z_sum / denom
            value = value + z_loss * tot[1] / denom
        loss = loss + (value - loss).detach()
        metrics = {"nll": (tot[0] / denom).detach(),
                   "n_tokens": tot[2].round().to(torch.int32),
                   "accuracy": tot[3] / denom}
        return loss, metrics
    denom = torch.clamp(cnt, min=1).to(torch.float32)
    loss = nll_sum / denom
    if z_loss:
        loss = loss + z_loss * z_sum / denom
    metrics = {"nll": (nll_sum / denom).detach(), "n_tokens": cnt,
               "accuracy": correct / denom}
    return loss, metrics
