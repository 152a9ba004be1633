"""Shared cases of the port's training tests (not a test module).

``pair`` builds the JAX reference's smoke config and parameters and the
port's model from the same tree (``params_from_numpy``); ``lm_batch``
makes one seeded numpy batch for both; ``check_loss_and_grads`` holds
the port's ``loss_fn`` value and its gradients (with respect to the
compute-dtype leaves, ``train_step.value_and_grad``) against
``jax.value_and_grad`` of the reference's ``loss_fn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models.config import Stage as RefStage
from repro.train import loss_fn as ref_loss_fn
from repro_torch.configs import get_config
from repro_torch.models import Stage, params_from_numpy
from repro_torch.models.convert import named_from_numpy
from repro_torch.train.train_step import value_and_grad

LOSS_RTOL = 2e-4    # the loss, relative
GRAD_TOL = 1e-4     # each gradient leaf, relative to its max|ref|
KV_BLOCK = 16       # tests/test_models_smoke.py's kv_block
N_CHUNKS = 4


def with_capacity(cfg, factor, stage_cls):
    """``cfg`` with every MoE layer at capacity factor ``factor``."""
    stages = tuple(stage_cls(tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=factor)) if sp.moe else sp
        for sp in st.pattern), st.repeat) for st in cfg.stages)
    return dataclasses.replace(cfg, stages=stages)


def pair(arch, dtype="float32", capacity=None, seed=0):
    """(ref config, ref params, port config, port model) at the smoke
    size, in ``dtype``, MoE layers at ``capacity`` when given."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if capacity is not None:
        ref_cfg = with_capacity(ref_cfg, capacity, RefStage)
        cfg = with_capacity(cfg, capacity, Stage)
    ref_params = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                              device="cpu")
    return ref_cfg, ref_params, cfg, model


def lm_batch(cfg, b=2, s=32, seed=1) -> dict:
    """{"tokens" (b, s+1) int32, and the stub frames or patches}."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = rng.randn(b, cfg.n_frontend_tokens,
                                    cfg.d_model).astype(np.float32)
    elif cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.randn(b, cfg.n_frontend_tokens,
                                           cfg.d_model).astype(np.float32)
    return batch


def check_loss_and_grads(arch, capacity=None, **loss_kw):
    """Loss within 2e-4 relative, the aux loss, and every gradient leaf
    within 1e-4 of its max|ref|; float32.  Returns the port's metrics."""
    ref_cfg, ref_params, cfg, model = pair(arch, capacity=capacity)
    batch = lm_batch(cfg)
    (ref_loss, ref_met), ref_grads = jax.value_and_grad(
        ref_loss_fn, has_aux=True)(
            ref_params, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()},
            None, KV_BLOCK, N_CHUNKS)
    loss, metrics, grads = value_and_grad(
        model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        kv_block=KV_BLOCK, n_loss_chunks=N_CHUNKS, **loss_kw)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(ref_met["aux_loss"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    want = named_from_numpy(jax.tree.map(np.asarray, ref_grads), cfg)
    assert set(want) == set(grads)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)
    return metrics


TRAJ_F32_RTOL = 1e-4   # the loss trajectory, float32
TRAJ_BF16_RTOL = 5e-2  # bf16: the frameworks round and order differently


def trajectories(arch, dtype, steps=5, capacity=None, full_width=None,
                 opt=None, states=False):
    """The loss over ``steps`` train steps of both packages from one
    state (the reference's ``init_train_state``, carried across with
    ``params_from_numpy`` and ``opt_state_from_numpy``) on the same
    ``SyntheticDataset`` batches (the reference's smoke train test's
    optimizer, batch and sequence, ``tests/test_models_smoke.py:48``).
    ``full_width=(layers, vocab)``: the full config at its own width, cut
    to ``layers`` of its first pattern and a ``vocab``-token vocabulary,
    batch 2 x 64; ``opt`` overrides the optimizer's fields.  Returns
    (reference losses, port losses), and with ``states`` also (the
    reference's final state as numpy leaves, the port's final state, the
    port's config)."""
    from repro.train import OptConfig as RefOptConfig
    from repro.train import init_train_state as ref_init_train_state
    from repro.train import make_train_step as ref_make_train_step
    from repro.train.data import SyntheticDataset as RefDataset
    from repro_torch.models.convert import opt_state_from_numpy
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.data import SyntheticDataset

    smoke = full_width is None
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=smoke),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype=dtype)
    batch, seq = 4, 64
    if full_width is not None:
        layers, vocab = full_width
        ref_cfg, cfg = (dataclasses.replace(
            c, vocab=vocab, stages=(stage(c.stages[0].pattern, layers),))
            for c, stage in ((ref_cfg, RefStage), (cfg, Stage)))
        batch = 2
    if capacity is not None:
        ref_cfg = with_capacity(ref_cfg, capacity, RefStage)
        cfg = with_capacity(cfg, capacity, Stage)
    opt = {**dict(lr=1e-3, warmup_steps=2, decay_steps=10), **(opt or {})}
    ref_opt = RefOptConfig(**opt)
    state = ref_init_train_state(jax.random.PRNGKey(0), ref_cfg, ref_opt,
                                 mesh=None)
    host = jax.tree.map(np.asarray, state)
    ref_step = ref_make_train_step(ref_cfg, ref_opt, None, batch,
                                   kv_block=32, n_loss_chunks=4,
                                   donate=False)
    extra = None       # the stub frames or patches, as lm_batch draws
    if cfg.encoder is not None:
        extra = {"frames": ((cfg.n_frontend_tokens, cfg.d_model),
                            np.float32)}
    elif cfg.frontend == "vision":
        extra = {"prefix_embeds": ((cfg.n_frontend_tokens, cfg.d_model),
                                   np.float32)}
    ref_ds = RefDataset(ref_cfg.vocab, seq, batch, extra=extra)
    port = {"params": params_from_numpy(host["params"], cfg, device="cpu"),
            "opt": opt_state_from_numpy(host["opt"], cfg, device="cpu")}
    del host
    ref_losses = []
    for i in range(steps):
        state, m = ref_step(state, ref_ds.batch_at(i))
        ref_losses.append(float(m["loss"]))
    ref_final = jax.tree.map(np.asarray, state) if states else None
    del state, ref_step
    step = make_train_step(cfg, OptConfig(**opt), None, batch, kv_block=32,
                           n_loss_chunks=4)
    ds = SyntheticDataset(cfg.vocab, seq, batch, extra=extra)
    losses = []
    for i in range(steps):
        port, m = step(port, ds.batch_at(i))
        losses.append(float(m["loss"]))
    if states:
        return ref_losses, losses, ref_final, port, cfg
    return ref_losses, losses


def check_trajectory(arch, dtype, **kw):
    ref, got = trajectories(arch, dtype, **kw)
    tol = TRAJ_F32_RTOL if dtype == "float32" else TRAJ_BF16_RTOL
    np.testing.assert_allclose(got, ref, rtol=tol)
    assert all(np.isfinite(got))
    return got


if __name__ == "__main__":
    # The loss of both packages over 5 steps at an arch's full width, cut
    # in depth and vocabulary, bf16 with bf16 moments, batch 2 x 64, at
    # each learning rate given:
    #   PYTHONPATH=src python tests/torch_train_cases.py ARCH LAYERS VOCAB LR...
    import json
    import sys
    arch, layers, vocab, *lrs = sys.argv[1:]
    for lr in lrs:
        ref, got = trajectories(arch, "bfloat16",
                                full_width=(int(layers), int(vocab)),
                                opt={"lr": float(lr),
                                     "moment_dtype": "bfloat16"})
        print(json.dumps({"arch": arch, "layers": int(layers),
                          "vocab": int(vocab), "lr": float(lr),
                          "reference": ref, "port": got}), flush=True)
