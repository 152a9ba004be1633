"""Carry the JAX package's parameter tree across to the port's modules.

The reference (``repro/models/model.py:init_params``) keeps each stage's
layers stacked on a leading repeat axis under ``stages[si]["p{pi}"]``;
:func:`params_from_numpy` unstacks them into ``Model.stages[si]``, layer
``t * len(pattern) + pi`` taking index ``t``; an encoder-decoder's
``encoder.layers``, stacked on a leading ``n_layers`` axis, go to
``Model.encoder.layers[t]`` the same way.  Values stay float32 (the
masters).  The tree's leaves are numpy arrays (``jax.tree.map(np.asarray,
params)`` on the reference side), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def load_tree(module: nn.Module, tree: dict, what: str, index=None) -> None:
    """Copy ``tree``'s leaves (``[index]`` of each, when given) into the
    module's parameters of the same dotted names; the two name sets must
    be equal."""
    leaves = _leaves(tree)
    params = dict(module.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(f"{what}: the tree has {sorted(leaves)}, the module "
                         f"{sorted(params)}")
    for name, p in params.items():
        arr = np.asarray(leaves[name], dtype=np.float32)
        if index is not None:
            arr = arr[index]
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{what}.{name}: shape {arr.shape}, expected "
                             f"{tuple(p.shape)}")
        p.data.copy_(torch.from_numpy(np.array(arr)))  # a writable copy


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """The reference's ``init_params`` tree (numpy leaves) as a
    :class:`Model` on ``device`` (default: the current CUDA card)."""
    model = Model(cfg, device="meta").to_empty(device=resolve_device(device))
    load_tree(model.embed, tree["embed"], "embed")
    load_tree(model.final_norm, tree["final_norm"], "final_norm")
    if len(tree["stages"]) != len(cfg.stages):
        raise ValueError(f"{len(tree['stages'])} stages in the tree, "
                         f"{len(cfg.stages)} in the config")
    for si, stage in enumerate(cfg.stages):
        n = len(stage.pattern)
        for pi in range(n):
            for t in range(stage.repeat):
                load_tree(model.stages[si][t * n + pi],
                          tree["stages"][si][f"p{pi}"],
                          f"stages[{si}].p{pi}[{t}]", index=t)
    if ("encoder" in tree) != (cfg.encoder is not None):
        raise ValueError(f"encoder: in the tree {'encoder' in tree}, in "
                         f"the config {cfg.encoder is not None}")
    if cfg.encoder is not None:
        enc = tree["encoder"]
        for t in range(cfg.encoder.n_layers):
            load_tree(model.encoder.layers[t], enc["layers"],
                      f"encoder.layers[{t}]", index=t)
        load_tree(model.encoder.final_norm, enc["final_norm"],
                  "encoder.final_norm")
    return model


def named_from_numpy(tree: dict, cfg: ModelConfig) -> dict:
    """A tree shaped like the reference's ``init_params`` (its parameters,
    gradients or moments) as {port parameter name: array}, in
    ``Model.named_parameters()`` order, each stacked leaf unstacked as
    :func:`params_from_numpy` does.  Dtypes are kept."""
    out = {}

    def put(prefix: str, sub: dict, index=None) -> None:
        for name, arr in _leaves(sub).items():
            arr = np.asarray(arr)
            out[f"{prefix}.{name}"] = arr if index is None else arr[index]

    put("embed", tree["embed"])
    put("final_norm", tree["final_norm"])
    for si, stage in enumerate(cfg.stages):
        n = len(stage.pattern)
        for pi in range(n):
            for t in range(stage.repeat):
                put(f"stages.{si}.{t * n + pi}", tree["stages"][si][f"p{pi}"],
                    t)
    if cfg.encoder is not None:
        for t in range(cfg.encoder.n_layers):
            put(f"encoder.layers.{t}", tree["encoder"]["layers"], t)
        put("encoder.final_norm", tree["encoder"]["final_norm"])
    names = [n for n, _ in Model(cfg, device="meta").named_parameters()]
    if set(names) != set(out):
        raise ValueError(f"the tree has {sorted(set(out) - set(names))} "
                         f"beyond the model, lacks "
                         f"{sorted(set(names) - set(out))}")
    return {n: out[n] for n in names}


def opt_state_from_numpy(state: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``init_opt_state`` tree ({"m", "v", "step"}, numpy
    leaves) as the port's AdamW state (``train.optimizer``): moments keyed
    by parameter name in their stored dtype (bf16 moments stay bf16), the
    step an int32 scalar, on ``device`` (default: the CUDA card)."""
    from repro_torch.train.checkpoint import tensor_from_numpy
    dev = resolve_device(device)
    return {
        "m": {k: tensor_from_numpy(a, dev)
              for k, a in named_from_numpy(state["m"], cfg).items()},
        "v": {k: tensor_from_numpy(a, dev)
              for k, a in named_from_numpy(state["v"], cfg).items()},
        "step": torch.tensor(int(np.asarray(state["step"])),
                             dtype=torch.int32, device=dev),
    }
