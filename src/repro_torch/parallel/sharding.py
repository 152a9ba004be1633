"""Name-based parameter sharding rules (t5x/MaxText-style partition rules).

Port of ``repro/parallel/sharding.py``.  Every parameter path is matched
against ordered regex rules; each rule lists candidate specs in
preference order and the first one whose sharded dims divide evenly is
taken (so e.g. Mixtral's 8-expert tensors fall back from expert-parallel
to per-expert tensor-parallel on a 16-way axis, and gemma3's 8 heads fall
back from head-sharding to head-dim-sharding).

Logical axes:  fsdp -> "data"   tp -> "model"   (pod stays a pure data axis
unless ``shard_params_over_pod`` — ZeRO across pods — is requested).

The port's layouts are tuples (``ROADMAP.md`` §3, "Layouts"): a spec is a
tuple with one entry per dim (None, an axis name, or a tuple of axis
names, major first), and a sharding is this rank's tuple of slices
(``core.decomposition.spec_slices``).  :func:`spec_for`, :func:`_resolve`
and :data:`PARAM_RULES` are the reference's, reading only ``mesh.shape``
(a dict of axis sizes, as ``core.mesh.Mesh.shape`` and
``jax.sharding.Mesh.shape`` both are).

The reference's parameter paths are its pytree's
(``stages/{s}/p{pi}/mixer/wq``, stacked on a leading repeat axis); the
port's names are ``Model.named_parameters()``'s (``stages.{s}.{l}.
mixer.wq``, one layer each).  :func:`ref_path` maps a name to the path
that the rules read (the rules match suffixes, so the pattern index is
left out: ``stages/{s}/mixer/wq``) and says whether the reference stacks
it; a stacked leaf's spec is the reference's without its leading None.

:func:`shard_model` turns a full model into this rank's blocks: the
Model on a mesh holds its blocks as its parameters and records each one's
global shape and spec (:class:`Layout`); ``models.model.forward``
gathers a layer's full weights just before the layer runs.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch
from torch import nn

from repro_torch.core.decomposition import spec_slices


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    fsdp: str = "data"
    tp: str = "model"
    pod: Optional[str] = None          # present on the multi-pod mesh
    shard_params_over_pod: bool = False

    @property
    def fsdp_axes(self):
        if self.pod is not None and self.shard_params_over_pod:
            return (self.pod, self.fsdp)
        return self.fsdp

    @property
    def dp_axes(self):
        """Batch axes (activations)."""
        return (self.pod, self.fsdp) if self.pod is not None else (self.fsdp,)


def mesh_axes(mesh) -> MeshAxes:
    """The axes of ``mesh``: the pod axis is in use exactly when the mesh
    has one (``launch.mesh.make_production_mesh(multi_pod=True)``).  The
    one place the port reads it from, so that a step's batch split
    (``train.train_step.make_shard_ctx``), its caches
    (``models.init_caches(mesh=)``) and its loss cannot disagree."""
    return MeshAxes(pod="pod" if "pod" in mesh.axis_names else None)


# Each entry: (path regex, [candidate spec templates]); templates use the
# placeholders "fsdp"/"tp"; None = replicated dim.  First divisible wins.
PARAM_RULES: list[tuple[str, list[tuple]]] = [
    # embeddings
    (r"embed/tok$", [("tp", "fsdp"), (None, "fsdp"), (None, None)]),
    (r"embed/head$", [("fsdp", "tp"), ("fsdp", None), (None, None)]),
    # attention (D, H, hd) / (H, hd, D)
    (r"(mixer|cross)/wq$", [("fsdp", "tp", None), ("fsdp", None, "tp"),
                            ("fsdp", None, None)]),
    (r"(mixer|cross)/wk$", [("fsdp", "tp", None), ("fsdp", None, "tp"),
                            ("fsdp", None, None)]),
    (r"(mixer|cross)/wv$", [("fsdp", "tp", None), ("fsdp", None, "tp"),
                            ("fsdp", None, None)]),
    (r"(mixer|cross)/wo$", [("tp", None, "fsdp"), (None, "tp", "fsdp"),
                            (None, None, "fsdp")]),
    # MLA
    (r"mixer/w_dkv$", [("fsdp", "tp"), ("fsdp", None)]),
    (r"mixer/w_dq$", [("fsdp", "tp"), ("fsdp", None)]),
    (r"mixer/w_uq$", [("fsdp", "tp", None), ("fsdp", None, "tp"),
                      ("fsdp", None, None)]),
    (r"mixer/w_uk$", [("fsdp", "tp", None), ("fsdp", None, "tp"),
                      ("fsdp", None, None)]),
    (r"mixer/w_uv$", [("fsdp", "tp", None), ("fsdp", None, "tp"),
                      ("fsdp", None, None)]),
    # MoE (E, D, F) — expert-parallel first, then intra-expert TP
    (r"ffn/w_gate$", [("tp", "fsdp", None), (None, "fsdp", "tp"),
                      ("fsdp", "tp"), ("fsdp", None)]),
    (r"ffn/w_up$", [("tp", "fsdp", None), (None, "fsdp", "tp"),
                    ("fsdp", "tp"), ("fsdp", None)]),
    (r"ffn/w_down$", [("tp", None, "fsdp"), (None, "tp", "fsdp"),
                      ("tp", "fsdp"), (None, "fsdp")]),
    (r"ffn/router$", [("fsdp", None)]),
    (r"ffn/shared/", [("fsdp", "tp"), ("tp", "fsdp"), ("fsdp", None)]),
    # dense ffn two-dim fallbacks are covered above (w_gate/w_up/w_down)
    (r"ffn/(w_k|w_r)$", [("fsdp", "tp"), ("fsdp", None)]),
    (r"ffn/w_v$", [("tp", "fsdp"), (None, "fsdp")]),
    (r"ffn/b_(up|down)$", [(None,)]),
    # RG-LRU
    (r"mixer/w_(in|gate)$", [("fsdp", "tp"), ("fsdp", None)]),
    (r"mixer/w_out$", [("tp", "fsdp"), (None, "fsdp")]),
    (r"mixer/w_(rg|ig)$", [("fsdp", "tp"), ("fsdp", None)]),
    (r"mixer/conv_w$", [(None, "tp"), (None, None)]),
    # RWKV-6
    (r"mixer/w_[rkvgo]$", [("fsdp", "tp"), ("fsdp", None)]),
    (r"mixer/lora_a$", [("fsdp", None)]),
    (r"mixer/lora_b$", [(None, None, "fsdp")]),
    (r"mixer/decay_a$", [("fsdp", None)]),
    (r"mixer/decay_b$", [(None, "fsdp")]),
    # small vectors: shard over fsdp when divisible, else replicate
    (r"(scale|bias|lam|b_rg|b_ig|mu_\w+|decay_base)$", [("fsdp",), (None,)]),
    (r"(bonus_u|ln_scale)$", [(None, None)]),
    (r".*", [None]),  # fallback: replicate
]


def _resolve(template, axes: MeshAxes) -> tuple:
    if template is None:
        return ()
    out = []
    for t in template:
        if t == "fsdp":
            out.append(axes.fsdp_axes)
        elif t == "tp":
            out.append(axes.tp)
        else:
            out.append(None)
    return tuple(out)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def _divisible(shape, spec: tuple, mesh) -> bool:
    for dim, entry in zip(shape, spec):
        if dim % _axis_size(mesh, entry):
            return False
    return True


def spec_for(path: str, shape, mesh, axes: MeshAxes, stacked: bool) -> tuple:
    """Resolve the spec for one parameter (``shape`` with the stacked
    repeat dim when ``stacked``, as in the reference)."""
    for pattern, candidates in PARAM_RULES:
        if re.search(pattern, path):
            for cand in candidates:
                spec = _resolve(cand, axes)
                core = shape[1:] if stacked else shape
                if len(spec) not in (0, len(core)):
                    continue
                padded = tuple(list(spec) + [None] * (len(core) - len(spec)))
                if _divisible(core, padded, mesh):
                    return (None, *padded) if stacked else padded
            break
    return tuple([None] * len(shape))


def ref_path(name: str) -> tuple:
    """(the reference's path for the rules, whether it stacks the leaf)
    for a port parameter name: ``stages.{s}.{l}.rest`` ->
    ``stages/{s}/rest`` and ``encoder.layers.{t}.rest`` ->
    ``encoder/layers/rest`` (stacked), anything else with ``/`` for
    ``.``."""
    parts = name.split(".")
    if parts[0] == "stages":
        return "/".join(["stages", parts[1]] + parts[3:]), True
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "layers"] + parts[3:]), True
    return "/".join(parts), False


def _named_shapes(params) -> dict:
    """{name: global shape} of a Model (its :class:`Layout`'s shapes when
    it holds blocks) or of a {name: tensor or shape} dict."""
    if isinstance(params, nn.Module):
        layout = getattr(params, "layout", None)
        if layout is not None:
            return dict(layout.shapes)
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def param_specs(params, mesh, axes: MeshAxes) -> dict:
    """{parameter name: spec tuple} for a Model or a {name: tensor}
    dict.  Parameters under ``stages`` or ``encoder.layers`` are
    resolved as the reference's stacked leaves are, and their leading
    repeat dim (never sharded) is dropped."""
    out = {}
    for name, shape in _named_shapes(params).items():
        path, stacked = ref_path(name)
        if stacked:
            out[name] = spec_for(path, (1,) + shape, mesh, axes, True)[1:]
        else:
            out[name] = spec_for(path, shape, mesh, axes, False)
    return out


def param_shardings(params, mesh, axes: MeshAxes) -> dict:
    """{parameter name: this rank's tuple of slices} of each global
    parameter, by :func:`param_specs` (the reference's NamedShardings,
    as the port's per-rank slices)."""
    shapes = _named_shapes(params)
    return {n: spec_slices(s, shapes[n], mesh.shape, mesh.coords)
            for n, s in param_specs(params, mesh, axes).items()}


def shard_tensor(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` laid out by ``spec``, as a copy."""
    return mesh.block_of(full, spec).clone()


def cache_specs(caches, mesh, axes: MeshAxes):
    """Caches: batch -> dp axes, slot axis -> tp (the flash-decoding
    layout); the recurrent state is batch-sharded only, ``pos`` is
    replicated.  ``caches`` is ``models.init_caches``' structure (lists
    of per-layer dicts, any leaf with a ``shape``); the result has the
    same structure with a spec tuple at each leaf.  Each is the
    reference's spec of the stacked leaf without its leading None.

    Shapes: k/v (B, S, KV, hd); latent (B, S, R); pos (S,); recurrent
    state (B, ...).
    """
    dp = axes.dp_axes
    if len(dp) == 1:      # a PartitionSpec holds a 1-tuple as its name
        dp = dp[0]

    def one(name: str, shape) -> tuple:
        shape = (1,) + tuple(shape)        # the reference's stacked leaf
        if name == "pos":
            return (None,)
        if name in ("k", "v", "latent"):
            spec = [None, dp, axes.tp] + [None] * (len(shape) - 3)
        else:  # recurrent state h/conv/s/x_prev...
            spec = [None, dp] + [None] * (len(shape) - 2)
        # drop shardings that don't divide
        fixed = []
        for dim, entry in zip(shape, spec):
            fixed.append(entry if dim % _axis_size(mesh, entry) == 0 else None)
        return tuple(fixed[1:])

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return one(name, node.shape)

    return walk(caches)


def logical_constraint(x, spec):
    """The reference pins a GSPMD layout here
    (``with_sharding_constraint``).  A block-per-rank port has nothing to
    pin: every tensor a rank holds already is its block, laid out by the
    code that made it.  Returns ``x``."""
    del spec
    return x


# --------------------------------------------------------------------------
# the Model on a mesh: this rank's blocks
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Layout:
    """How a Model's parameters are laid out over ``mesh``: each name's
    global shape and spec.  The Model's parameters are this rank's
    blocks."""
    mesh: object
    specs: dict
    shapes: dict


def shard_model(model: nn.Module, mesh,
                axes: Optional[MeshAxes] = None) -> nn.Module:
    """Replace every parameter of the full ``model`` by this rank's block
    of it (a copy, by :func:`param_specs`), in place, and record the
    layout as ``model.layout``.  Returns the model."""
    if getattr(model, "layout", None) is not None:
        raise ValueError("the model already holds blocks")
    specs = param_specs(model, mesh, axes or MeshAxes())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for name, p in model.named_parameters():
        p.data = shard_tensor(p.data, specs[name], mesh)
    model.layout = Layout(mesh, specs, shapes)
    return model


def replicas(spec, mesh) -> int:
    """How many ranks hold each block of a parameter laid out by
    ``spec``."""
    return mesh.size // math.prod(_axis_size(mesh, e) for e in spec)
