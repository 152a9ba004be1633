"""The port's partition rules against the reference's, in process (no
ranks).

The reference's ``spec_for``, ``param_specs`` and ``cache_specs`` read
only ``mesh.shape``, so a stub with a ``shape`` dict stands in for a JAX
mesh, and the port's functions read the same dict.  For every arch of
the registry at smoke size, on meshes (2, 4), (4, 2), (1, 8) and the
multi-pod axes with and without ``shard_params_over_pod``, the port's
spec of each parameter equals the reference's spec of the stacked leaf
it comes from (without the leading repeat entry), and likewise every
cache leaf's.  ``PARAM_RULES`` are the reference's, byte for byte.
"""

import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.parallel import sharding as ref_sh
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model, init_caches
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass
class StubMesh:
    shape: dict


MESHES = {
    "2x4": ({"data": 2, "model": 4}, {}),
    "4x2": ({"data": 4, "model": 2}, {}),
    "1x8": ({"data": 1, "model": 8}, {}),
    "pod": ({"pod": 2, "data": 2, "model": 4}, {"pod": "pod"}),
    "pod-zero": ({"pod": 2, "data": 4, "model": 2},
                 {"pod": "pod", "shard_params_over_pod": True}),
}


def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def test_rules_are_the_references():
    assert [(pat, [tuple(c) if c is not None else None for c in cands])
            for pat, cands in sh.PARAM_RULES] == \
        [(pat, [tuple(c) if c is not None else None for c in cands])
         for pat, cands in ref_sh.PARAM_RULES]
    assert sh.MeshAxes(pod="pod", shard_params_over_pod=True).fsdp_axes \
        == ref_sh.MeshAxes(pod="pod", shard_params_over_pod=True).fsdp_axes
    assert sh.MeshAxes(pod="pod").dp_axes == ref_sh.MeshAxes(pod="pod").dp_axes


def _ref_path(name: str, cfg) -> str:
    """A port parameter name as the reference tree's path."""
    parts = name.split(".")
    if parts[0] == "stages":
        n = len(cfg.stages[int(parts[1])].pattern)
        return "/".join(["stages", parts[1], f"p{int(parts[2]) % n}"]
                        + parts[3:])
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "layers"] + parts[3:])
    return "/".join(parts)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_are_the_references(arch, mesh_name):
    shape, axes_kw = MESHES[mesh_name]
    mesh = StubMesh(shape)
    ref_cfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    abstract = jax.eval_shape(lambda k: ref_init_params(k, ref_cfg),
                              jax.random.PRNGKey(0))
    ref_specs = ref_sh.param_specs(abstract, mesh, ref_sh.MeshAxes(**axes_kw))
    paths = [ref_sh._path_str(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(abstract)[0]]
    specs = jax.tree.leaves(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = dict(zip(paths, map(_spec, specs)))
    model = Model(cfg, device="meta")
    got = sh.param_specs(model, mesh, sh.MeshAxes(**axes_kw))
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        path = _ref_path(name, cfg)
        stacked = path.startswith(("stages/", "encoder/layers/"))
        assert spec == (want[path][1:] if stacked else want[path]), name
    # every spec divides its parameter
    for n, p in model.named_parameters():
        for dim, e in zip(p.shape, got[n]):
            assert dim % sh._axis_size(mesh, e) == 0, (n, p.shape, got[n])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_are_the_references(arch, mesh_name):
    shape, axes_kw = MESHES[mesh_name]
    mesh = StubMesh(shape)
    ref_cfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    batch, max_len = 8, 32
    enc_len = cfg.n_frontend_tokens if cfg.encoder is not None else 0
    abstract = jax.eval_shape(lambda: ref_init_caches(
        ref_cfg, batch, max_len, enc_len=enc_len))
    ref_specs = ref_sh.cache_specs(abstract, mesh, ref_sh.MeshAxes(**axes_kw))
    caches = init_caches(cfg, batch, max_len, enc_len=enc_len,
                         dtype=torch.bfloat16, device="meta")
    got = sh.cache_specs(caches, mesh, sh.MeshAxes(**axes_kw))
    for si, stage in enumerate(cfg.stages):
        n = len(stage.pattern)
        for li in range(stage.repeat * n):
            ref_layer = ref_specs[si][f"p{li % n}"]
            assert set(got[si][li]) == set(ref_layer), (si, li)
            for part, leaves in got[si][li].items():
                assert set(leaves) == set(ref_layer[part])
                for leaf, spec in leaves.items():
                    assert spec == _spec(ref_layer[part][leaf])[1:], \
                        (si, li, part, leaf)


def test_logical_constraint_returns_its_input():
    x = torch.zeros(2, 3)
    assert sh.logical_constraint(x, ("data", None)) is x


def test_fft_mesh_axes_fold_the_pod_axis():
    from repro.launch.mesh import fft_mesh_axes as ref_fft_mesh_axes
    from repro_torch.launch.mesh import fft_mesh_axes

    class Named:
        def __init__(self, names):
            self.axis_names = names
    for names in (("data", "model"), ("pod", "data", "model")):
        assert fft_mesh_axes(Named(names)) == ref_fft_mesh_axes(Named(names))
