"""The port's train step holds the reference's parameter layout, on the
CPU.

The reference keeps every stage layer's and encoder layer's leaves
stacked on a leading repeat axis (``repro/models/model.py:init_params``),
so a layer's norm scale, bias or token-shift ``mu`` is 2-D there, and its
ndim rules read that layout: weight decay (``_decay_mask``) applies to
it, and its train step's ``cast_to_compute`` casts it to the compute
dtype.  The port unstacks those leaves; ``models.model.stacked_names``
names them, and the decay mask and the compute-dtype leaves count the
axis.  Checked for every arch of the registry against the reference's
own trees, then end to end: the masters and both moments after 3
``make_train_step`` steps from one converted state against the
reference's (float32).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro.train.train_step import cast_to_compute as ref_cast_to_compute
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.models.convert import named_from_numpy
from repro_torch.models.model import stacked_names
from repro_torch.train import optimizer
from repro_torch.train.train_step import compute_leaves

from torch_train_cases import trajectories

STATE_TOL = 1e-5     # masters and moments, relative to each leaf's max|ref|
# Adam's first updates are g / (|g| + eps): where a gradient is within
# rounding of zero its sign, and so that element's update, is not fixed
# by the two packages' agreement on the gradient.  Such elements may miss
# STATE_TOL, at most this share of a leaf's elements (none of a leaf under
# 1000 elements: every norm scale, bias and mu is held whole).
ILL_SHARE = 1e-3


def _pair(arch, dtype):
    """The reference's parameter shapes (``jax.eval_shape``) and the
    port's config and model, on the meta device: only shapes, dtypes and
    names are compared."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    ref_params = jax.eval_shape(lambda k: ref_init_params(k, ref_cfg),
                                jax.random.PRNGKey(0))
    return ref_params, cfg, Model(cfg, device="meta")


def _per_name(ref_params, values, cfg) -> dict:
    """A tree of one value per reference leaf as {port name: value}."""
    full = jax.tree.map(lambda p, v: np.full(p.shape, v), ref_params, values)
    out = {}
    for name, arr in named_from_numpy(full, cfg).items():
        assert len(np.unique(arr)) == 1, name
        out[name] = arr.flat[0]
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decay_mask_is_the_references(arch):
    ref_params, cfg, model = _pair(arch, "float32")
    want = _per_name(ref_params, ref_opt._decay_mask(ref_params), cfg)
    got = optimizer._decay_mask(dict(model.named_parameters()),
                                stacked_names(model))
    assert got == {k: bool(v) for k, v in want.items()}
    # a layer's 1-D leaves decay, the unstacked embedding's and final
    # norm's do not
    assert got["stages.0.0.ln1.scale"] and not got["final_norm.scale"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_compute_leaves_cast_as_the_reference(arch):
    ref_params, cfg, model = _pair(arch, "bfloat16")
    cast = jax.eval_shape(lambda p: ref_cast_to_compute(p, "bfloat16"),
                          ref_params)
    want = _per_name(ref_params, jax.tree.map(lambda p: str(p.dtype), cast),
                     cfg)
    got = {k: str(v.dtype).removeprefix("torch.")
           for k, v in compute_leaves(model, "bfloat16").items()}
    assert got == want
    assert all(v.requires_grad
               for v in compute_leaves(model, "bfloat16").values())


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "whisper-base"])
def test_masters_and_moments_after_steps_match_reference(arch):
    """3 steps at the trajectory tests' optimizer (weight decay 0.1):
    every leaf of ``m`` and ``v`` within STATE_TOL of max|ref|, and every
    master within it but for at most ILL_SHARE of a leaf's elements."""
    ref_losses, losses, ref, port, cfg = trajectories(
        arch, "float32", steps=3, states=True)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert int(port["opt"]["step"]) == int(ref["opt"]["step"]) == 3
    params = dict(port["params"].named_parameters())
    for what, got, tree in (("m", port["opt"]["m"], ref["opt"]["m"]),
                            ("v", port["opt"]["v"], ref["opt"]["v"]),
                            ("params", params, ref["params"])):
        want = named_from_numpy(tree, cfg)
        assert list(got) == list(want)
        for name, w in want.items():
            miss = (np.abs(got[name].numpy() - w)
                    > STATE_TOL * np.abs(w).max())
            allowed = int(ILL_SHARE * w.size) if what == "params" else 0
            assert miss.sum() <= allowed, (what, name, int(miss.sum()),
                                           w.size)
