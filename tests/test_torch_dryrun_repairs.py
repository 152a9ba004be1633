"""What the dry run needed of the port's code, on the CPU.

* ``Mesh.rank_coords`` is a table made once, at construction: it equals
  the per-call value the mesh used to compute from its device-mesh
  tensor (one rank at a time), on (2, 2), (2, 2, 2) and (1, 4) meshes,
  and so do ``members``.  The meshes are built over fake process groups
  in a subprocess (one world a process).
* ``Mesh._move`` packs and unpacks by a per-rank plan
  (``_MovePlan``): a block cut into a regular grid of pieces moves as
  one permuted copy, one piece sent to many ranks as one expanded copy.
  Each recipe equals the piece-by-piece slices it replaces, on links in
  row-major and in other orders, with leading dims.
* The initializers only shape a tensor that has no values (fake or
  meta): every arch's smoke model builds under ``FakeTensorMode``, and
  on the CPU a seeded draw is bit-equal to ``nn.init.trunc_normal_``'s,
  model by model.
* The FFT plan's constants are cached only when they hold values: a
  forward under ``FakeTensorMode`` leaves the cache as it was.  A fake
  round trip of the default plan counts what a real one does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import SRC
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core import local_fft
from repro_torch.core import plan as plan_lib
from repro_torch.core.mesh import _MovePlan, _tiling
from repro_torch.device import has_values
from repro_torch.models import init_params
from repro_torch.models import layers as L

COORDS = r"""
import itertools, json, math, sys
from repro_torch.core import make_mesh
from repro_torch.launch.dryrun import fake_world
out = {}
for shape, names in (((2, 2), ("data", "model")),
                     ((2, 2, 2), ("pod", "data", "model")),
                     ((1, 4), ("data", "model"))):
    with fake_world(math.prod(shape)):
        mesh = make_mesh(shape, names, device="cpu")
        grid = mesh.device_mesh.mesh
        old = [None] * mesh.size
        for idx in itertools.product(*(range(n) for n in grid.shape)):
            old[int(grid[idx])] = dict(zip(names, idx))
        members = {}
        for a in names:
            members[a] = mesh.members(a)
        members["fold"] = mesh.members(tuple(names[-2:]))
        out[str(shape)] = dict(new=mesh.rank_coords(), old=old,
                               members=members, coords=mesh.coords)
        mesh.close()
json.dump(out, open(sys.argv[1], "w"))
"""


def test_rank_coords_equal_the_per_call_value(tmp_path):
    path = str(tmp_path / "coords.json")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", COORDS, path], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.load(open(path))
    assert set(got) == {"(2, 2)", "(2, 2, 2)", "(1, 4)"}
    for shape, rec in got.items():
        assert rec["new"] == rec["old"], shape
        assert rec["new"][0] == rec["coords"]           # this process: rank 0
        names = list(rec["coords"])
        for a in names:
            line = [r for r, c in enumerate(rec["old"])
                    if all(c[b] == 0 for b in names if b != a)]
            assert rec["members"][a] == line, (shape, a)
        fold = [r for r, c in enumerate(rec["old"])
                if all(c[b] == 0 for b in names[:-2])]
        assert rec["members"]["fold"] == fold, shape


def _links(boxes):
    """Links whose source side (and destination side) are ``boxes``."""
    return [[(b, b) for b in box] for box in boxes]


def _grid_boxes(extents, counts):
    steps = [e // c for e, c in zip(extents, counts)]
    out = []
    for idx in np.ndindex(*counts):
        out.append(tuple(slice(i * s, (i + 1) * s)
                         for i, s in zip(idx, steps)))
    return out


@pytest.mark.parametrize("order", ["row-major", "shuffled"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_move_plan_tiles_equal_their_pieces(order, lead):
    extents, counts = (4, 6, 8), (2, 3, 2)
    boxes = _grid_boxes(extents, counts)
    if order == "shuffled":
        boxes = [boxes[i] for i in np.random.RandomState(0).permutation(
            len(boxes))]
    assert _tiling(boxes, extents) is not None
    blk = torch.randn(lead + extents)
    plan = _MovePlan(lead, _links(boxes), _links(boxes), lead + extents, 0)
    want = torch.cat([blk[(Ellipsis,) + b].reshape(-1) for b in boxes])
    assert torch.equal(plan.pack(blk), want)
    back = plan.unpack(want, blk)
    assert torch.equal(back, blk)
    assert plan.send_sizes == [want.numel() // len(boxes)] * len(boxes)


@pytest.mark.parametrize("boxes,want", [
    ([(slice(0, 2), slice(0, 1))], [1.0, 5.0]),
    ([(slice(0, 1), slice(0, 1)), (slice(1, 2), slice(0, 1))], [1.0, 5.0]),
    ([(slice(0, 1), slice(0, 1))] * 4, [1.0] * 4)])
def test_move_plan_packs_a_strided_block_contiguous(boxes, want):
    """A column of a wider tensor (a token's rows), one element sent to
    four ranks among them: the send buffer is contiguous, as
    ``all_to_all_single`` requires."""
    blk = torch.arange(8.0).reshape(2, 4)[:, 1:2]
    assert not blk.is_contiguous()
    plan = _MovePlan((), _links(boxes), _links(boxes[:1]), (2, 1), 0)
    send = plan.pack(blk)
    assert send.is_contiguous()
    assert send.tolist() == want


def test_move_plan_repeats_one_piece():
    blk = torch.randn(2, 4, 6)
    box = (slice(1, 3), slice(0, 6))
    plan = _MovePlan((2,), _links([box] * 5), _links([box]), (2, 2, 6), 0)
    piece = blk[(Ellipsis,) + box].reshape(-1)
    assert torch.equal(plan.pack(blk), piece.repeat(5))
    assert plan.sent == 4 * piece.numel()       # rank 0 keeps its own


def test_move_plan_irregular_links_take_pieces():
    boxes = [(slice(0, 1),), (slice(1, 4),)]       # unequal: no grid
    assert _tiling(boxes, (4,)) is None
    blk = torch.randn(4)
    plan = _MovePlan((), _links(boxes), _links(boxes), (4,), 1)
    assert torch.equal(plan.pack(blk), blk)
    assert torch.equal(plan.unpack(blk.clone(), blk), blk)
    assert plan.sent == 1


def test_initializers_only_shape_fake_tensors():
    gen = torch.Generator().manual_seed(0)
    with FakeTensorMode():
        for arch in ASSIGNED:
            model = init_params(get_config(arch, smoke=True), gen, "cpu")
            assert all(not has_values(p) for p in model.parameters())
    meta = torch.empty(3, 4, device="meta")
    assert L.truncated_normal_(meta, 0.5) is meta


@pytest.mark.parametrize("arch", ASSIGNED)
def test_seeded_draws_are_unchanged(arch, monkeypatch):
    cfg = get_config(arch, smoke=True)
    got = init_params(cfg, torch.Generator().manual_seed(3), "cpu")

    def before(t, std, generator=None):
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)
    for mod in ("attention", "layers", "moe", "recurrent"):
        monkeypatch.setattr(f"repro_torch.models.{mod}.truncated_normal_",
                            before)
    want = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (n, a), (_, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        assert torch.equal(a, b), n


def test_fft_constants_are_not_cached_from_fake_tensors():
    plan = plan_lib.make_plan(256, -1, "complex64", plan_lib.MAX_RADIX)
    plan._on_device.clear()
    with FakeTensorMode():
        x = torch.zeros(4, 256, dtype=torch.complex64)
        local_fft.fft_matmul(x)
    assert not plan._on_device
    x = torch.randn(4, 256, dtype=torch.complex64)
    y = local_fft.fft_matmul(x)
    assert torch.allclose(y, torch.fft.fft(x), atol=1e-3)
    assert all(has_values(t) for t in plan._on_device[torch.device("cpu")]
               if t is not None)


@pytest.mark.parametrize("shape", [(128, 8, 128), (16, 256, 32)])
def test_default_plan_dry_run_counts_what_a_real_run_does(shape):
    """``Croft3D(shape)`` with ``FFTOptions()`` (the matmul local FFT) on
    fake tensors: the same DFT products, layout copies and matmul FLOPs
    (the dry run's own count, ``launch.dryrun._FlopCount``) as a round
    trip on real ones, and the same output, less its values."""
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.launch.dryrun import _FlopCount
    from repro_torch.obs import metrics

    def counts(x):
        reg = metrics.get_registry()
        names = (local_fft.DFT_PRODUCTS, local_fft.LAYOUT_COPIES)
        before = [getattr(reg.get(k), "value", 0.0) for k in names]
        plan = Croft3D(shape, opts=FFTOptions(), device="cpu")
        with torch.no_grad(), _FlopCount() as flops:
            y = plan.inverse(plan.forward(x))
        after = [getattr(reg.get(k), "value", 0.0) for k in names]
        got = [a - b for a, b in zip(after, before)]
        return (y.shape, y.dtype, *got, flops.total)

    # fake first, as in the dry run's own process: the plans' cached
    # constants are real tensors, which a fake mode refuses
    plan_lib.clear_plan_cache()
    with FakeTensorMode():
        fake = counts(torch.empty(shape, dtype=torch.complex64))
    real = counts(torch.randn(shape, dtype=torch.complex64))
    assert fake == real
    assert real[2] == 2 * sum(1 if n <= 64 else 2 for n in shape)
    assert real[3] == 0 and real[4] > 0
