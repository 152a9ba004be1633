"""Multi-pod dry run: prove the distribution config is coherent.

Port of ``repro/launch/dryrun.py``.  For every (architecture x input
shape) cell and for the paper's FFT grids, one step must run on the
single-pod 16x16 mesh AND the 2x16x16 multi-pod mesh; the run yields its
collectives, FLOPs and memory, the inputs of the roofline terms
(``launch.roofline.RooflineTerms``).

Where the reference compiles for 512 placeholder host devices, the port
runs the step itself, in one process, on nothing:

* the placeholder devices are a ``"fake"`` process group
  (``torch.testing._internal.distributed.fake_pg``): this process joins
  it as rank 0 of 256 or 512 ranks, and ``make_production_mesh`` builds
  the mesh over it.  Its collectives return at once and move nothing;
  ``Mesh.counting()`` counts what this rank hands them.  A process holds
  one world at a time, so each cell joins its own
  (:func:`fake_world`).  The module never joins a real group, and
  refuses to run inside one;
* ``jax.eval_shape`` plus lowering is a run under ``FakeTensorMode``:
  the real ``init_train_state(mesh=)`` or ``init_caches(mesh=)``, the
  real ``make_train_step(mesh=)`` or ``make_serve_steps(mesh=)``, and
  one step on fake inputs (:func:`input_specs`), allocating nothing.
  Fake tensors stay on the CPU device, so every kernel takes its plain
  version: the attention route is chosen by shapes alone, and the
  collectives do not depend on the device;
* the compiled artifact's ``cost_analysis`` is a count of the fake
  step's FLOPs by ``FlopCounterMode``'s formulas (matmuls and attention,
  :class:`_FlopCount`; an FFT cell's FLOPs and bytes
  are the tuner's model, ``cost_model.counted_collectives``), its
  ``memory_analysis`` the rank's argument and output bytes (the
  temporaries are not counted: :data:`TEMP_BYTES_WHY`), and its HLO
  collectives the counted ones.  The reference's ``bytes_per_device``
  (and with it ``memory_s`` and ``bottleneck``) is the compiled step's
  bytes accessed; the port's counts less (no activations, no
  temporaries on an LM cell), so every roofline record names its
  bytes in ``bytes_source``: :data:`LM_BYTES` or :data:`FFT_BYTES`.

The reference's ``lower_s``/``compile_s`` are one number here,
``count_s``: the host seconds of the fake run.  Results are cached as
JSON per cell under ``--out`` (re-runs skip finished cells; errors
retry).  The CLI exits 1 when any cell errors.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --fft
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED, FFT_SHAPES, SHAPES, get_config,
                                 shape_supported)
from repro_torch.core import Croft3D, Decomposition
from repro_torch.core.distributed import FFTOptions
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fft_mesh_axes, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.parallel import sharding as sh
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake ``world_size``-rank process group
    for the scope: every collective returns at once and moves nothing.
    Leaving it destroys every group made in it (a mesh's too).  Refuses
    to run when a process group is already initialized (a real world's
    collectives would reach real ranks)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run joins a fake process group of its "
                           "own: run it in a process that has none")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _FlopCount(TorchDispatchMode):
    """FLOPs of the matmuls and attention a scope dispatches, by torch's
    own formulas (``torch.utils.flop_counter.flop_registry``, those of
    ``FlopCounterMode``), in ``total``.  ``FlopCounterMode`` itself
    cannot count a train step: its module tracking hooks the backward,
    and those hooks refuse to run inside the step's
    ``torch.autograd.grad``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def fake_mode():
    """A ``FakeTensorMode`` for one cell: tensors made under it have a
    shape, a dtype and a device, and no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def input_specs(cfg, shape, mesh, multi_pod: bool, mode=None):
    """Fake stand-ins for every model input of one cell, this rank's
    block of each (made under ``mode``, a :func:`fake_mode`), and the
    reference's ``batch_spec``: the batch over the data axes when the
    global batch divides over them, else None (every rank the whole
    batch)."""
    axes = sh.MeshAxes(pod="pod" if multi_pod else None)
    dp = axes.dp_axes
    dp_size = math.prod(mesh.shape[a] for a in dp)
    gb = shape.global_batch
    batch_spec = dp if gb % dp_size == 0 else None
    if isinstance(batch_spec, tuple) and len(batch_spec) == 1:
        batch_spec = batch_spec[0]
    rows = gb // dp_size if batch_spec is not None else gb
    seq = {"train": shape.seq_len + 1, "prefill": shape.seq_len,
           "decode": 1}[shape.kind]
    mode = mode or fake_mode()
    out = {}
    with mode:
        out["tokens"] = torch.empty(rows, seq, dtype=torch.int32,
                                    device=mesh.device)
        if cfg.encoder is not None:
            out["frames"] = torch.empty(rows, cfg.n_frontend_tokens,
                                        cfg.d_model, device=mesh.device)
        elif cfg.frontend == "vision":
            out["prefix_embeds"] = torch.empty(
                rows, cfg.n_frontend_tokens, cfg.d_model, device=mesh.device)
    return out, batch_spec


def model_flops_for(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


# ``torch.distributed._tools.mem_tracker.MemTracker``, made for peak
# memory under fake tensors, cannot run these steps
# what a record's roofline ``bytes_per_device`` counts
LM_BYTES = "arguments+outputs"
FFT_BYTES = "cost_model"

TEMP_BYTES_WHY = (
    "not counted: MemTracker registers gradient hooks on the parameters "
    "of each module it enters, and the port's parameters take none: the "
    "fp32 masters never require grad (models.layers.master_param), and a "
    "train step's are compute-dtype casts, not leaves "
    "(train.train_step.compute_leaves)")


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

def count_lm_step(cfg, shape, mesh, kv_block: int,
                  opts: dict | None = None) -> dict:
    """One step of ``shape``'s kind (a ``configs.ShapeSpec``) of ``cfg``
    on ``mesh`` (any world, real or fake), run on fake tensors: this
    rank's ``collectives`` (``CollectiveCount.collectives``), its
    ``flops`` (:class:`_FlopCount`), its ``memory`` and the host seconds
    ``count_s``.

    ``memory``: ``argument_bytes`` (the rank's parameters, optimizer
    state or caches, and inputs), ``alias_bytes`` (the arguments the
    step writes in place: the train state, the caches), ``output_bytes``
    (the step's new outputs: metrics, logits); ``temp_bytes`` is None
    (:data:`TEMP_BYTES_WHY`)."""
    opts = opts or {}
    multi_pod = "pod" in mesh.axis_names
    axes = sh.mesh_axes(mesh)
    mode = fake_mode()
    inputs, _ = input_specs(cfg, shape, mesh, multi_pod, mode)
    gen = torch.Generator().manual_seed(0)
    t0 = time.time()
    with mode:
        if shape.kind == "train":
            opt_cfg = OptConfig(
                moment_dtype=opts.get("moment_dtype", "bfloat16"))
            state = ts.init_train_state(gen, cfg, opt_cfg, mesh=mesh,
                                        axes=axes)
            step_fn = ts.make_train_step(
                cfg, opt_cfg, mesh, shape.global_batch, kv_block=kv_block,
                remat_policy=opts.get("remat_policy", "nothing"))
            held = list(state["params"].parameters()) + [
                t for k, v in state["opt"].items() if k != "step"
                for t in _leaves(v)]

            def run():
                return step_fn(state, inputs)[1]
        else:
            # the port's prefill refuses a prompt its caches cannot hold:
            # a prefix-LM's caches hold the prefix too
            max_len = shape.seq_len + (cfg.n_frontend_tokens
                                       if cfg.prefix_lm else 0)
            model = sh.shard_model(model_lib.init_params(cfg, gen,
                                                         mesh.device),
                                   mesh, axes)
            ts.cast_to_compute(model, cfg.dtype)
            caches = model_lib.init_caches(
                cfg, shape.global_batch, max_len,
                enc_len=cfg.n_frontend_tokens if cfg.encoder else 0,
                dtype=torch.bfloat16, device=mesh.device, mesh=mesh)
            prefill_fn, decode_fn = ts.make_serve_steps(
                cfg, shape.global_batch, max_len, kv_block=kv_block,
                mesh=mesh)
            tok = inputs.pop("tokens")
            held = list(model.parameters()) + list(_leaves(caches))

            def run():
                if shape.kind == "prefill":
                    return prefill_fn(model, tok, caches, **inputs)[0]
                return decode_fn(model, tok, caches, shape.seq_len - 1)[0]
        args = held + list(_leaves(inputs))
        if shape.kind != "train":
            args.append(tok)
        with _FlopCount() as flops, mesh.counting() as count:
            out = run()
    return {
        "collectives": count.collectives,
        "flops": float(flops.total),
        "memory": {
            "argument_bytes": _nbytes(args),
            "alias_bytes": _nbytes(held),
            "output_bytes": _nbytes(_leaves(out)),
            "temp_bytes": None,
            "temp_bytes_why": TEMP_BYTES_WHY,
        },
        "count_s": time.time() - t0,
    }


def lower_lm_cell(arch: str, shape_name: str, multi_pod: bool,
                  kv_block: int = 0, opts: dict | None = None) -> dict:
    opts = opts or {}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if kv_block <= 0:
        # §Perf: single-block attention for 4k training (no scan stacking);
        # prefill keeps 2k blocks (score memory scales Sq_loc x kv_block)
        kv_block = shape.seq_len if shape.kind == "train" else 2048
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"status": "skip", "reason": why}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        got = count_lm_step(cfg, shape, mesh, kv_block, opts)
        mem = got["memory"]
        terms = rl.terms_from_count(
            got["collectives"], got["flops"],
            mem["argument_bytes"] + mem["output_bytes"],
            mesh.size, model_flops_for(cfg, shape))
        n_dev = mesh.size
    return {
        "status": "ok", "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev, "count_s": round(got["count_s"], 1),
        "roofline": {**terms.to_dict(), "bytes_source": LM_BYTES},
        "collectives": got["collectives"],
        "memory": mem, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(), "options": opts,
    }


# --------------------------------------------------------------------------
# FFT cells (the paper's own workload)
# --------------------------------------------------------------------------

def lower_fft_cell(grid_name: str, multi_pod: bool,
                   decomposition: str = "pencil",
                   opts: FFTOptions = FFTOptions()) -> dict:
    """One forward of a ``Croft3D`` plan of the grid on the production
    mesh, counted as the tuner counts it
    (``cost_model.counted_collectives``: the collectives on the wire,
    the analytic FLOPs and HBM bytes a rank)."""
    from repro_torch.tuning.cost_model import counted_collectives
    fshape = FFT_SHAPES[grid_name]
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n_dev = mesh.size
        if decomposition == "pencil":
            decomp = Decomposition("pencil", fft_mesh_axes(mesh))
        elif decomposition == "slab":
            decomp = Decomposition("slab", (tuple(mesh.axis_names),))
        else:
            names = mesh.axis_names  # cell needs 3 axes: only multi-pod
            if len(names) != 3:
                return {"status": "skip",
                        "reason": "cell needs a 3-axis mesh"}
            decomp = Decomposition("cell", tuple(names))
        t0 = time.time()
        with fake_mode():
            try:
                plan = Croft3D(fshape.grid, mesh, decomp, opts,
                               dtype=getattr(torch, fshape.dtype))
            except ValueError as e:
                return {"status": "skip", "reason": str(e)}
            got = counted_collectives(plan)
        t_count = time.time() - t0
    terms = rl.terms_from_count(got["collectives"], got["flops"],
                                got["bytes"], n_dev, plan.flops_model())
    return {
        "status": "ok", "arch": f"croft-{decomposition}",
        "shape": grid_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "n_devices": n_dev,
        "count_s": round(t_count, 1),
        "roofline": {**terms.to_dict(), "bytes_source": FFT_BYTES},
        "collectives": got["collectives"],
        "comm_model_bytes": plan.comm_bytes_model(),
        "options": dataclasses.asdict(opts),
    }


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def run_cell(name: str, fn, out_dir: str, force: bool) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "error":  # errors always retry
            print(f"[cached] {name}: {rec.get('status')}")
            return rec
    print(f"[run]    {name} ...", flush=True)
    try:
        rec = fn()
    except Exception as e:
        rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec.get("status")
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s"
                 f" coll={r['collective_s']:.4f}s -> {r['bottleneck']}"
                 f" (count {rec.get('count_s', '?')}s)")
    elif status == "error":
        extra = " " + rec["error"][:160]
    elif status == "skip":
        extra = " " + rec.get("reason", "")[:120]
    print(f"[done]   {name}: {status}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch or 'all'")
    ap.add_argument("--shape", default=None, help="one shape or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--fft", action="store_true", help="run FFT cells")
    ap.add_argument("--fft-grid", default="fft_1024")
    ap.add_argument("--fft-decomp", default="pencil")
    ap.add_argument("--all", action="store_true",
                    help="entire 40-cell LM matrix + FFT cells")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-block", type=int, default=0,
                    help="0 = per-shape heuristic")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records = []

    if args.fft or args.all:
        grids = list(FFT_SHAPES) if args.all else [args.fft_grid]
        decomps = (["pencil", "slab"] if args.all else [args.fft_decomp])
        for mp in meshes:
            for g in grids:
                for dec in decomps:
                    tag = f"fft-{g}-{dec}-{'mp' if mp else 'sp'}"
                    records.append(run_cell(
                        tag, lambda g=g, dec=dec, mp=mp: lower_fft_cell(
                            g, mp, dec), args.out, args.force))

    archs = []
    if args.all:
        archs = list(ASSIGNED)
    elif args.arch:
        archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = []
    if args.all:
        shapes = list(SHAPES)
    elif args.shape:
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if archs and not shapes:
        shapes = list(SHAPES)
    if shapes and not archs:
        archs = list(ASSIGNED)

    for mp in meshes:
        for a in archs:
            for s in shapes:
                tag = f"{a}-{s}-{'mp' if mp else 'sp'}"
                records.append(run_cell(
                    tag, lambda a=a, s=s, mp=mp: lower_lm_cell(
                        a, s, mp, kv_block=args.kv_block),
                    args.out, args.force))

    n_ok = sum(r.get("status") == "ok" for r in records)
    n_skip = sum(r.get("status") == "skip" for r in records)
    n_err = sum(r.get("status") == "error" for r in records)
    print(f"\n=== dry-run summary: {n_ok} ok, {n_skip} skip, {n_err} error ===")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
