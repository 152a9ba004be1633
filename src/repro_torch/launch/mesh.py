"""Mesh construction over the ``torch.distributed`` world.

Port of ``repro/launch/mesh.py``.  A function, never a module-level
constant, so importing this module touches no process group; the caller
runs ``torch.distributed.init_process_group`` first (gloo or NCCL, one
rank a process) and every rank calls the same function.  Each builds on
``core.mesh.make_mesh``, which lays ranks out row-major as
``jax.make_mesh`` lays out devices.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.core.mesh import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  Raises
    when the world has another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != 256 * (2 if multi_pod else 1):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{256 * (2 if multi_pod else 1)} ranks, the "
                         f"world has {world}")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(model: int = 0, device=None):
    """Best-effort ("data", "model") mesh over the whole world (tests /
    smoke runs): ``model`` ranks on the model axis, or, when it is 0, the
    largest of 2, 4, 8, 16 that divides the world (1 when none does)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if model <= 0:
        model = 1
        for cand in (2, 4, 8, 16):
            if n % cand == 0 and cand <= n:
                model = cand
    return make_mesh((n // model, model), ("data", "model"), device=device)


def fft_mesh_axes(mesh) -> tuple:
    """Pencil (Py, Pz) communicator axes on a production mesh: the pod axis
    folds into the Y communicator (DESIGN.md §2)."""
    names = mesh.axis_names
    if "pod" in names:
        return (("pod", "data"), "model")
    return ("data", "model")


def join_world(device=None):
    """When this process is one of several ranks (``torchrun``:
    ``WORLD_SIZE`` >= 2), join the world (NCCL where every rank has a card
    of its own, else gloo: ranks that share a card, and on the CPU) and
    return where this rank's blocks live: its card (``LOCAL_RANK``) or
    ``device``.  None for a single process."""
    from repro_torch.device import resolve_device
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n < 2:
        return None
    if device is None or torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    device = resolve_device(device)
    if not dist.is_initialized():
        own_card = (device.type == "cuda"
                    and torch.cuda.device_count() >= n)
        dist.init_process_group("nccl" if own_card else "gloo")
    return device


def world_mesh(model: int = 0, device=None):
    """The LM launchers' mesh: :func:`make_local_mesh` over the world that
    :func:`join_world` joins; None for a single process, which stays
    meshless."""
    device = join_world(device)
    return None if device is None else make_local_mesh(model, device)
