"""Async checkpointing, in the reference's on-disk format.

Port of ``repro/train/checkpoint.py``.  Format: one ``.npy`` per leaf
under ``<dir>/step_<n>/`` plus a JSON manifest (keys, files, shapes,
dtype names, step); bf16 (and fp8) leaves are stored as their raw bits
(``uint16``/``uint8``) under their own dtype name, so either package
restores what the other wrote.  Writes happen on a background thread
into a ``.tmp-step_<n>`` directory committed by rename, so a preemption
mid-write never corrupts the latest checkpoint; ``keep`` bounds how many
stay.

A tree is nested dicts, lists and tuples of tensors or numpy arrays; an
``nn.Module`` in it stands for its ``state_dict()``, so a train state
``{"params": model, "opt": {"m": ..., "v": ..., "step": ...}}`` is keyed
``params/<name>``, ``opt/m/<name>``, ``opt/v/<name>`` and ``opt/step``.
:meth:`CheckpointManager.save` copies every leaf to the host before it
returns (the train step then updates the state in place); with a process
group only rank 0 writes.

A sharded state (a Model that holds this rank's blocks, with its
``layout``, and moments of the same blocks) is saved with logical shapes
only: every rank calls ``save``, and each leaf keyed by a parameter name
of the layout is collected whole into rank 0's host memory, one leaf at
a time (``core.mesh.Mesh.collect``, a collective), so no other rank
ever holds more than its blocks; rank 0 writes the reference's format.  ``restore(template, shardings=)`` (per-rank slices
by key, ``parallel.sharding.param_shardings``) places each stored array
onto the template's mesh, whatever mesh wrote it: the reference's
elastic contract.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# numpy has no bf16/fp8: store the raw bits under the dtype's name
_EXOTIC_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}
_TORCH_EXOTIC = {v[0]: k for k, v in _EXOTIC_DTYPES.items()}


def tensor_to_numpy(t: torch.Tensor) -> tuple:
    """(host array to store, dtype name): a copy, never a view of ``t``."""
    t = t.detach().to("cpu", copy=True)
    name = _TORCH_EXOTIC.get(t.dtype)
    if name is not None:
        _, bits, tbits = _EXOTIC_DTYPES[name]
        return t.view(tbits).numpy().view(bits), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def tensor_from_numpy(arr: np.ndarray, device=None,
                      dtype_name: Optional[str] = None) -> torch.Tensor:
    """``arr`` as a tensor on ``device``.  A bf16/fp8 array comes either
    as raw bits with ``dtype_name`` naming the type, or as an array of
    that numpy dtype (``ml_dtypes``, as JAX hands it over)."""
    name = dtype_name or arr.dtype.name
    if name in _EXOTIC_DTYPES:
        ttype, bits, tbits = _EXOTIC_DTYPES[name]
        raw = np.array(arr).view(bits)      # a writable copy
        t = torch.from_numpy(raw.view(np.int16 if bits == np.uint16
                                      else np.uint8)).view(tbits).view(ttype)
    else:
        t = torch.from_numpy(np.array(arr))   # a writable copy
    return t.to(device) if device is not None else t


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/0": leaf} in the tree's order; a Module is its state_dict."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.state_dict())
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _layout_of(tree):
    """The layout of the first Model in ``tree`` that holds blocks."""
    if isinstance(tree, nn.Module):
        return getattr(tree, "layout", None)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            got = _layout_of(v)
            if got is not None:
                return got
    return None


def _whole(key: str, t, layout):
    """A leaf as the checkpoint stores it, on rank 0 (None elsewhere): a
    block of a parameter of ``layout`` (its key's last part names it)
    collected whole onto rank 0's host, any other leaf as it is."""
    name = key.rsplit("/", 1)[-1]
    if layout is None or name not in layout.specs \
            or not isinstance(t, torch.Tensor) \
            or all(e is None for e in layout.specs[name]):
        return t if _rank0() else None
    return layout.mesh.collect(t, layout.shapes[name], layout.specs[name])


def _flat_shardings(tree, prefix: str = "") -> dict:
    """{key: tuple of slices} of a shardings tree (dicts of per-rank
    slice tuples, or None)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shardings(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tuple(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False):
        """Write ``tree`` as step ``step`` (on a background thread unless
        ``block``).  When a Model in ``tree`` holds blocks, each leaf keyed
        by one of its parameter names (its masters and moments) is saved
        whole, and then every rank must call ``save``."""
        if _rank0():
            self.wait()  # one in-flight write at a time
        layout = _layout_of(tree)
        host = {}
        for k, v in _flatten(tree).items():   # device -> host, leaf by leaf
            v = _whole(k, v, layout)
            if v is not None:
                host[k] = tensor_to_numpy(
                    v if isinstance(v, torch.Tensor)
                    else tensor_from_numpy(np.asarray(v)))
        if not _rank0():
            return

        def _write():
            tmp = os.path.join(self.dir, f".tmp-step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for key, (arr, dtype_name) in host.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": dtype_name}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if self.async_write and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, d: str, manifest: dict, key: str, like, step: int,
              box=None):
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint step_{step} missing leaf {key}")
        arr = np.load(os.path.join(d, info["file"]),
                      mmap_mode=None if box is None else "r")
        if box is not None:
            arr = np.ascontiguousarray(arr[box])
        expect = tuple(like.shape)
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != model {expect}")
        if isinstance(like, torch.Tensor) or info["dtype"] in _EXOTIC_DTYPES:
            return tensor_from_numpy(arr, getattr(like, "device", None),
                                     info["dtype"])
        return arr

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``template``: each leaf on the
        template leaf's device in the stored dtype (a numpy leaf stays
        numpy unless it was stored as bf16/fp8), its shape checked.  An
        ``nn.Module`` in the template takes its values in place and is
        returned itself.

        ``shardings``: a tree of this rank's slices (tuples) by key, as
        ``template`` (e.g. ``{"params": param_shardings(model, mesh,
        axes), "opt": {"m": ..., "v": ..., "step": None}}``); a leaf it
        names takes its slice of the stored array, so a checkpoint written
        on one mesh restores onto any other."""
        boxes = _flat_shardings(shardings)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def rebuild(node, prefix: str):
            if isinstance(node, nn.Module):
                with torch.no_grad():
                    for name, t in node.state_dict(keep_vars=True).items():
                        t.copy_(self._load(d, manifest, prefix + name, t,
                                           step, boxes.get(prefix + name)))
                return node
            if isinstance(node, dict):
                return {k: rebuild(v, f"{prefix}{k}/")
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(rebuild(v, f"{prefix}{i}/")
                                  for i, v in enumerate(node))
            return self._load(d, manifest, prefix[:-1], node, step,
                              boxes.get(prefix[:-1]))

        return rebuild(template, "")
