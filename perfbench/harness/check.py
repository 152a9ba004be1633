"""Deciding ``correct``: what the timed path produced against the plain
reference, at the timed sizes.

Two readings of every answer of the window:

- the last step's answers, whole, element by element;
- a sample of points of every step's answers (``Samples``), drawn from
  the seed and kept while the window runs, so a step other than the last
  that went wrong is seen too.

Each is a largest error relative to the reference block's largest
magnitude; the number compared is the larger.  ``spectrum_err`` holds the
forward's output (the rank's block of the spectrum), ``field_err`` the
inverse's output against the input (the reference's round trip is the
identity), ``solution_err`` the Poisson solve's field.  Each number has a
limit of its own in ``limits/<cell>.json``.

The reference runs once the window has closed and the program's state
is freed, in slabs, after the answers it judges.
"""

from __future__ import annotations

import torch

from perfbench.harness import fields


def blocks(reference, config: dict, traffic, rank: int) -> dict:
    """The global block of each layout this rank holds, worked out by the
    reference's rule from the configuration's decomposition and mesh."""
    shape = tuple(config["grid"])
    dec, mesh = config.get("decomposition"), config.get("mesh")
    if traffic.problem == "r2c":
        if mesh is not None:
            raise NotImplementedError("no r2c cell on a mesh yet")
        nx, ny, nz = shape
        return {"input": reference.layout_block(shape, None, None, rank, ""),
                "output": reference.layout_block((nx, ny, nz // 2 + 1), None,
                                                 None, rank, "")}
    out_layout = config.get("options", {}).get("output_layout", "natural")
    return {"input": reference.layout_block(shape, dec, mesh, rank, "natural"),
            "output": reference.layout_block(shape, dec, mesh, rank,
                                             out_layout)}


def _slab(n: int) -> range:
    return range(0, n, 32)


def max_abs(t: torch.Tensor) -> float:
    return max(t[i:i + 32].abs().max().item() for i in _slab(t.shape[0]))


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return max((got[i:i + 32] - want[i:i + 32]).abs().max().item()
               for i in _slab(got.shape[0]))


class Samples:
    """Points of every step's answers, one row a step."""

    def __init__(self, seed: int, shapes: dict, dtypes: dict, count: int,
                 steps: int, device):
        self.idx, self.rows, self.n = {}, {}, 0
        for name, shape in shapes.items():
            numel = 1
            for s in shape:
                numel *= s
            self.idx[name] = fields.sample_points(seed, name, numel, count,
                                                  device)
            self.rows[name] = torch.empty((steps, count), dtype=dtypes[name],
                                          device=device)

    def record(self, answers: dict) -> None:
        for name, idx in self.idx.items():
            self.rows[name][self.n].copy_(torch.take(answers[name], idx))
        self.n += 1

    def err(self, name: str, want: torch.Tensor) -> float:
        vals = torch.take(want, self.idx[name])
        return (self.rows[name][:self.n] - vals[None]).abs().max().item()


def expected(reference, name: str, config: dict, traffic, seed: int,
             rank: int, arith) -> torch.Tensor:
    """The reference's block of answer ``name``."""
    shape = tuple(config["grid"])
    dev = arith.device
    dtype = traffic.input_dtype(getattr(torch, config["dtype"]))
    where = blocks(reference, config, traffic, rank)

    def source(x0, x1):
        return fields.planes(seed, shape, dtype, x0, x1, dev)
    if name == "spectrum":
        return reference.spectrum(source, shape, where["output"], arith)
    if name == "field":
        return fields.block(seed, shape, dtype, where["input"], dev)
    if name == "solution":
        return reference.poisson(source, shape, arith, traffic.box)
    raise KeyError(f"no reference for answer {name!r}")


def numbers(reference, config: dict, traffic, seed: int, rank: int,
            answers: dict, samples, device, precision: str = "fp32") -> dict:
    """``{<answer>_err: value}`` of this rank's answers (every answer the
    traffic names that ``answers`` holds)."""
    arith = reference.Arith(precision, device)
    out = {}
    for name, _ in traffic.answers():
        if name not in answers:
            continue
        want = expected(reference, name, config, traffic, seed, rank, arith)
        scale = max_abs(want)
        err = max_err(answers[name], want)
        if samples is not None:
            err = max(err, samples.err(name, want))
        out[f"{name}_err"] = err / scale
        del want
    return out
