"""Decomposition descriptors: slab (1-D), pencil (2-D), cell (3-D).

Port of ``repro/core/decomposition.py``.  Paper §2.2.  A descriptor binds
the decomposition kind to mesh axis names and validates the
divisibility/scaling constraints the paper derives:

  slab    P_max = Nz                (FFTW3's limitation, §2.2.1 / §3.1)
  pencil  P_max = Ny * Nz           (CROFT, P3DFFT, 2DECOMP&FFT)
  cell    P_max = Nx * Ny * Nz      (rarely used; highest comm volume)

The reference's ``PartitionSpec``/``NamedSharding`` become plain spec
tuples (one entry per grid dim: ``None``, a mesh axis name, or a tuple of
names, major first) and per-rank slice descriptors: :func:`spec_slices`
says which global index range of each grid dim a rank at given mesh
coordinates holds, and :func:`local_block` cuts that block out of a
global array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

# a mesh (anything with a name -> size ``.shape``) or a plain mapping
MeshLike = object


def mesh_axis_sizes(mesh: MeshLike) -> Mapping[str, int]:
    """Axis-name -> size mapping from a mesh or a plain mapping.

    Anything with a ``.shape`` name->size mapping (the port's
    :class:`~repro_torch.core.mesh.Mesh`, or the tests' fakes) counts as
    a mesh."""
    shape = getattr(mesh, "shape", None)
    if shape is not None:
        return dict(shape)
    return dict(mesh)


def spec_names(entry) -> tuple:
    """The mesh-axis names of one spec entry (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_slices(spec: Sequence, shape: Sequence[int],
                mesh_sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> tuple:
    """The global index range of each grid dim held by the rank at mesh
    ``coords`` under ``spec`` (one entry per trailing dim of ``shape``).
    A dim sharded by several axes is split major-first, as a JAX
    ``PartitionSpec`` with a tuple entry splits it."""
    out = []
    for entry, n in zip(spec, shape[len(shape) - len(spec):]):
        names = spec_names(entry)
        parts = math.prod(mesh_sizes[a] for a in names)
        if n % parts:
            raise ValueError(f"extent {n} not divisible by {parts} "
                             f"({'+'.join(names)})")
        idx = 0
        for a in names:
            idx = idx * mesh_sizes[a] + coords[a]
        ext = n // parts
        out.append(slice(idx * ext, (idx + 1) * ext))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """How an (Nx, Ny, Nz) grid maps onto mesh axes.

    ``axes`` are mesh axis names, one per decomposed grid dimension:
      slab:   (z_axis,)                 grid dim 2 sharded
      pencil: (y_axis, z_axis)          grid dims 1, 2 sharded (x-pencils)
      cell:   (x_axis, y_axis, z_axis)  all three sharded
    Each entry may itself be a tuple of mesh axes (folded, e.g. ("pod","data")).
    """

    kind: str  # "slab" | "pencil" | "cell"
    axes: tuple  # of str or tuple[str, ...]

    def __post_init__(self):
        # canonicalize lists (e.g. from JSON round trips) to tuples so
        # every Decomposition is hashable and two equal plans hash equal
        object.__setattr__(self, "axes", tuple(
            tuple(a) if isinstance(a, list) else a for a in self.axes))
        expect = {"slab": 1, "pencil": 2, "cell": 3}
        if self.kind not in expect:
            raise ValueError(f"unknown decomposition kind {self.kind!r}")
        if len(self.axes) != expect[self.kind]:
            raise ValueError(
                f"{self.kind} needs {expect[self.kind]} mesh axes, got {self.axes}")

    # -- canonical string form (plan-cache / wisdom keys) -------------------
    def to_token(self) -> str:
        """Canonical string form, e.g. ``pencil[y,z]`` / ``pencil[pod+data,z]``
        (folded axis groups join with ``+``).  Round trips through
        :meth:`from_token`; mesh axis names must avoid ``[ ] , +``."""
        def axis_s(a):
            return "+".join(a) if isinstance(a, tuple) else a
        return f"{self.kind}[{','.join(axis_s(a) for a in self.axes)}]"

    @classmethod
    def from_token(cls, token: str) -> "Decomposition":
        """Inverse of :meth:`to_token`."""
        if not token.endswith("]") or "[" not in token:
            raise ValueError(f"malformed decomposition token {token!r}")
        kind, _, axes_s = token[:-1].partition("[")
        axes = []
        for part in axes_s.split(","):
            if not part:
                raise ValueError(f"malformed decomposition token {token!r}")
            groups = part.split("+")
            axes.append(tuple(groups) if len(groups) > 1 else groups[0])
        return cls(kind, tuple(axes))

    def axis_sizes(self, mesh: MeshLike) -> tuple[int, ...]:
        sizes = mesh_axis_sizes(mesh)

        def size(a):
            if isinstance(a, tuple):
                return math.prod(sizes[x] for x in a)
            return sizes[a]
        return tuple(size(a) for a in self.axes)

    def n_procs(self, mesh: MeshLike) -> int:
        return math.prod(self.axis_sizes(mesh))

    def partition_spec(self) -> tuple:
        """Input/output spec for the natural (x-aligned) layout."""
        if self.kind == "slab":
            return (None, None, self.axes[0])
        if self.kind == "pencil":
            return (None, self.axes[0], self.axes[1])
        return (self.axes[0], self.axes[1], self.axes[2])

    def spectral_spec(self) -> tuple:
        """Output layout when the restoring transposes are skipped.

        pencil: z-pencils — x sharded over the y-communicator axes, y over
        the z-communicator axes (P3DFFT-style spectral layout).
        """
        if self.kind == "slab":
            return (self.axes[0], None, None)
        if self.kind == "pencil":
            return (self.axes[0], self.axes[1], None)
        return (self.axes[0], self.axes[1], self.axes[2])

    def spec(self, layout: str = "natural") -> tuple:
        return (self.partition_spec() if layout == "natural"
                else self.spectral_spec())

    def validate(self, shape: Sequence[int], mesh: MeshLike,
                 overlap_k: int = 1,
                 transpose_impl: str = "alltoall") -> None:
        nx, ny, nz = shape[-3], shape[-2], shape[-1]
        if transpose_impl in ("pairwise", "ring"):
            # both point-to-point transposes (ring pipeline, FFTW3-style
            # MPI_Sendrecv emulation) exchange over ONE mesh axis
            if any(isinstance(a, tuple) for a in self.axes):
                raise ValueError(
                    f"transpose_impl='{transpose_impl}' supports single "
                    f"mesh axes only; {self.kind} decomposition folds "
                    f"{self.axes}")
            if self.kind == "cell":
                raise ValueError(
                    f"transpose_impl='{transpose_impl}' is incompatible "
                    "with the cell decomposition: its x-regroup runs the "
                    "pencil pipeline over a folded (y, x) communicator")
        sizes = self.axis_sizes(mesh)
        if self.kind == "slab":
            (pz,) = sizes
            if pz > nz:
                raise ValueError(
                    f"slab decomposition limited to P <= Nz: P={pz} > Nz={nz} "
                    "(the FFTW3 scaling wall, paper table 1)")
            _check_div("Nz", nz, pz)
            _check_div("Nx", nx, pz)  # needed by the x<->z transpose
            if overlap_k > 1:
                _check_div("Ny (overlap chunks)", ny, overlap_k)
        elif self.kind == "pencil":
            py, pz = sizes
            if py * pz > ny * nz:
                raise ValueError(f"pencil needs P <= Ny*Nz, got {py*pz} > {ny*nz}")
            _check_div("Ny", ny, py)
            _check_div("Nz", nz, pz)
            _check_div("Nx", nx, py)   # x<->y transpose
            _check_div("Ny", ny, pz)   # y<->z transpose
            if overlap_k > 1:
                _check_div("Nz/Pz (stage-1 chunks)", nz // pz, overlap_k)
                _check_div("Nx/Py (stage-2 chunks)", nx // py, overlap_k)
        else:  # cell
            px, py, pz = sizes
            _check_div("Nx", nx, px * py)
            _check_div("Ny", ny, py)
            _check_div("Nz", nz, pz)

    def slices(self, shape: Sequence[int], mesh: MeshLike,
               coords: Mapping[str, int], layout: str = "natural") -> tuple:
        """The global index ranges a rank at ``coords`` holds (the
        reference's ``sharding(mesh, layout)`` for one rank)."""
        return spec_slices(self.spec(layout), shape, mesh_axis_sizes(mesh),
                           coords)

    def is_valid(self, shape: Sequence[int], mesh: MeshLike,
                 overlap_k: int = 1,
                 transpose_impl: str = "alltoall") -> bool:
        """Non-raising :meth:`validate` (used by the tuning planner)."""
        try:
            self.validate(shape, mesh, overlap_k, transpose_impl)
        except (ValueError, KeyError):
            return False
        return True

    def local_shape(self, shape: Sequence[int], mesh: MeshLike) -> tuple[int, ...]:
        nx, ny, nz = shape[-3], shape[-2], shape[-1]
        sizes = self.axis_sizes(mesh)
        if self.kind == "slab":
            return (nx, ny, nz // sizes[0])
        if self.kind == "pencil":
            return (nx, ny // sizes[0], nz // sizes[1])
        return (nx // sizes[0], ny // sizes[1], nz // sizes[2])


def local_block(x: np.ndarray, decomp: Decomposition,
                mesh_sizes: Mapping[str, int], coords: Mapping[str, int],
                layout: str = "natural") -> np.ndarray:
    """The block of the global array ``x`` that the rank at mesh
    ``coords`` holds — exactly the shard the reference's
    ``NamedSharding(mesh, decomp.partition_spec())`` (``layout=
    "natural"``) or ``spectral_spec()`` (``"spectral"``) gives it."""
    return x[(Ellipsis,) + decomp.slices(x.shape, mesh_sizes, coords, layout)]


def _check_div(name: str, n: int, p: int) -> None:
    if n % p != 0:
        raise ValueError(f"{name}={n} not divisible by {p}")


def pencil_grid_for(n_procs: int, ny: int, nz: int) -> tuple[int, int]:
    """Pick a near-square Py x Pz = n_procs factorization (paper fig. 5).

    Prefers Py <= Pz and respects Py | Ny, Pz | Nz.
    """
    best = None
    for py in range(1, n_procs + 1):
        if n_procs % py:
            continue
        pz = n_procs // py
        if ny % py or nz % pz:
            continue
        score = abs(math.log2(py) - math.log2(pz))
        if best is None or score < best[0]:
            best = (score, py, pz)
    if best is None:
        raise ValueError(f"no valid pencil grid for P={n_procs}, Ny={ny}, Nz={nz}")
    return best[1], best[2]
