"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds).  Libraries land in the
repository's ``build/`` directory under a name that carries a hash of the
source, so an edited kernel is rebuilt and a stale library is never
loaded.  :func:`build_all` compiles every source at once, one ``nvcc``
process each, all started together.

The launch path is short: :func:`function` types each C launcher once
per process and caches it, and :func:`call` passes PyTorch's current
stream and switches the current device only when the tensor lies on
another.

The launch counters live here too: every kernel wrapper calls
:func:`count_launch` exactly where it launches its kernel, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()
_launches: dict[str, int] = {}


class KernelError(RuntimeError):
    """A hand-written kernel did not build, load or launch: ``nvcc`` is
    missing or refused a source, or a launcher returned a CUDA error.
    Callers let it through, so a failing kernel is never replaced by
    another version of the same work."""


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + ARCH.encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    (BUILD / f"{name}.ptxas.log").write_text(log)
    return log


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, in parallel; returns the
    compiler's log (``-Xptxas -v``: registers, shared memory, spills)
    per freshly built source."""
    names = sources()
    started = {n: _start(n) for n in names}
    return {n: _finish(n, started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            try:
                lib = ctypes.CDLL(str(_lib_path(name)))
            except OSError as e:
                raise KernelError(f"cannot load {name}.cu's library: "
                                  f"{e}") from e
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, typed: pointers
    and the stream must be ``c_void_p`` or ctypes cuts them to 32 bits;
    every launcher returns ``cudaGetLastError()`` as an int.  Typed on the
    first call and cached; later calls take no lock."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def _raw_stream(index: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def call(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on PyTorch's current stream of ``device``;
    the current device is switched only when ``device`` is another."""
    if device.index == torch.cuda.current_device():
        return fn(*args, _raw_stream(device.index))
    with torch.cuda.device(device):
        return fn(*args, _raw_stream(device.index))


def memory(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its values in its memory: a lazy conjugate or negation
    (``t.conj()``, ``t.conj().imag``; ``contiguous()`` keeps both bits)
    is resolved into a copy, since a kernel reads ``data_ptr()`` as
    stored.  Every wrapper passes its inputs through here before it
    takes their addresses."""
    if t.is_conj():
        t = t.resolve_conj()
    if t.is_neg():
        t = t.resolve_neg()
    return t


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launcher."""
    if status != 0:
        raise KernelError(f"{name} launch failed: CUDA error {status}")
