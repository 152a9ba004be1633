"""Pack/unpack of the ring and pairwise global transposes: the Hopper
kernel ``csrc/rotate_blocks.cu`` and its plain PyTorch version.

Port of ``repro/kernels/transpose_pack.py``.  The CUDA kernel replaces
the Pallas TPU kernel ``rotate_block_rows_planes`` (``_rotate_kernel``).
A P-rank ring (or pairwise) transpose sends block ``(r + s) % P`` of the
split axis to rank ``(r + s) % P`` in round s, and reassembles the
received blocks along the concat axis rotated by ``r`` the other way.
Both sides are one cyclic rotation of P blocks by a rank-dependent shift,
done in one pass each:

  pack    :func:`pack_pieces`    rotate by idx, written piece-major: P
                                 contiguous send buffers
  unpack  :func:`unpack_pieces`  the received pieces, stacked in one
                                 piece-major buffer, rotated by -idx

Bound on an H100: bytes — a pure copy, each byte read once and written
once.  The kernel views any axis as (outer, P, unit) with no axis move
and no real/imag plane split (the TPU kernel's two extra passes), and
copies 16-byte vectors where :func:`rotate_path` finds the runs and
bases aligned, else 8-byte ones (``csrc/rotate_blocks.cu``).

A tensor on the CPU goes to :func:`rotate_block_rows_plain`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "rotate_blocks"
VEC16, VEC8 = 16, 8
# src, dst, outer, P, unit, shift, src piece-major, dst piece-major, vector
# bytes, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def rotate_path(unit: int, src_ptr: int, dst_ptr: int) -> int:
    """The vector width in bytes that copies runs of ``unit`` complex64
    elements between these base addresses: ``VEC16`` (two elements) when
    ``unit`` is even and both bases are 16-byte aligned, else ``VEC8``.
    P and the layouts do not enter: every run of either layout is
    ``unit`` elements long and starts at a multiple of ``unit`` from its
    base."""
    if unit % 2 or src_ptr % 16 or dst_ptr % 16:
        return VEC8
    return VEC16


def rotate_block_rows(x: torch.Tensor, outer: int, p: int, unit: int,
                      shift: int, src_piece_major: bool = False,
                      dst_piece_major: bool = False) -> torch.Tensor:
    """Rotate the P blocks of contiguous complex64 ``x`` viewed as
    (outer, P, unit): destination block (o, i) is source block
    (o, (i + shift) % P).  A side marked piece-major is laid out
    (P, outer, unit) instead.  Returns a new flat tensor."""
    if x.numel() != outer * p * unit:
        raise ValueError(f"{x.numel()} elements do not view as "
                         f"({outer}, {p}, {unit})")
    if x.device.type == "cpu":
        return rotate_block_rows_plain(x, outer, p, unit, shift,
                                       src_piece_major, dst_piece_major)
    if x.device.type != "cuda":
        raise ValueError(f"rotate_blocks runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"rotate_blocks takes complex64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rotate_blocks takes a contiguous tensor")
    x = _build.memory(x)
    y = torch.empty(x.numel(), dtype=x.dtype, device=x.device)
    src, dst = x.data_ptr(), y.data_ptr()
    fn = _build.function(NAME, "rotate_blocks_launch", _ARGTYPES)
    status = _build.call(fn, x.device, src, dst, outer, p, unit, shift % p,
                         int(src_piece_major), int(dst_piece_major),
                         rotate_path(unit, src, dst))
    _build.check(status, NAME)
    _build.count_launch(NAME)
    return y


def rotate_block_rows_plain(x: torch.Tensor, outer: int, p: int, unit: int,
                            shift: int, src_piece_major: bool = False,
                            dst_piece_major: bool = False) -> torch.Tensor:
    """:func:`rotate_block_rows` as one block gather: a pure copy, so its
    result is bitwise the kernel's."""
    if src_piece_major:
        v = x.reshape(p, outer, unit).transpose(0, 1)
    else:
        v = x.reshape(outer, p, unit)
    order = (torch.arange(p, device=x.device) + shift) % p
    r = v[:, order]
    if dst_piece_major:
        r = r.transpose(0, 1)
    return r.contiguous().reshape(-1)


def _split(shape, axis: int, n_blocks: int) -> tuple[int, int]:
    extent = shape[axis]
    if extent % n_blocks:
        raise ValueError(
            f"axis {axis} extent {extent} not divisible by {n_blocks}")
    outer = math.prod(shape[:axis])
    return outer, extent // n_blocks * math.prod(shape[axis + 1:])


def rotate_blocks(x: torch.Tensor, axis: int, shift: int,
                  n_blocks: int) -> torch.Tensor:
    """Cyclically rotate the ``n_blocks`` equal blocks of ``x`` along
    ``axis`` by ``shift`` blocks (block i of the result is block
    (i + shift) % n_blocks of the input)."""
    if n_blocks == 1:
        return x
    axis = axis % x.ndim
    outer, unit = _split(x.shape, axis, n_blocks)
    return rotate_block_rows(x, outer, n_blocks, unit,
                             shift % n_blocks).view(x.shape)


def pack_pieces(blk: torch.Tensor, axis: int, idx: int,
                n_blocks: int) -> list:
    """The ring/pairwise send pack: the ``n_blocks`` blocks of ``axis``
    as a list ordered by round (piece s is the block bound for rank
    ``(idx + s) % n_blocks``).  One rotation pass writes all pieces into
    one piece-major buffer, so every piece is contiguous."""
    axis = axis % blk.ndim
    outer, unit = _split(blk.shape, axis, n_blocks)
    piece = list(blk.shape)
    piece[axis] //= n_blocks
    if n_blocks == 1:
        return [blk]
    buf = rotate_block_rows(blk, outer, n_blocks, unit, idx % n_blocks,
                            dst_piece_major=True)
    return list(buf.view(n_blocks, *piece).unbind(0))


def unpack_pieces(buf: torch.Tensor, axis: int, shift: int) -> torch.Tensor:
    """The ring unpack: ``buf`` (P, *piece) holds the received pieces
    stacked; the result concatenates them along ``axis`` with block i =
    ``buf[(i + shift) % P]``, in one rotation pass."""
    p = buf.shape[0]
    piece = list(buf.shape[1:])
    if p == 1:
        return buf[0]
    axis = axis % len(piece)
    outer, unit = _split(piece, axis, 1)
    out = list(piece)
    out[axis] *= p
    return rotate_block_rows(buf, outer, p, unit, shift % p,
                             src_piece_major=True).view(out)
