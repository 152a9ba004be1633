"""Fused causal/windowed GQA attention (forward): the Hopper kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py``.  The CUDA kernel replaces
the Pallas TPU kernel ``flash_attention`` (``_flash_kernel``):

  out[b, i, h] = softmax_j(scale q[b, i, h] . k[b, j, h // g]) v[b, j, h // g]

with g = H / KV, keys masked to j <= i (``causal``) and i - j < ``window``,
positions 0..S-1 on both sides, masked scores set to the finite
``NEG_INF`` so a fully masked row stays NaN-free; scores, the running
max and sum and the accumulator in float32, the output in q's dtype.
q is (B, Sq, H, D), k and v (B, Skv, KV, D), bfloat16 or float32.

Bound on an H100: operations, 4·D flop per unmasked (query, key) pair.
The reference's ``q_block``/``kv_chunk``/``interpret`` knobs are the TPU
kernel's tiling and have no counterpart: the CUDA kernels pick their own
tiles and take any Sq and Skv, not only multiples of 128.

A tensor on the CPU goes to :func:`flash_attention_plain`, the TPU
kernel's chunked online softmax in torch; a CUDA tensor launches one of
two kernels of ``csrc/flash_attention.cu`` or raises.  Which one is a
rule of dtype and shape (:func:`variant`), never a retry:

- ``TC``, bf16 on the tensor cores (``wgmma``, K/V staged by TMA): q in
  bfloat16, both head dims multiples of 8 (TMA describes rows whose byte
  strides are multiples of 16) and q, k, v starting on 16-byte
  boundaries.  It splits p into two bf16 terms before the P·V product,
  which keeps the Pallas kernel's float32 p to ~2^-17 relative.
- ``FFMA``, FP32 FFMA: float32 (on the tensor cores it would run as
  TF32, which misses the 5e-5 check) and every other bf16 shape.

Each launch counts under ``NAME`` and under its variant's name.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
TC = "flash_attention_wgmma"    # the bf16 tensor-core kernel's launch count
FFMA = "flash_attention_ffma"   # the FP32 FFMA kernel's launch count
NEG_INF = -2.0 ** 30
D_MAX = 128          # the kernels zero-pad head_dim to 128 in shared memory
KV_CHUNK = 128       # the plain version's key chunk (the TPU kernel's default)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out, [dtype,] the ten ints of the geometry, scale, stream
_TC_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_void_p])
_FFMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                  + [ctypes.c_float, ctypes.c_void_p])


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected q (B, Sq, H, D) and k, v (B, Skv, KV, D)")
    b, _, h, d = q.shape
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[-1] != d
            or h % k.shape[2]):
        raise ValueError(f"incompatible q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (H % KV == 0)")
    if k.shape[1] == 0:
        raise ValueError("attention over no keys")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """q (B, Sq, H, D) · k, v (B, Skv, KV, D) -> (B, Sq, H, Dv), H % KV == 0."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    return _launch(q, k, v, causal, window, float(scale))


def _launch(q, k, v, causal, window, scale) -> torch.Tensor:
    q, k, v = (_build.memory(t) for t in (q, k, v))
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{NAME} runs on one cuda device; {what} is on "
                             f"{t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{NAME} takes float32 or bfloat16 of one dtype, "
                            f"got {what} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME} takes contiguous tensors ({what})")
    b, sq, h, d = q.shape
    _, skv, kvh, dv = v.shape
    if d > D_MAX or dv > D_MAX:
        raise ValueError(f"{NAME} takes head_dim <= {D_MAX}, got {d}, {dv}")
    out = torch.empty(b, sq, h, dv, dtype=q.dtype, device=q.device)
    which = variant(q, k, v)
    geometry = [b, sq, skv, h, kvh, d, dv, int(causal),
                int(window is not None),
                int(window) if window is not None else 0, scale]
    if which == TC:
        fn = _build.function(NAME, "flash_attention_tc_launch", _TC_ARGTYPES)
        args = geometry
    else:
        fn = _build.function(NAME, "flash_attention_launch", _FFMA_ARGTYPES)
        args = [_DTYPES[q.dtype]] + geometry
    status = _build.call(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), *args)
    _build.check(status, NAME)
    _build.count_launch(NAME)
    _build.count_launch(which)
    return out


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call launches: ``TC`` for bfloat16 with head dims
    that are multiples of 8 and 16-byte aligned bases, ``FFMA`` for
    everything else (float32 included)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and v.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return TC
    return FFMA


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None, scale=None,
                          kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """The kernel's function in plain tensor ops: the TPU kernel's online
    softmax over ``kv_chunk``-key chunks (the last one may be short), all
    query rows at once, p kept in float32."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    # (B, KV, g, Sq, D): query head h reads kv head h // g
    qf = (q.float() * scale).reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, kvh, g, sq, dv, dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, kv_chunk):
        kc = k[:, c0:c0 + kv_chunk].float().permute(0, 2, 1, 3)
        vc = v[:, c0:c0 + kv_chunk].float().permute(0, 2, 1, 3)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kc)
        k_pos = torch.arange(c0, c0 + kc.shape[2], device=q.device)[None, :]
        mask = torch.ones(sq, kc.shape[2], dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
