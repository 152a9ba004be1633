"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the current
    CUDA card, and raises when there is none (pass ``device="cpu"`` to run
    on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def full_fp32_matmul(device: torch.device) -> None:
    """Keep float32/complex64 products in full FP32 on the card (the
    reference runs its DFT products at ``Precision.HIGHEST``; TF32 keeps
    about three digits and would not hold the FFT tolerances)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def has_values(t: torch.Tensor) -> bool:
    """False for a tensor that has a shape and no values: on ``meta``, or
    fake under ``FakeTensorMode`` (the dry run, ``launch.dryrun``).  Such
    a tensor is never cached past the call that made it: it belongs to
    its mode."""
    from torch._subclasses.fake_tensor import is_fake
    return not (t.is_meta or is_fake(t))
