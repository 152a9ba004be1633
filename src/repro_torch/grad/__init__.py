"""repro_torch.grad — adjoint schedules: the differentiable transform.

Port of ``repro.grad``.  Two layers:

``adjoint``   a pure ``Schedule -> Schedule`` transform (reverse the
              stage order, swap each transpose's split/concat axes, map
              each local FFT and packed stage op to its transpose),
              validated by the same symbolic layout propagation that
              checks forward schedules; ``describe()`` equals the
              reference's.
``vjp``       ``torch.autograd.Function`` plans that run the adjoint
              schedule as the backward pass of every entry point, with
              the conjugation PyTorch's convention asks for at their
              boundary.

``fft3d``/``ifft3d``/``rfft3d``/``irfft3d``/``scheduled_fft3d`` and the
``Croft3D`` methods pick this up by themselves; nothing here needs to be
called directly unless you compose adjoints yourself.
"""

from repro_torch.grad import vjp
from repro_torch.grad.adjoint import (PackTwoT, RepackHalvesT, SplitPairsT,
                                      UnpackTwoT, adjoint_ops,
                                      adjoint_schedule, fold_dc_plane_t,
                                      unfold_dc_plane_t)

__all__ = [
    "PackTwoT", "RepackHalvesT", "SplitPairsT", "UnpackTwoT",
    "adjoint_ops", "adjoint_schedule", "fold_dc_plane_t",
    "unfold_dc_plane_t", "vjp",
]
