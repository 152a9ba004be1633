"""CROFT core: pencil-decomposed distributed 3-D FFT (port of ``repro.core``)."""

from repro_torch.core.api import Croft3D, auto_pencil, poisson_solve
from repro_torch.core.decomposition import (Decomposition, local_block,
                                            pencil_grid_for)
from repro_torch.core.distributed import (FFTOptions, distributed_fft3d,
                                          fft3d, fft3d_local, ifft3d)
from repro_torch.core.local_fft import (fft_1d, fft_matmul, fft_stockham,
                                        fft_xla)
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.core.plan import FFTPlan, clear_plan_cache, make_plan
from repro_torch.core.rfft import irfft3d, rfft3d, rfft3d_local

__all__ = [
    "Croft3D", "Decomposition", "FFTOptions", "FFTPlan", "Mesh",
    "auto_pencil", "clear_plan_cache", "distributed_fft3d", "fft3d",
    "fft3d_local", "fft_1d", "fft_matmul", "fft_stockham", "fft_xla",
    "ifft3d", "irfft3d", "local_block", "make_mesh", "make_plan",
    "pencil_grid_for", "poisson_solve", "rfft3d", "rfft3d_local",
]
