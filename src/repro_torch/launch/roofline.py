"""Roofline constants of the card.

Port of the constants of ``repro/launch/roofline.py``: the per-chip
peaks the tuner's cost model prices against.  The reference's HLO
parsers (``collective_stats``, ``terms_from_compiled``) are not ported:
the port runs eagerly and has no HLO; ``Mesh.counting()`` counts what
its collectives put on the wire instead.

The figures are spec-sheet priors for one NVIDIA H100 80GB HBM3 (SXM,
700 W power limit; NVIDIA's data sheet, dense rates).  The collective
term (``LINK_BW``, and the latency prior in ``tuning.cost_model``) stays
a prior until a calibration run fits alpha/beta on the card and
publishes them (``tuning.cost_model.collective_constants``).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12    # float32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction

