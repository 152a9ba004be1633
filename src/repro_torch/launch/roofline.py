"""Roofline constants of the card and the dry run's three terms.

Port of ``repro/launch/roofline.py``: the per-chip peaks the tuner's
cost model prices against, and :class:`RooflineTerms` (the reference's
fields and properties), priced with them.  The reference's HLO parsers
(``collective_stats``, ``terms_from_compiled``) are not ported: the port
runs eagerly and has no HLO.  The dry run (``launch.dryrun``) runs a
step on fake tensors instead; ``Mesh.counting()`` counts what its
collectives put on the wire and :func:`terms_from_count` prices it.

The figures are spec-sheet priors for one NVIDIA H100 80GB HBM3 (SXM,
700 W power limit; NVIDIA's data sheet, dense rates).  The collective
term (``LINK_BW``, and the latency prior in ``tuning.cost_model``) stays
a prior until a calibration run fits alpha/beta on the card and
publishes them (``tuning.cost_model.collective_constants``).
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12    # float32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction



@dataclasses.dataclass
class RooflineTerms:
    """Three per-device terms of one step, in seconds: compute (FLOPs
    over ``PEAK_FLOPS``), memory (bytes over ``HBM_BW``) and collective
    (wire bytes over ``LINK_BW``)."""
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int
    model_flops: float = 0.0       # 6*N*D (train) / 2*N_active*tokens (serve)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect-overlap) model: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted flops summed over devices) — remat and
        redundancy waste shows up here."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the modeled step time."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops / (self.n_devices * PEAK_FLOPS * t)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


def collective_bytes(collectives: dict) -> float:
    """Wire bytes of a ``CollectiveCount.collectives`` dict, the
    reference's convention (``collective_stats``): every kind's counted
    bytes, an all-reduce's twice (reduce-scatter + all-gather
    equivalent)."""
    return float(sum(e["bytes"] * (2 if kind == "all-reduce" else 1)
                     for kind, e in collectives.items()))


def terms_from_count(collectives: dict, flops: float, nbytes: float,
                     n_devices: int, model_flops: float = 0.0
                     ) -> RooflineTerms:
    """The terms of one rank's step: ``flops`` and HBM ``nbytes`` per
    device, the collective term from its counted ``collectives``
    (:func:`collective_bytes`)."""
    return RooflineTerms(
        flops_per_device=float(flops), bytes_per_device=float(nbytes),
        collective_bytes_per_device=collective_bytes(collectives),
        n_devices=n_devices, model_flops=model_flops)
