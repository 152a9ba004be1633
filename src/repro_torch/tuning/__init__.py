"""repro_torch.tuning — FFTW-style autotuning planner for the distributed
3-D FFT (port of ``repro.tuning``, module for module).

CROFT's option study (§5.1) and its FFTW3 comparison are ultimately about
*plan selection*: the same transform can be run with different
decompositions (slab/pencil/cell), overlap depths (K), local 1-D kernels,
output layouts, and transpose implementations, and the right combination
depends on shape, mesh, dtype, and hardware.  This package chooses it,
mapping directly onto FFTW's planner design:

  FFTW concept          here
  --------------------  ---------------------------------------------------
  planner search space  ``candidates.enumerate_candidates`` — every valid
                        (Decomposition, FFTOptions) pair for (shape, mesh),
                        filtered by divisibility/overlap constraints
  FFTW_ESTIMATE         ``mode="model"`` — ``cost_model.analytic_cost``
                        builds the candidate's actual stage schedule
                        (``repro_torch.core.schedule``, the same object
                        the executor runs) and walks it: per-stage FFT
                        sizes and transpose bytes, effective overlap-K,
                        collective launch counts — with zero execution;
                        collective counts of a built plan, counted on the
                        wire, via ``cost_model.counted_collectives``
  FFTW_PATIENT          ``mode="measure"`` — ``measure.measure_candidate``
                        builds and wall-clocks the model-ranked top-k
                        (plus the untuned default) on the live mesh, each
                        time the slowest rank's
  wisdom import/export  ``wisdom.Wisdom`` — JSON store keyed by
                        shape|mesh|dtype|backend[|problem]; ``mode="wisdom"``
                        reuses a stored plan without re-searching, and stores
                        can be merged across processes/hosts
                        (``python -m repro_torch.tuning.wisdom merge``,
                        with a shipped seed file via ``--seed``)

Problem classes: ``problem="c2c"`` (default) and ``problem="r2c"`` — the
real transform is a first-class citizen: its candidates carry a
packed/embed strategy axis (the two-for-one pipelines of
``repro_torch.real``,
pencil and slab alike, vs the embedding fallback), the schedule-derived
cost model charges the packed stages at their true half-volume sizes,
measurement runs real-input plans, and wisdom keys gain a problem
dimension.  The ``_grad`` variants (``"c2c_grad"``/``"r2c_grad"``) plan a
*training step*: same physical search space, but the cost model prices
the forward schedule **plus** its adjoint (``repro_torch.grad``),
measurement races forward + ``backward()`` through the plan, and the
wisdom key gains a trailing ``|grad`` dimension.
``heterogeneous_impls=True`` additionally searches per-stage
``local_impl`` 3-tuples, and ``batch=B`` plans for batched transforms
(volume terms scale by B, collective launch counts do not; the wisdom
key gains ``|b{B}``).

The collective cost constants (alpha latency / beta inverse-bandwidth)
are the card's priors until a calibration run publishes fitted values to
the metrics registry or a calibration JSON (``$CROFT_CALIBRATION``);
``cost_model.collective_constants`` picks them up.

Entry points: :func:`tune` below, and ``Croft3D.tuned(...)`` /
``Croft3D(..., tune="model")`` in ``repro_torch.core.api``.
"""

from repro_torch.tuning import (candidates, cost_model, measure,  # noqa: F401
                                planner, wisdom)
from repro_torch.tuning.candidates import (PROBLEMS, Candidate,
                                           default_candidate,
                                           decompositions_for,
                                           enumerate_candidates, split_grad)
from repro_torch.tuning.cost_model import (CostBreakdown, analytic_cost,
                                           collective_constants,
                                           counted_collectives,
                                           per_stage_costs, rank_candidates)
from repro_torch.tuning.measure import (measure_candidate, time_forward,
                                        time_train_step)
from repro_torch.tuning.planner import MODES, TuneResult, tune, upgrade_wisdom
from repro_torch.tuning.wisdom import (Wisdom, WisdomEntry, load_seed,
                                       merge_entries, wisdom_key)

__all__ = [
    "Candidate", "CostBreakdown", "MODES", "PROBLEMS", "TuneResult",
    "Wisdom", "WisdomEntry", "analytic_cost", "collective_constants",
    "counted_collectives", "decompositions_for", "default_candidate",
    "enumerate_candidates", "load_seed", "measure_candidate", "merge_entries",
    "per_stage_costs", "rank_candidates", "split_grad", "time_forward",
    "time_train_step", "tune", "upgrade_wisdom", "wisdom_key",
]
