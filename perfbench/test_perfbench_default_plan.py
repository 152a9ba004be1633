"""The default plan, ``Croft3D(shape)`` with ``FFTOptions()`` (the
matmul local FFT), against the plain reference on the CPU, on the
benchmark's seeded fields; and the ``croft1024-c2c-default-plan`` cell
run whole at a small size.

Tolerance: the cell's own limits (``limits/croft1024-c2c-default-plan
.json``), the largest error over the reference's largest magnitude, as
a run on the card is judged.  The reference computed one precision
below the configuration's (TF32's 10-bit mantissa) fails them by more
than ten times at these shapes, so a plan that dropped to that
precision would fail here too; float32 rounding leaves the port about
60 times inside them (4.6e-7 at most on these shapes and seeds)."""

import json
import time

import pytest
import torch

from perfbench.harness import cell, fields
from perfbench.harness.spec import Bench

CPU = torch.device("cpu")
CELL = "croft1024-c2c-default-plan"
# a 1024-point axis (two DFT products) beside short ones; every axis at
# most 64 points (one product each)
SHAPES = [(1024, 8, 16), (32, 64, 16)]
SEEDS = [3, 2 ** 31 + 17]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.fixture(scope="module")
def setup():
    bench = Bench()
    config = bench.config(bench.cell(CELL)["config"])
    return (bench.reference(config["reference"]), bench.limits(CELL),
            config)


def test_config_is_the_default_plan(setup):
    from repro_torch.core import FFTOptions
    _, _, config = setup
    assert config["options"] == {}
    assert FFTOptions(**config["options"]) == FFTOptions()
    assert FFTOptions().to_token() == config["options_token"]
    assert FFTOptions().local_impl == "matmul"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_default_plan_against_the_reference(setup, shape, seed):
    from repro_torch.core import Croft3D
    reference, limits, _ = setup
    x = fields.block(seed, shape, torch.complex64,
                     [slice(0, n) for n in shape], CPU)

    def spectrum(precision):
        return reference.spectrum(
            lambda a, b: fields.planes(seed, shape, torch.complex64, a, b,
                                       CPU),
            shape, tuple(slice(0, n) for n in shape),
            reference.Arith(precision, CPU))
    want, control = spectrum("fp32"), spectrum("tf32")
    assert rel_err(control, want) > 10 * limits["spectrum_err"]
    plan = Croft3D(shape, device="cpu")
    y = plan.forward(x)
    assert rel_err(y, want) <= limits["spectrum_err"]
    # the reference's round trip is the identity
    assert rel_err(plan.inverse(y), x) <= limits["field_err"]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_whole(bench, trace):
    mine = cell.run_rank(bench, CELL, 2 ** 31 + 23, 0.05, trace, CPU,
                         time.time())
    res = cell.combine(bench, CELL, trace, [mine], CPU)
    json.dumps(res)
    assert res["correct"] is True and res["attempted"] >= 4
    assert set(res["checks"]) == {"spectrum_err", "field_err"}
    if trace:
        # a CPU run reads no device metric, and this cell lists no
        # host-clock one
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"step_ms", "latency_p95_ms",
                                       "peak_gib", "setup_s"}
