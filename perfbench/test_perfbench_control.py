"""The control: the plain reference in the program's place, one
precision below the configuration's (TF32 products; on the CPU, operands
rounded to TF32's mantissa), has to fail one of every cell's numbers,
on every seed."""

import pytest
import torch

from perfbench import control
from perfbench.harness.spec import Bench

CELLS = [w["name"] for w in Bench().doc["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(bench, workload):
    rows = control.run(bench, workload, [1, 2 ** 31 + 9, 12345],
                       torch.device("cpu"))
    for row in rows:
        assert any(not c["passed"] for c in row["checks"].values()), row
        # and it fails by a wide margin: the limit lies far below it
        assert max(c["value"] / c["limit"] for c in row["checks"].values()) > 5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from perfbench.reference import fft3d
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, -3.0])
    got = fft3d.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
