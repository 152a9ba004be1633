"""Fixtures of the benchmark's CPU tests: the cells at a size a test run
holds."""

import dataclasses
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

SMALL_GRIDS = {"croft-1024": [16, 16, 16], "croft-2048-pencil4": [16, 16, 8]}


def small_bench():
    """The benchmark with every configuration's grid cut to a CPU test's
    size and every window to a few steps."""
    from perfbench.harness.spec import Bench
    bench = Bench()
    config, traffic = bench.config, bench.traffic
    bench.config = lambda name: dict(config(name), grid=SMALL_GRIDS[name])
    bench.traffic = lambda name: dataclasses.replace(
        traffic(name), min_steps=4, warmup_steps=2)
    return bench


@pytest.fixture
def bench():
    return small_bench()
