"""The matmul local FFT's spans and counter (``core/local_fft.py:
fft_matmul``): ``matmul:dft`` a DFT product, ``matmul:twiddle``,
``matmul:relayout``, and ``matmul_dft_products`` one a product issued;
free when nothing records, ``repro_torch.*`` ranges under
``torch.profiler``, and no change to the answers when they record."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import Croft3D, local_fft
from repro_torch.obs import metrics
from repro_torch.obs import tracer as tracer_lib
from test_torch_obs_spans import nesting, profiled_trace

SHAPE = (1024, 8, 16)       # a two-product axis and two one-product axes
SPANS = ("matmul:dft", "matmul:twiddle", "matmul:relayout")


def field(shape, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, generator=g)


def products() -> float:
    found = metrics.get_registry().get(local_fft.DFT_PRODUCTS)
    return 0.0 if found is None else found.value


def roundtrip(shape=SHAPE):
    plan = Croft3D(shape, device="cpu")
    x = field(shape)
    return lambda: plan.inverse(plan.forward(x))


# 1 product up to 64 points, 2 up to 4096, the six-step above: 8192 is
# 64 x 128, and 128 is 64 x 2
@pytest.mark.parametrize("n, want", [(1, 1), (16, 1), (64, 1), (128, 2),
                                     (1024, 2), (4096, 2), (8192, 3)])
def test_counter_counts_the_products_of_an_axis(n, want):
    x = field((2, n))
    before = products()
    local_fft.fft_matmul(x)
    assert products() - before == want


def test_counter_counts_a_3d_roundtrip():
    run = roundtrip()
    before = products()
    run()
    # forward and inverse: 2 for the 1024-point axis, 1 each for 8 and 16
    assert products() - before == 2 * (2 + 1 + 1)


def test_off_spans_are_null_and_record_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tracer_lib.get_tracer() is tracer_lib.NOOP
    for name, cat in zip(SPANS, ("fft", "epilogue", "unpack")):
        assert obs.span(name, cat, torch.device("cpu")) is \
            tracer_lib._NULL_SPAN
    before = tracer_lib._record
    roundtrip()()
    assert tracer_lib._record is before


def test_profiled_spans_nest_and_count(tmp_path):
    events, record = profiled_trace(roundtrip(), tmp_path)
    got = nesting(events)
    for name in SPANS:
        assert got[name] == {"stage:fft"}, name
    assert got["stage:fft"] == {"croft3d:forward", "croft3d:inverse"}
    assert record["matmul:dft"]["count"] == 2 * (2 + 1 + 1)
    assert record["matmul:twiddle"]["count"] == 2
    assert record["matmul:relayout"]["count"] == 2
    # timed on no card: host time only
    assert all(record[n]["host_s"] > 0 and record[n]["device_s"] is None
               for n in SPANS)


def test_six_step_spans_nest_inside_the_axis(tmp_path):
    x = field((2, 8192))
    events, record = profiled_trace(lambda: local_fft.fft_matmul(x),
                                    tmp_path)
    # 64 x 128, then 64 x 2: the inner call's spans are the outer's
    # siblings, outside every span of the outer call
    assert record["matmul:dft"]["count"] == 3
    assert record["matmul:twiddle"]["count"] == 2
    assert record["matmul:relayout"]["count"] == 2
    assert nesting(events) == {name: {None} for name in SPANS}


def test_a_tracer_takes_the_spans():
    run = roundtrip()
    with obs.tracing() as tr:
        run()
    names = [e["name"] for e in tr.events()]
    assert names.count("matmul:dft") == 8
    assert names.count("matmul:twiddle") == names.count(
        "matmul:relayout") == 2
    assert tr.device_ms() == {}           # nothing ran on a card


def test_answers_bitwise_equal_with_tracing_on_and_off():
    run = roundtrip()
    off = run()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = run()
    obs.profiled()
    with obs.tracing():
        traced = run()
    assert torch.equal(off, profiled) and torch.equal(off, traced)
