"""The matmul local FFT's spans and counters (``core/local_fft.py:
fft_matmul``): ``matmul:dft`` a DFT product (both products of a
two-level contiguous axis, ``kernels/dft_rows``, and its twiddle;
``matmul:plain`` where the kernel's plain version runs them, counted by
``matmul_plain_axes``), ``matmul:twiddle`` (a six-step level's twiddle
pass),
``matmul:relayout`` (an input's copy where it has no ``(A, N, C)`` view),
``matmul_dft_products`` one a product issued, ``matmul_fused_axes`` one
a contiguous axis the kernel ran and ``matmul_layout_copies`` one such
copy; free when nothing records, ``repro_torch.*`` ranges under
``torch.profiler``, and no change to the answers when they record."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.core import Croft3D, local_fft
from repro_torch.kernels import dft_rows
from repro_torch.obs import metrics
from repro_torch.obs import tracer as tracer_lib
from test_torch_obs_spans import nesting, profiled_trace

# a strided two-product axis, a one-product axis and a contiguous
# two-product axis (16 x 8), which the fused kernel runs in one span
SHAPE = (1024, 8, 128)
SPANS = ("matmul:dft", "matmul:twiddle", "matmul:relayout")


def field(shape, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, generator=g)


def products() -> float:
    found = metrics.get_registry().get(local_fft.DFT_PRODUCTS)
    return 0.0 if found is None else found.value


def layout_copies() -> float:
    found = metrics.get_registry().get(local_fft.LAYOUT_COPIES)
    return 0.0 if found is None else found.value


def fused_axes() -> float:
    found = metrics.get_registry().get(local_fft.FUSED_AXES)
    return 0.0 if found is None else found.value


def plain_axes() -> float:
    found = metrics.get_registry().get(local_fft.PLAIN_AXES)
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
    # forward and inverse: 2 for the 1024-point axis, 1 for 8, 2 for 128
    assert products() - before == 2 * (2 + 1 + 2)



def test_a_view_the_products_cannot_read_is_copied_once(tmp_path):
    x = field((8, 16, 32))
    # along the last axis (A, N, C) = (8*8, 32, 1), but the slice's 8 and
    # 8 do not merge into one dim: no such view
    block = x[:, 4:12, :]
    before = layout_copies()
    events, record = profiled_trace(
        lambda: local_fft.fft_1d(block, 2, -1), tmp_path)
    assert layout_copies() - before == 1
    assert record["matmul:relayout"]["count"] == 1
    assert nesting(events)["matmul:relayout"] == {None}


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
    # a contiguous field takes no layout copy, and the fused kernel's
    # contiguous axis no twiddle pass
    ran = SPANS[:1]
    assert "matmul:relayout" not in record
    assert "matmul:twiddle" not in record
    for name in ran:
        assert got[name] == {"stage:fft"}, name
    assert got["stage:fft"] == {"croft3d:forward", "croft3d:inverse"}
    # a span a product of the strided axes, one the fused axis
    assert record["matmul:dft"]["count"] == 2 * (2 + 1 + 1)
    # timed on no card: host time only
    assert all(record[n]["host_s"] > 0 and record[n]["device_s"] is None
               for n in ran)


def test_six_step_spans_nest_inside_the_axis(tmp_path):
    x = field((2, 8192))
    events, record = profiled_trace(lambda: local_fft.fft_matmul(x),
                                    tmp_path)
    # 64 x 128, then 64 x 2: the outer twiddle pass writes the 128-point
    # axis strided, whose level folds its twiddles; the inner level's
    # spans are the outer's siblings, outside every span of the outer
    assert record["matmul:dft"]["count"] == 3
    assert record["matmul:twiddle"]["count"] == 1
    assert "matmul:relayout" not in record
    assert nesting(events) == {name: {None} for name in SPANS[:2]}


def test_a_tracer_takes_the_spans():
    run = roundtrip()
    with obs.tracing() as tr:
        run()
    names = [e["name"] for e in tr.events()]
    assert names.count("matmul:dft") == 8
    assert names.count("matmul:twiddle") == 0
    assert names.count("matmul:relayout") == 0
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


class _Writes(TorchDispatchMode):
    """The aten ops a scope dispatches, by name, and the elements they
    write: an ``out=`` or in-place op its target, any other op that is
    no view and no allocation its new result."""

    def __init__(self):
        super().__init__()
        self.ops, self.written = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        self.ops.append(name)
        info = func._schema.returns[0].alias_info if \
            func._schema.returns else None
        if isinstance(out, torch.Tensor) and "empty" not in name and (
                info is None or info.is_write):
            self.written += out.numel()
        return out


CELL = (1024, 1024, 1024)   # the default-plan cell's field, on meta


def _fused_writes(monkeypatch, log: _Writes) -> None:
    """Count the fused kernel's output as written in ``log``: on ``meta``
    its wrapper only allocates the output, which ``_Writes`` does not
    count, where on the card the kernel writes it once."""
    run = dft_rows.dft_rows

    def counted(x, *tables):
        out = run(x, *tables)
        log.ops.append("dft_rows")
        log.written += out.numel()
        return out
    monkeypatch.setattr(dft_rows, "dft_rows", counted)


@pytest.mark.parametrize("axis,passes", [(-3, 2), (-2, 2), (-1, 1)])
def test_an_axis_is_read_where_it_lies(axis, passes, monkeypatch):
    """Along each axis of a contiguous field: no copy, the products'
    outputs the only full passes (2 a strided axis; 1 the contiguous
    one, the fused kernel's output), 2 products, no layout copy.  On
    ``meta``: the cell's own shape, no values."""
    x = torch.empty(CELL, dtype=torch.complex64, device="meta")
    before = products(), layout_copies()
    with _Writes() as log:
        _fused_writes(monkeypatch, log)
        y = local_fft.fft_1d(x, axis, -1)
    assert y.shape == x.shape and y.is_contiguous()
    assert not {"clone", "copy_", "contiguous"} & set(log.ops), log.ops
    # the plan's tables (32 x 32 x 32 at most) round away
    assert round(log.written / x.numel(), 3) == passes
    assert (products() - before[0], layout_copies() - before[1]) == (2, 0)


def test_an_input_with_no_view_takes_one_counted_copy(monkeypatch):
    x = torch.empty(CELL, dtype=torch.complex64, device="meta")
    block = x[:, :512]          # a K-chunk: 1024 x 512 rows no longer merge
    before = products(), layout_copies()
    with _Writes() as log:
        _fused_writes(monkeypatch, log)
        local_fft.fft_1d(block, -1, -1)
    assert log.ops.count("clone") == 1
    assert round(log.written / block.numel(), 3) == 1 + 1
    assert (products() - before[0], layout_copies() - before[1]) == (2, 1)


@pytest.mark.parametrize("dtype, shape", [
    (torch.complex64, (4, 1024)), (torch.complex64, (3, 2, 128)),
    (torch.complex64, (1, 4096)),
    (torch.complex128, (4, 1024)), (torch.complex128, (3, 2, 128))])
def test_a_contiguous_axis_is_one_span_two_products_and_no_twiddle(
        dtype, shape, tmp_path, monkeypatch):
    """A two-level contiguous axis is one span, no ``matmul:twiddle``,
    ``matmul_dft_products`` +2: complex64 runs the fused kernel under
    ``matmul:dft`` (``matmul_fused_axes`` +1), complex128, which the
    kernel does not take, its plain version ``dft_rows_plain`` under
    ``matmul:plain`` (``matmul_plain_axes`` +1)."""
    x = field(shape).to(dtype)
    fused = dtype == torch.complex64
    name, other = (("matmul:dft", "matmul:plain") if fused
                   else ("matmul:plain", "matmul:dft"))
    calls = []
    plain = dft_rows.dft_rows_plain
    monkeypatch.setattr(dft_rows, "dft_rows_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = products(), fused_axes(), plain_axes()
    events, record = profiled_trace(lambda: local_fft.fft_matmul(x),
                                    tmp_path)
    assert record[name]["count"] == 1 and other not in record
    assert "matmul:twiddle" not in record and "matmul:relayout" not in record
    assert (products() - before[0], fused_axes() - before[1],
            plain_axes() - before[2]) == (2, int(fused), int(not fused))
    # on the CPU the kernel's wrapper runs the plain version too
    assert calls == [1]
    assert nesting(events)[name] == {None}


def test_a_roundtrip_counts_its_fused_axes():
    run = roundtrip()
    before = fused_axes()
    run()
    # the 128-point contiguous axis of the forward and of the inverse
    assert fused_axes() - before == 2
