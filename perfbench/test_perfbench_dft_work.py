"""The least work of the matmul local FFT's DFT products
(``harness/dft_work.py``) against hand-computed values and every
factorisation, and the readers of the ``Local FFT (matmul)`` layer on a
synthetic timeline and a made-up span record: nothing off the card,
nothing where nothing of their kind ran, the right share otherwise."""

import dataclasses

import pytest

from perfbench.harness import cell, dft_work, timeline, work
from perfbench.harness.spec import HERE, Bench
from perfbench.harness.traffic import Traffic

E = 2 ** 30                       # the elements of a 1024^3 field
BW, FP32 = 3.35e12, 67e12
GEMM = "void gemmSN_NN_kernel<float2, 256, 4, 2, 8, 4, 4, false>(float2*)"
FFT4 = "void (anonymous namespace)::fft4step_kernel<32, 32, true>(float2*)"
COPY = "void at::native::elementwise_kernel<128, 2>(int, float2*)"
STEPS = 4


def roundtrip_work(grid, ranks=1):
    return cell.step_work({"grid": list(grid)},
                          Traffic.load(HERE / "traffic" / "roundtrip.json"),
                          ranks)


def test_a_product_reads_and_writes_once_and_does_8_r_e_operations():
    # radix 32: bytes bound it (17.2 GB over 3.35 TB/s above 2.75e11
    # operations over 67 TFLOP/s); radix 64: operations bound it
    assert dft_work.product_s(32, E) == pytest.approx(16 * E / BW)
    assert 8 * 32 * E / FP32 < 16 * E / BW
    assert dft_work.product_s(64, E) == pytest.approx(8 * 64 * E / FP32)


def test_least_of_1024_is_two_32_point_products():
    assert dft_work.axis_least_s(1024, E) == pytest.approx(
        2 * dft_work.product_s(32, E))
    # 64 x 16 is dearer: the 64-point product is bound by operations
    assert dft_work.axis_least_s(1024, E) < dft_work.product_s(64, E) + \
        dft_work.product_s(16, E)
    assert dft_work.axis_least_s(1024, E) == pytest.approx(10.2564e-3,
                                                           rel=1e-4)


def factorisations(p: int, most: int = 6):
    """Every ordered factorisation of 2^p into radices 2^1 .. 2^most."""
    if p == 0:
        yield ()
        return
    for q in range(1, min(p, most) + 1):
        for rest in factorisations(p - q, most):
            yield (2 ** q,) + rest


@pytest.mark.parametrize("p", range(1, 13))
def test_no_factorisation_is_cheaper(p):
    least = dft_work.axis_least_s(2 ** p, E)
    sums = [sum(dft_work.product_s(r, E) for r in f)
            for f in factorisations(p)]
    # the least is one of them, and none is below it
    assert min(sums) == pytest.approx(least)
    assert all(s >= least * (1 - 1e-12) for s in sums)


def test_the_cells_least_is_twelve_32_point_products():
    step = roundtrip_work((1024,) * 3)
    assert dft_work.step_least_s(step) == pytest.approx(
        12 * dft_work.product_s(32, E))
    assert dft_work.step_least_s(step) == pytest.approx(61.54e-3, rel=1e-3)
    # on four ranks each holds a quarter
    quarter = roundtrip_work((1024,) * 3, ranks=4)
    assert dft_work.step_least_s(quarter) == pytest.approx(
        dft_work.step_least_s(step) / 4)


def _trace(gemm: bool):
    """A window 0..1000 us with the port's forward launching, under
    ``perfbench.forward``: a GEMM 100-300 and 400-500 (when ``gemm``),
    an ``fft4step`` kernel 600-700 and a copy 700-800; and a GEMM the
    harness's digest launched, 850-900."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
           "ts": 0, "dur": 1000, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.forward",
           "ts": 10, "dur": 60, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.digest",
           "ts": 80, "dur": 10, "tid": 1}]
    kernels = [(FFT4, 600, 100, 3, 30), (COPY, 700, 100, 4, 40),
               (GEMM, 850, 50, 5, 85)]
    if gemm:
        kernels += [(GEMM, 100, 200, 1, 20), (GEMM, 400, 100, 2, 25)]
    for name, ts, dur, corr, launch in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 7, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": launch, "dur": 1, "tid": 1,
                   "args": {"correlation": corr}})
    return {"traceEvents": ev}


def ctx_of(trace, device_type="cuda"):
    return cell.Context(device_type, STEPS, 1e-3, 0.1, None,
                        timeline.Timeline(trace), roundtrip_work((64,) * 3),
                        {"fft4step": ["fft4step_kernel"]}, None,
                        frozenset({"perfbench.forward"}))


def test_dft_gemm_roofline_reads_the_port_s_gemms():
    reader = Bench().reader("dft_gemm_roofline")
    assert reader.COMBINE == "min"
    ctx = ctx_of(_trace(gemm=True))
    # 300 us of the port's GEMMs in 4 steps; the digest's is left out,
    # as are the hand-written kernel and the copy
    want = 100 * dft_work.step_least_s(ctx.work) / (300e-6 / STEPS)
    assert reader.read(ctx) == pytest.approx(want)
    assert reader.read(ctx_of(_trace(gemm=True), "cpu")) is None
    assert reader.read(ctx_of(_trace(gemm=False))) is None
    assert reader.is_gemm("ampere_cgemm_32x32_tn") and \
        not reader.is_gemm(COPY)


def row(count, device_s):
    return {"count": count, "host_s": 1e-3 * count, "device_s": device_s}


RECORD = {
    "stage:fft": row(6 * STEPS, 9.0),        # the stage around: left out
    "matmul:dft": row(8 * STEPS, 0.4),
    "matmul:twiddle": row(2 * STEPS, 0.1),
    "matmul:relayout": row(2 * STEPS, 0.3),
    "inverse:normalize": row(STEPS, 0.05),
}


@dataclasses.dataclass
class SpanCtx:
    card: bool
    steps: int = STEPS
    work: object = dataclasses.field(
        default_factory=lambda: roundtrip_work((1024,) * 3))

    def on_card(self) -> bool:
        return self.card


@pytest.fixture
def record(monkeypatch):
    import repro_torch.obs
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: RECORD)


def test_span_readers(record):
    bench = Bench()
    fft = bench.reader("matmul_fft_roofline")
    glue = bench.reader("matmul_glue_ms_per_step")
    assert (fft.COMBINE, glue.COMBINE) == ("min", "max")
    ctx = SpanCtx(card=True)
    assert fft.read(ctx) == pytest.approx(
        100 * ctx.work.fft_least_s() / ((0.4 + 0.1 + 0.3) / STEPS))
    assert glue.read(ctx) == pytest.approx((0.1 + 0.3) / STEPS * 1e3)
    assert fft.read(SpanCtx(card=False)) is None
    assert glue.read(SpanCtx(card=False)) is None


@pytest.mark.parametrize("metric", ["matmul_fft_roofline",
                                    "matmul_glue_ms_per_step"])
def test_span_reader_reads_nothing_without_the_record(monkeypatch, metric):
    """A program that keeps no record, one that ran no matmul local FFT
    (the other cells' ``pallas``), or spans timed on no card, gives
    nothing and raises nothing."""
    import repro_torch.obs
    reader = Bench().reader(metric)
    monkeypatch.delattr(repro_torch.obs, "profiled")
    assert reader.read(SpanCtx(card=True)) is None
    others = {k: v for k, v in RECORD.items() if not k.startswith("matmul:")}
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: others,
                        raising=False)
    assert reader.read(SpanCtx(card=True)) is None
    untimed = {k: dict(v, device_s=None) for k, v in RECORD.items()}
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: untimed)
    assert reader.read(SpanCtx(card=True)) is None


def test_the_whole_fft_least_is_below_the_products_least():
    # the implementation-free count of matmul_fft_roofline (a pass's
    # bytes, or 5 N log2 N) is under the products' least, and the spans
    # it is divided by hold the products: it reads below
    # dft_gemm_roofline
    step = roundtrip_work((1024,) * 3)
    assert step.fft_least_s() == pytest.approx(30.77e-3, rel=1e-3)
    assert step.fft_least_s() < dft_work.step_least_s(step)
    assert work.Transform("c2c", (1024,) * 3).fft_passes_s() == \
        pytest.approx(3 * 16 * E / BW)
