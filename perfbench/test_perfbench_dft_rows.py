"""The reader of ``dft_rows_roofline`` (the fused contiguous-axis kernel
``csrc/dft_rows.cu``) on a synthetic timeline: the least of a pass
against hand-computed values, nothing off the card or where the kernel
never ran (a program without it), the right share otherwise."""

import pytest

from perfbench.harness import cell, timeline
from perfbench.harness.spec import HERE, Bench
from perfbench.harness.traffic import Traffic

E = 2 ** 30                       # the elements of a 1024^3 field
BW, FP32 = 3.35e12, 67e12
DFT = ("void (anonymous namespace)::dft_rows_kernel<32, 32>(float2 const*, "
       "float2*, float2 const*, float2 const*, float2 const*, long long, "
       "long long)")
GEMM = "void gemmSN_NN_kernel<float2, 256, 4, 2, 8, 4, 4, false>(float2*)"
STEPS = 4


def roundtrip_work(grid, ranks=1):
    return cell.step_work({"grid": list(grid)},
                          Traffic.load(HERE / "traffic" / "roundtrip.json"),
                          ranks)


def test_least_of_1024_is_two_32_point_products_in_one_pass():
    reader = Bench().reader("dft_rows_roofline")
    # 32 x 32: 8 * 64 operations an element, above the bytes of one pass
    assert reader.axis_least_s(1024, E) == pytest.approx(8 * 64 * E / FP32)
    assert reader.axis_least_s(1024, E) == pytest.approx(8.2053e-3, rel=1e-4)
    assert 16 * E / BW < reader.axis_least_s(1024, E)
    # 16 x 8 at 128 points: the bytes bound it
    assert reader.axis_least_s(128, E) == pytest.approx(16 * E / BW)


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
def test_the_least_split_is_the_most_even(n):
    reader = Bench().reader("dft_rows_roofline")
    n1 = 1 << (n.bit_length() // 2)        # n1 >= n2, as the plan splits
    want = max(16 * E / BW, 8 * (n1 + n // n1) * E / FP32)
    assert reader.axis_least_s(n, E) == pytest.approx(want)


def test_a_step_holds_one_pass_a_c2c_transform():
    reader = Bench().reader("dft_rows_roofline")
    step = roundtrip_work((1024,) * 3)
    assert reader.step_least_s(step) == pytest.approx(
        2 * reader.axis_least_s(1024, E))
    quarter = roundtrip_work((1024,) * 3, ranks=4)
    assert reader.step_least_s(quarter) == pytest.approx(
        reader.step_least_s(step) / 4)
    # no pass for an axis the kernel does not take
    assert reader.step_least_s(roundtrip_work((64,) * 3)) == 0
    assert reader.step_least_s(roundtrip_work((8192, 4, 8192))) == 0


def _trace(dft: bool):
    """A window 0..1000 us with the port's forward launching a GEMM
    100-300 and, when ``dft``, the kernel 400-700."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
           "ts": 0, "dur": 1000, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.forward",
           "ts": 10, "dur": 60, "tid": 1}]
    kernels = [(GEMM, 100, 200, 1, 20)]
    if dft:
        kernels.append((DFT, 400, 300, 2, 30))
    for name, ts, dur, corr, launch in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 7, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": launch, "dur": 1, "tid": 1,
                   "args": {"correlation": corr}})
    return {"traceEvents": ev}


def ctx_of(trace, device_type="cuda", kernels=None):
    kernels = {"dft_rows": ["dft_rows_kernel"]} if kernels is None \
        else kernels
    return cell.Context(device_type, STEPS, 1e-3, 0.1, None,
                        timeline.Timeline(trace), roundtrip_work((256,) * 3),
                        kernels, None, frozenset({"perfbench.forward"}))


def test_reader_reads_the_kernel_s_device_time():
    reader = Bench().reader("dft_rows_roofline")
    assert reader.COMBINE == "min"
    ctx = ctx_of(_trace(dft=True))
    # 300 us of the kernel in 4 steps; the GEMM is left out
    want = 100 * reader.step_least_s(ctx.work) / (300e-6 / STEPS)
    assert reader.read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("why", ["cpu", "not_launched", "no_source"])
def test_reader_reads_nothing_where_the_kernel_never_ran(why):
    """Off the card, in a step that launched no such kernel, and in a
    program whose ``csrc/`` has no ``dft_rows.cu``: nothing, no raise."""
    reader = Bench().reader("dft_rows_roofline")
    ctx = {"cpu": lambda: ctx_of(_trace(dft=True), "cpu"),
           "not_launched": lambda: ctx_of(_trace(dft=False)),
           "no_source": lambda: ctx_of(
               _trace(dft=True), kernels={"fft4step": ["fft4step_kernel"]}),
           }[why]()
    assert reader.read(ctx) is None
