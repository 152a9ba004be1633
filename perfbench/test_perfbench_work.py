"""The yardstick's arithmetic against hand-computed values: the work
counts, the exact p95, and the reading of a synthetic chrome trace."""

import dataclasses
import math

import pytest

from perfbench.harness import cell, timeline, work
from perfbench.harness.traffic import Traffic
from perfbench.harness.spec import HERE

GIB = 2 ** 30
BW, FP32 = 3.35e12, 67e12


def test_peaks_are_the_data_sheet_h100():
    assert (work.HBM_BYTES_S, work.FP32_FLOP_S, work.BF16_FLOP_S) == \
        (3.35e12, 67e12, 989e12)
    assert work.bound_s(BW, 1.0) == (1.0, "bytes")
    assert work.bound_s(1.0, FP32) == (1.0, "operations")


def test_c2c_1024_roundtrip():
    grid = (1024,) * 3
    step = cell.step_work({"grid": list(grid)},
                          Traffic.load(HERE / "traffic" / "roundtrip.json"), 1)
    # a pass reads and writes the 8 GiB field: 16 GiB over 3.35 TB/s,
    # above its 5 * 2^30 * 10 operations over 67 TFLOP/s
    per_pass = 16 * GIB / BW
    assert 5 * 2 ** 30 * 10 / FP32 < per_pass
    assert step.fft_least_s() == pytest.approx(2 * 3 * per_pass)
    # x read and y written, y read and x2 written: 32 GiB
    assert step.step_least_s() == pytest.approx(32 * GIB / BW)
    assert step.step_least_s() == pytest.approx(10.2564e-3, rel=1e-4)
    assert step.realpipe_least_s() == 0.0


def test_r2c_1024_poisson():
    grid = (1024,) * 3
    step = cell.step_work({"grid": list(grid)},
                          Traffic.load(HERE / "traffic" / "poisson.json"), 1)
    # six passes over the 4 GiB half-size complex array
    assert step.fft_least_s() == pytest.approx(6 * 8 * GIB / BW)
    half = 1024 * 1024 * 513 * 8
    assert step.step_least_s() == pytest.approx(
        max(2 * (4 * GIB + half) / BW, 2 * 2.5 * 2 ** 30 * 30 / FP32))
    # split and extension: 4 GiB in, 4 GiB out each; the multiply reads
    # and writes the half spectrum and reads a float32 multiplier
    want = (2 * 8 * GIB + 1024 * 1024 * 513 * 20) / BW
    assert step.realpipe_least_s() == pytest.approx(want)
    assert want == pytest.approx(8.340e-3, rel=1e-3)


@pytest.mark.parametrize("grid, per_pass_gib", [((2048, 2048, 2048), 32),
                                                ((2048, 2048, 1024), 16)])
def test_c2c_pencil4_rank_share(grid, per_pass_gib):
    step = cell.step_work({"grid": list(grid)},
                          Traffic.load(HERE / "traffic" / "roundtrip.json"), 4)
    points = math.prod(grid)
    assert step.fft_least_s() == pytest.approx(6 * per_pass_gib * GIB / BW)
    flops = 2 * 5 * points * math.log2(points) / 4
    nbytes = 4 * points * 8 / 4
    assert step.step_least_s() == pytest.approx(max(nbytes / BW,
                                                     flops / FP32))
    if grid[2] == 2048:
        assert step.step_least_s() == pytest.approx(20.513e-3, rel=1e-4)


@pytest.mark.parametrize("n, q, want", [(100, 95, 95), (20, 95, 19),
                                        (200, 95, 190), (1, 95, 1),
                                        (7, 50, 4)])
def test_exact_percentile(n, q, want):
    values = list(range(n, 0, -1))          # order does not matter
    assert cell.percentile(values, q) == want


def _trace():
    """A window 0..1000 us: fft4step 100-400 and 600-700, an NCCL kernel
    350-500 and 650-900, a copy 920-950; launches under perfbench ranges
    on thread 1."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
           "ts": 0, "dur": 1000, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.forward",
           "ts": 10, "dur": 60, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.digest",
           "ts": 80, "dur": 10, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
           "ts": 950, "dur": 40, "tid": 1}]
    kernels = [("void (anonymous namespace)::fft4step_kernel<32, 32, true>"
                "(float2 const*)", 100, 300, 1, 20),
               ("void (anonymous namespace)::fft4step_kernel<64, 32, false>"
                "(float2 const*)", 600, 100, 2, 30),
               ("ncclDevKernel_SendRecv(ncclDevComm*)", 350, 150, 3, 40),
               ("ncclDevKernel_SendRecv(ncclDevComm*)", 650, 250, 4, 50),
               ("Memcpy DtoD (Device -> Device)", 920, 30, 5, 85)]
    for name, ts, dur, corr, launch in kernels:
        ev.append({"ph": "X", "cat": "gpu_memcpy" if "Memcpy" in name
                   else "kernel", "name": name, "ts": ts, "dur": dur,
                   "tid": 7, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": launch, "dur": 1, "tid": 1,
                   "args": {"correlation": corr}})
    return {"traceEvents": ev}


def test_timeline_intervals():
    tl = timeline.Timeline(_trace())
    assert tl.window_s == pytest.approx(1e-3)
    # busy: 100-500, 600-900, 920-950
    assert tl.busy_s() == pytest.approx(730e-6)
    fft = timeline.name_matcher(["fft4step_kernel"])
    assert tl.time_s(tl.select(lambda op: fft(op[0]))) == pytest.approx(400e-6)
    nccl = tl.select(lambda op: timeline.is_nccl(op[0]))
    # NCCL alone: 400-500 and 700-900
    assert tl.exposed_s(nccl) == pytest.approx(300e-6)
    assert [op[3] for op in tl.ops] == ["perfbench.forward"] * 4 + \
        ["perfbench.digest"]
    gaps = dict(tl.idle_gaps())
    assert gaps == pytest.approx({"perfbench.forward > python": 100e-6,
                                  "perfbench.window > python": 120e-6,
                                  "perfbench.window > aten::copy_": 50e-6})
    assert tl.top_ops(1)[0][0].startswith("ncclDevKernel")


def test_handwritten_kernel_names():
    names = timeline.handwritten_kernels(HERE.parent / "src" / "repro_torch"
                                         / "kernels" / "csrc")
    assert "fft4step_kernel" in names["fft4step"]
    assert {"unpack_kernel", "extend_kernel"} <= set(names["hermitian"])
    match = timeline.name_matcher(names["spectral_scale"])
    assert match("void (anonymous namespace)::scale_kernel<1>(float2 const*)")
    assert not match("void at::native::unscale_kernel(float*)")


def test_readers_on_a_synthetic_trace():
    from perfbench.harness.spec import Bench
    bench = Bench()
    step = cell.step_work({"grid": [64, 64, 64]},
                          Traffic.load(HERE / "traffic" / "roundtrip.json"), 1)
    ctx = cell.Context("cuda", 1, 2e-3, 0.25, 1.5, timeline.Timeline(_trace()),
                       step, {"fft4step": ["fft4step_kernel"],
                              "hermitian": ["unpack_kernel"]},
                       8e6, frozenset({"perfbench.forward"}))
    got = {m: bench.reader(m).read(ctx) for m in
           ("plan_s", "mesh_s", "fft4step_roofline", "realpipe_roofline",
            "glue_ms_per_step", "a2a_GBps", "exposed_comm_pct",
            "device_idle_pct", "step_mfu_pct")}
    assert got == pytest.approx({
        "plan_s": 0.25, "mesh_s": 1.5,
        "fft4step_roofline": 100 * step.fft_least_s() / 400e-6,
        "realpipe_roofline": None,          # no real pipeline in the step
        "glue_ms_per_step": 0.0,            # the copy came from the digest
        "a2a_GBps": 8e6 / 400e-6 / 1e9,
        "exposed_comm_pct": 30.0, "device_idle_pct": 27.0,
        "step_mfu_pct": 100 * step.step_least_s() / 2e-3})
    cpu = dataclasses.replace(ctx, device_type="cpu")
    assert bench.reader("device_idle_pct").read(cpu) is None
