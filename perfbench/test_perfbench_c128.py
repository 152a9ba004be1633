"""The ``croft1024-c128-default-plan`` cell: the default plan at complex128
run whole at its small grid, the float64 reference
(``reference/fft3d_f64.py``) against numpy and its control against the
cell's limits, and the cell's two readers (``dft_c128_roofline`` with
``harness/dft_work_c128.py``, ``plain_axis_ms_per_step``) on a synthetic
timeline and a made-up span record: nothing off the card, nothing where
nothing of their kind ran, the right reading otherwise."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cell, dft_work, dft_work_c128, fields, timeline
from perfbench.harness.spec import HERE, Bench
from perfbench.harness.traffic import Traffic

CELL = "croft1024-c128-default-plan"
CPU = torch.device("cpu")
E = 2 ** 30                       # the elements of a 1024^3 field
BW, FP64 = 3.35e12, 67e12
STEPS = 4
ZGEMM = ("sm90_xmma_gemm_cf64cf64_f64f64_cf64_nn_n_tilesize32x16x64_stage3_"
         "warpsize2x1x2_tensor16x8x16_execute_kernel__5x_cublas")
CUTLASS = ("void cutlass::Kernel2<cutlass_80_tensorop_z884gemm_32x32_16x4_"
           "tn_align1>(cutlass_80_tensorop_z884gemm_32x32_16x4_tn_align1::"
           "Params)")
DFT = ("void (anonymous namespace)::dft_rows_kernel<32, 32>(float2 const*, "
       "float2*, float2 const*, float2 const*, float2 const*, long long, "
       "long long)")
FFT4 = "void (anonymous namespace)::fft4step_kernel<32, 32, true>(float2*)"
TWIDDLE = "void at::native::elementwise_kernel<128, 2>(int, double2*)"
NCCL = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
KERNELS = {"dft_rows": ["dft_rows_kernel"], "fft4step": ["fft4step_kernel"]}


def roundtrip_work(grid, ranks=1):
    return cell.step_work({"grid": list(grid)},
                          Traffic.load(HERE / "traffic" / "roundtrip.json"),
                          ranks)


@pytest.fixture(scope="module")
def setup():
    bench = Bench()
    config = bench.config(bench.cell(CELL)["config"])
    return bench.reference(config["reference"]), bench.limits(CELL), config


def test_config_is_the_default_plan_in_double(setup):
    from repro_torch.core import FFTOptions
    _, _, config = setup
    assert config["dtype"] == "complex128" and config["reduced"] == []
    assert config["grid"] == [1024] * 3
    assert FFTOptions(**config["options"]) == FFTOptions()
    assert FFTOptions().to_token() == config["options_token"]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_whole(bench, trace):
    mine = cell.run_rank(bench, CELL, 2 ** 31 + 29, 0.05, trace, CPU,
                         time.time())
    res = cell.combine(bench, CELL, trace, [mine], CPU)
    json.dumps(res)
    assert res["correct"] is True and res["attempted"] >= 4
    assert set(res["checks"]) == {"spectrum_err", "field_err"}
    # float64 rounding, orders inside the limits
    assert all(c["value"] < 1e-3 * c["limit"]
               for c in res["checks"].values())
    if trace:
        # a CPU run reads no device metric
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"step_ms", "latency_p95_ms",
                                       "peak_gib", "setup_s"}


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_reference_passes_and_its_lower_precision_fails(setup, seed):
    """At the cell's small grid: the reference's ``"fp32"`` (float64
    products) is numpy's FFT within float64 rounding, far inside the
    limits; its ``"tf32"`` (float32 products, the control) fails them
    by more than a hundred times."""
    reference, limits, _ = setup
    shape = (16, 128, 128)
    full = tuple(slice(0, n) for n in shape)

    def source(a, b):
        return fields.planes(seed, shape, torch.complex128, a, b, CPU)
    x = source(0, shape[0])
    want = np.fft.fftn(x.numpy())

    def err(got):
        return float(np.abs(np.asarray(got) - want).max()
                     / np.abs(want).max())
    exact = reference.spectrum(source, shape, full,
                               reference.Arith("fp32", CPU))
    lower = reference.spectrum(source, shape, full,
                               reference.Arith("tf32", CPU))
    assert exact.dtype == torch.complex128 and lower.dtype == torch.complex64
    assert err(exact) < 1e-3 * limits["spectrum_err"]
    assert err(lower) > 1e2 * limits["spectrum_err"]
    back = reference.transform(lambda a, b: exact[a:b], shape, full, +1,
                               reference.Arith("fp32", CPU), planes=5)
    assert float((back - x).abs().max() / x.abs().max()) < \
        1e-3 * limits["field_err"]
    # the slabs cover the field in any size
    part = reference.transform(source, shape, (slice(3, 9), slice(0, 128),
                                                slice(100, 128)), -1,
                               reference.Arith("fp32", CPU), planes=7)
    assert float(np.abs(part.numpy() - want[3:9, :, 100:]).max()
                 / np.abs(want).max()) < 1e-13


def test_a_complex128_product_is_bound_by_its_bytes():
    # 32 bytes an element over 3.35 TB/s: 10.26 ms at 2^30 elements
    assert dft_work_c128.product_s(32, E) == pytest.approx(32 * E / BW)
    assert dft_work_c128.product_s(32, E) == pytest.approx(10.2564e-3,
                                                           rel=1e-4)
    # radix 64 too: its operations at the FP64 peak are under the bytes
    assert 8 * 64 * E / FP64 < 32 * E / BW
    assert dft_work_c128.product_s(64, E) == pytest.approx(32 * E / BW)
    # twice a complex64 product's bytes
    assert dft_work_c128.product_s(32, E) == pytest.approx(
        2 * dft_work.product_s(32, E))


@pytest.mark.parametrize("p", range(1, 13))
def test_an_axis_is_its_fewest_products(p):
    # every radix is bound by the bytes, so the least is the fewest
    # products: one up to 64 points, two up to 4096
    products = -(-p // 6)
    assert dft_work_c128.axis_least_s(2 ** p, E) == pytest.approx(
        products * 32 * E / BW)


def test_the_cells_least_is_twelve_products():
    step = roundtrip_work((1024,) * 3)
    assert dft_work_c128.step_least_s(step) == pytest.approx(
        12 * dft_work_c128.product_s(32, E))
    assert dft_work_c128.step_least_s(step) == pytest.approx(123.08e-3,
                                                             rel=1e-3)
    assert dft_work_c128.step_least_s(roundtrip_work((1024,) * 3, 4)) == \
        pytest.approx(dft_work_c128.step_least_s(step) / 4)


def _trace(products: bool, dft: bool = False):
    """A window 0..1000 us with the port's forward launching, when
    ``products``, two FP64 GEMMs (100-300, 400-500), when ``dft`` a
    ``dft_rows`` kernel (520-570), always a twiddle pass (600-650), an
    ``fft4step`` kernel (650-700) and an NCCL kernel (700-750); and a
    GEMM the harness's digest launched (850-900)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
           "ts": 0, "dur": 1000, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.forward",
           "ts": 10, "dur": 70, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.digest",
           "ts": 82, "dur": 10, "tid": 1}]
    kernels = [(TWIDDLE, 600, 50, 3, 30), (FFT4, 650, 50, 4, 40),
               (NCCL, 700, 50, 6, 45), (ZGEMM, 850, 50, 5, 85)]
    if products:
        kernels += [(ZGEMM, 100, 200, 1, 20), (CUTLASS, 400, 100, 2, 25)]
    if dft:
        kernels.append((DFT, 520, 50, 7, 50))
    for name, ts, dur, corr, launch in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 7, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": launch, "dur": 1, "tid": 1,
                   "args": {"correlation": corr}})
    return {"traceEvents": ev}


def ctx_of(trace, device_type="cuda", kernels=KERNELS):
    return cell.Context(device_type, STEPS, 1e-3, 0.1, None,
                        timeline.Timeline(trace), roundtrip_work((256,) * 3),
                        kernels, None, frozenset({"perfbench.forward"}))


@pytest.mark.parametrize("dft", [False, True])
def test_dft_c128_roofline_reads_the_products_kernels(dft):
    """The port's GEMMs, cuBLAS's and CUTLASS's, and a ``csrc/dft*``
    kernel where one ran; not the twiddle pass, ``fft4step``, NCCL or
    the harness's digest."""
    reader = Bench().reader("dft_c128_roofline")
    assert reader.COMBINE == "min"
    ctx = ctx_of(_trace(products=True, dft=dft))
    busy = (300 + 50 * dft) * 1e-6
    want = 100 * dft_work_c128.step_least_s(ctx.work) / (busy / STEPS)
    assert reader.read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("why", ["cpu", "no_products"])
def test_dft_c128_roofline_reads_nothing_where_nothing_ran(why):
    reader = Bench().reader("dft_c128_roofline")
    ctx = {"cpu": lambda: ctx_of(_trace(products=True), "cpu"),
           "no_products": lambda: ctx_of(_trace(products=False))}[why]()
    assert reader.read(ctx) is None


@dataclasses.dataclass
class SpanCtx:
    card: bool
    steps: int = STEPS

    def on_card(self) -> bool:
        return self.card


def row(count, device_s):
    return {"count": count, "host_s": 1e-3 * count, "device_s": device_s}


RECORD = {"stage:fft": row(6 * STEPS, 9.0), "matmul:dft": row(8 * STEPS, 4.0),
          "matmul:plain": row(2 * STEPS, 0.3)}


def test_plain_axis_ms_per_step_reads_the_plain_spans(monkeypatch):
    import repro_torch.obs
    reader = Bench().reader("plain_axis_ms_per_step")
    assert reader.COMBINE == "max"
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: RECORD)
    assert reader.read(SpanCtx(card=True)) == pytest.approx(0.3 / STEPS * 1e3)
    assert reader.read(SpanCtx(card=False)) is None


def test_plain_axis_ms_per_step_reads_nothing_without_the_span(monkeypatch):
    """A program that keeps no record, one whose contiguous axes all ran
    the fused kernel (cell 4) or a parent without the span, or spans timed
    on no card: nothing, and no raise."""
    import repro_torch.obs
    reader = Bench().reader("plain_axis_ms_per_step")
    monkeypatch.delattr(repro_torch.obs, "profiled")
    assert reader.read(SpanCtx(card=True)) is None
    others = {k: v for k, v in RECORD.items() if k != "matmul:plain"}
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: others,
                        raising=False)
    assert reader.read(SpanCtx(card=True)) is None
    untimed = {k: dict(v, device_s=None) for k, v in RECORD.items()}
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: untimed)
    assert reader.read(SpanCtx(card=True)) is None
