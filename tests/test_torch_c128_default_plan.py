"""The default plan, ``Croft3D(shape, dtype=torch.complex128)`` with
``FFTOptions()``, at the paper's double precision, and the executor's
donated axis outputs (``core/schedule.py:run_schedule`` ->
``core/local_fft.py:fft_matmul``).

Shapes: (16, 16, 16) runs every axis as one DFT product; (4, 128, 128)
runs y as a two-level strided axis and z as the two-level contiguous
axis's plain version (``kernels/dft_rows.dft_rows_plain``, the fused
kernel takes complex64 only), both with their outputs written into the
executor's dead input blocks.

Tolerance: ``C128_TOL`` of the largest magnitude, against numpy's FFT
and against the benchmark's float64 reference
(``perfbench/reference/fft3d_f64.py``).  Float64 rounding over these
sums leaves about 1e-14 of the largest; complex64 arithmetic leaves
about 2e-7, so a path that dropped to single precision anywhere fails
by five orders (checked below)."""

import numpy as np
import pytest
import torch

from perfbench.harness import fields
from perfbench.reference import fft3d_f64
from repro_torch.core import Croft3D, FFTOptions, local_fft
from repro_torch.obs import metrics
from test_torch_obs_spans import nesting, profiled_trace

C128_TOL = 1e-12
SHAPES = [(16, 16, 16), (4, 128, 128)]
CPU = torch.device("cpu")


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def field(shape, dtype=torch.complex128, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, dtype=dtype, generator=g)


def count(name) -> float:
    found = metrics.get_registry().get(name)
    return 0.0 if found is None else found.value


@pytest.mark.parametrize("shape", SHAPES)
def test_default_plan_in_double_against_numpy_and_the_reference(shape):
    seed = 2 ** 31 + 41
    x = fields.block(seed, shape, torch.complex128,
                     [slice(0, n) for n in shape], CPU)
    plan = Croft3D(shape, dtype=torch.complex128, device="cpu")
    assert plan.opts == FFTOptions()
    y = plan.forward(x)
    assert y.dtype == torch.complex128
    want = np.fft.fftn(x.numpy())
    assert rel_err(y, want) <= C128_TOL
    ref = fft3d_f64.spectrum(
        lambda a, b: fields.planes(seed, shape, torch.complex128, a, b, CPU),
        shape, tuple(slice(0, n) for n in shape),
        fft3d_f64.Arith("fp32", CPU))
    assert rel_err(y, ref) <= C128_TOL
    back = plan.inverse(y)
    assert rel_err(back, np.fft.ifftn(want)) <= C128_TOL
    assert rel_err(back, x) <= C128_TOL
    # single precision anywhere fails the tolerance by orders
    y64 = Croft3D(shape, device="cpu").forward(x.to(torch.complex64))
    assert rel_err(y64, want) > 1e3 * C128_TOL


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_caller_s_input_is_never_written(dtype, shape):
    x = field(shape, dtype)
    keep = x.clone()
    plan = Croft3D(shape, dtype=dtype, device="cpu")
    y = plan.forward(x)
    assert torch.equal(x, keep)
    y_keep = y.clone()
    plan.inverse(y)
    assert torch.equal(y, y_keep) and torch.equal(x, keep)


@pytest.mark.parametrize("dtype,axis,donated", [
    (torch.complex128, 1, True),     # strided, two products
    (torch.complex128, 2, True),     # contiguous, the plain version
    (torch.complex64, 1, True),
    (torch.complex64, 2, False),     # contiguous, the fused kernel
    (torch.complex128, 0, False),    # 4 points: one product
])
def test_a_donated_axis_output_takes_its_input_s_storage(dtype, axis,
                                                         donated):
    x = field((4, 128, 128), dtype)
    want = local_fft.fft_matmul(x, axis=axis)
    assert want.data_ptr() != x.data_ptr()
    before = count(local_fft.DONATED_OUTPUTS)
    got = local_fft.fft_matmul(x, axis=axis, donate=True)
    assert (got.data_ptr() == x.data_ptr()) == donated
    assert count(local_fft.DONATED_OUTPUTS) - before == int(donated)
    # the same arithmetic, bit for bit
    assert torch.equal(got, want)


@pytest.mark.parametrize("make", ["chunk", "transposed", "grad"])
def test_no_donation_of_a_slice_a_relayout_or_a_block_autograd_follows(
        make):
    """A K-chunk (a slice of a larger block), an input without an
    ``(A, N, C)`` view (copied first) and a block that requires grad keep
    their storage, whatever the caller says."""
    big = field((8, 128, 128))
    x = {"chunk": lambda: big[:4], "transposed": lambda: big.transpose(0, 1),
         "grad": lambda: big.clone().requires_grad_()}[make]()
    keep = x.detach().clone()
    before = count(local_fft.DONATED_OUTPUTS)
    got = local_fft.fft_matmul(x, axis=2, donate=True)
    assert count(local_fft.DONATED_OUTPUTS) == before
    assert torch.equal(x.detach(), keep)
    assert torch.equal(got.detach(), local_fft.fft_matmul(keep, axis=2))
    if make == "grad":
        got.real.sum().backward()
        want = keep.clone().requires_grad_()
        torch.fft.fft(want, dim=2).real.sum().backward()
        assert rel_err(x.grad, want.grad) <= C128_TOL


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_donation_leaves_the_outputs_bitwise_as_without_it(dtype):
    """The executor's round trip against the same axes run one by one
    with no donation: equal bit for bit."""
    shape = (4, 128, 128)
    x = field(shape, dtype)
    plan = Croft3D(shape, dtype=dtype, device="cpu")
    y = plan.forward(x)
    want = x
    for axis in range(3):
        want = local_fft.fft_matmul(want, -1, axis=axis)
    assert torch.equal(y, want)
    for axis in range(3):
        want = local_fft.fft_matmul(want, +1, axis=axis)
    assert torch.equal(plan.inverse(y), want / x.numel())


def test_gradients_at_complex128_with_donation():
    """A gradient check of the default plan at complex128 on a grid whose
    y and z axes donate: ``gradcheck``'s projected form, and ``x.grad``
    against ``torch.fft`` autograd."""
    shape = (2, 128, 128)
    plan = Croft3D(shape, dtype=torch.complex128, device="cpu")
    x = field(shape, seed=9).requires_grad_()
    assert torch.autograd.gradcheck(plan.forward, (x,), eps=1e-6,
                                     atol=1e-6, fast_mode=True)
    g = field(shape, seed=10)
    before = count(local_fft.DONATED_OUTPUTS)
    (plan.forward(x) * g).real.sum().backward()
    # the forward's y and z axes donate; the backward runs z, y, x, and
    # its z axis reads the caller's gradient, which is never written
    assert count(local_fft.DONATED_OUTPUTS) - before == 3
    want = x.detach().clone().requires_grad_()
    (torch.fft.fftn(want) * g).real.sum().backward()
    assert rel_err(x.grad, want.grad) <= C128_TOL


@pytest.mark.parametrize("dtype,donated,plain", [
    (torch.complex64, 2, 0), (torch.complex128, 4, 2)])
def test_a_round_trip_counts_its_donated_outputs_and_plain_axes(
        dtype, donated, plain, tmp_path):
    """(4, 128, 128): the y axis of each transform donates; complex128's
    z axis runs the plain version, one ``matmul:plain`` span inside
    ``stage:fft``, and donates too."""
    shape = (4, 128, 128)
    plan = Croft3D(shape, dtype=dtype, device="cpu")
    x = field(shape, dtype)
    before = (count(local_fft.DONATED_OUTPUTS),
              count(local_fft.PLAIN_AXES), count(local_fft.FUSED_AXES))
    events, record = profiled_trace(lambda: plan.inverse(plan.forward(x)),
                                    tmp_path)
    after = (count(local_fft.DONATED_OUTPUTS),
             count(local_fft.PLAIN_AXES), count(local_fft.FUSED_AXES))
    assert [a - b for a, b in zip(after, before)] == [donated, plain,
                                                      2 - plain]
    if plain:
        assert record["matmul:plain"]["count"] == plain
        assert nesting(events)["matmul:plain"] == {"stage:fft"}
    else:
        assert "matmul:plain" not in record
