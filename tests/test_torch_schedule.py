"""The port's stage-schedule IR, options and decompositions
(``repro_torch.core.schedule``/``distributed``/``decomposition``/``api``)
against the JAX reference: the same ``describe()`` strings, counts and
tokens, and the same validation errors."""

import itertools
import math

import pytest
import torch

from repro.core import Decomposition as RefDecomposition
from repro.core import FFTOptions as RefOptions
from repro.core import schedule as ref_schedule
from repro.core.decomposition import pencil_grid_for as ref_pencil_grid_for
from repro.core.distributed import build_schedule as ref_build
from repro_torch.core import Croft3D, Decomposition, FFTOptions
from repro_torch.core import distributed
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.decomposition import pencil_grid_for, spec_slices
from repro_torch.core.distributed import build_schedule
from repro_torch.core.mesh import Pending
from repro_torch.obs import metrics as metrics_lib

AXES = {"pencil": ("data", "model"), "slab": ("p",), "cell": ("a", "b", "c"),
        "pencil-folded": (("a", "b"), "c")}
SIZES = {"data": 2, "model": 4, "p": 8, "a": 2, "b": 2, "c": 2}
CASES = [(kind, layout, sign) for kind in AXES
         for layout in ("natural", "spectral") for sign in (-1, +1)]


def _decomps(kind):
    name = kind.split("-")[0]
    return Decomposition(name, AXES[kind]), RefDecomposition(name, AXES[kind])


def _both(kind, layout, sign, **kw):
    """(port schedule, reference schedule), or the reference's error."""
    dec, ref_dec = _decomps(kind)
    try:
        want = ref_build(ref_dec, RefOptions(output_layout=layout, **kw), sign)
    except ref_schedule.ScheduleError as e:
        with pytest.raises(schedule_lib.ScheduleError, match=str(e)):
            build_schedule(dec, FFTOptions(output_layout=layout, **kw), sign)
        return None, None
    return build_schedule(dec, FFTOptions(output_layout=layout, **kw), sign), want


@pytest.mark.parametrize("kind,layout,sign", CASES)
def test_describe_matches_reference(kind, layout, sign):
    ours, want = _both(kind, layout, sign)
    if want is not None:
        assert ours.describe() == want.describe()
        assert ours.transpose_count() == want.transpose_count()


@pytest.mark.parametrize("kind,layout,sign", CASES)
def test_schedule_counts_match_reference(kind, layout, sign):
    ours, want = _both(kind, layout, sign)
    if want is None:
        return
    for shape in ((32, 32, 32), (64, 16, 8)):
        for k in (1, 2, 3, 4, 16):
            assert ours.effective_k(shape, SIZES, k) == \
                want.effective_k(shape, SIZES, k)
        assert ours.fft_events(shape, SIZES) == want.fft_events(shape, SIZES)
        assert ours.comm_events(shape, SIZES) == want.comm_events(shape, SIZES)
    assert ours.layout_in.partition_spec() == tuple(
        want.layout_in.partition_spec())
    assert ours.layout_out.partition_spec() == tuple(
        want.layout_out.partition_spec())


@pytest.mark.parametrize("kind", sorted(AXES))
def test_specs_and_local_shapes_match_reference(kind):
    dec, ref_dec = _decomps(kind)
    assert dec.partition_spec() == tuple(ref_dec.partition_spec())
    assert dec.spectral_spec() == tuple(ref_dec.spectral_spec())
    for which in ("natural", "spectral"):
        assert str(schedule_lib.layout_for(dec, which)) == \
            str(ref_schedule.layout_for(ref_dec, which))
    shape = (32, 32, 32)
    assert dec.local_shape(shape, SIZES) == ref_dec.local_shape(shape, SIZES)
    assert dec.n_procs(SIZES) == ref_dec.n_procs(SIZES)
    # the slices of all ranks tile the grid exactly once
    names = sorted({a for e in dec.partition_spec() if e
                    for a in (e if isinstance(e, tuple) else (e,))})
    covered = 0
    for flat in range(math.prod(SIZES[a] for a in names)):
        coords, rest = {}, flat
        for a in reversed(names):
            coords[a], rest = rest % SIZES[a], rest // SIZES[a]
        sl = dec.slices(shape, SIZES, coords)
        assert tuple(s.stop - s.start for s in sl) == \
            dec.local_shape(shape, SIZES)
        covered += math.prod(s.stop - s.start for s in sl)
    assert covered == math.prod(shape)


def test_spec_slices_fold_major_first():
    sl = spec_slices((None, ("a", "b"), "c"), (8, 8, 8),
                     {"a": 2, "b": 2, "c": 2}, {"a": 1, "b": 0, "c": 1})
    assert sl == (slice(0, 8), slice(4, 6), slice(4, 8))


DECOMP_TOKENS = [("pencil", ("y", "z")), ("slab", ("p",)),
                 ("cell", ("a", "b", "c")), ("pencil", (("pod", "data"), "z"))]
OPTION_SETS = [dict(), dict(overlap_k=1, plan_cache=False),
               dict(local_impl=("matmul", "stockham", "xla"),
                    transpose_impl="ring",
                    overlap_mode=("pipelined", "unrolled", "unrolled")),
               dict(local_impl="pallas", output_layout="spectral",
                    transpose_impl="pairwise", overlap_k=4),
               dict(local_impl=("xla",) * 3, overlap_mode=["unrolled"] * 3)]


@pytest.mark.parametrize("kind,axes", DECOMP_TOKENS)
def test_decomposition_tokens_match_reference(kind, axes):
    tok = Decomposition(kind, axes).to_token()
    assert tok == RefDecomposition(kind, axes).to_token()
    assert Decomposition.from_token(tok) == Decomposition(kind, axes)
    assert Decomposition.from_token(tok).to_token() == tok


@pytest.mark.parametrize("kw", OPTION_SETS)
def test_option_tokens_match_reference(kw):
    ours, want = FFTOptions(**kw), RefOptions(**kw)
    assert ours.to_token() == want.to_token()
    back = FFTOptions.from_token(want.to_token())
    assert back == ours and back.to_token() == want.to_token()
    for stage in range(3):
        assert ours.stage_impl(stage) == want.stage_impl(stage)
        assert ours.stage_overlap(stage) == want.stage_overlap(stage)


@pytest.mark.parametrize("opt", [1, 2, 3, 4])
def test_paper_options_match_reference(opt):
    assert FFTOptions.paper_option(opt).to_token() == \
        RefOptions.paper_option(opt).to_token()


@pytest.mark.parametrize("bad", ["pencil", "pencil[]", "pencil[y,]"])
def test_bad_decomposition_tokens_raise(bad):
    for cls in (Decomposition, RefDecomposition):
        with pytest.raises(ValueError):
            cls.from_token(bad)


@pytest.mark.parametrize("kw", [dict(transpose_impl="bruck"),
                                dict(overlap_mode="eager"),
                                dict(overlap_mode=("pipelined", "unrolled")),
                                dict(local_impl=("matmul",))])
def test_bad_options_raise_like_reference(kw):
    with pytest.raises(ValueError) as want:
        RefOptions(**kw)
    with pytest.raises(ValueError) as got:
        FFTOptions(**kw)
    assert str(got.value) == str(want.value)


VALIDATE_CASES = [
    ("slab", ("p",), (16, 16, 4), {"p": 8}, 1, "alltoall"),       # P > Nz
    ("slab", ("p",), (12, 16, 16), {"p": 8}, 1, "alltoall"),      # Nx % P
    ("slab", ("p",), (16, 6, 16), {"p": 8}, 4, "alltoall"),       # Ny % K
    ("pencil", ("y", "z"), (16, 12, 16), {"y": 8, "z": 2}, 1, "alltoall"),
    ("pencil", ("y", "z"), (4, 16, 16), {"y": 8, "z": 2}, 1, "alltoall"),
    ("pencil", ("y", "z"), (16, 16, 4), {"y": 2, "z": 4}, 4, "alltoall"),
    ("pencil", ("y", "z"), (2, 2, 2), {"y": 4, "z": 4}, 1, "alltoall"),
    ("cell", ("a", "b", "c"), (6, 8, 8), {"a": 2, "b": 2, "c": 2}, 1,
     "alltoall"),
    ("cell", ("a", "b", "c"), (8, 8, 8), {"a": 2, "b": 2, "c": 2}, 1, "ring"),
    ("pencil", (("a", "b"), "c"), (8, 8, 8), {"a": 2, "b": 2, "c": 2}, 1,
     "pairwise"),
    ("pencil", ("y", "missing"), (8, 8, 8), {"y": 2}, 1, "alltoall"),
]


@pytest.mark.parametrize("case", VALIDATE_CASES)
def test_validate_errors_match_reference(case):
    kind, axes, shape, sizes, k, impl = case
    with pytest.raises((ValueError, KeyError)) as want:
        RefDecomposition(kind, axes).validate(shape, sizes, k, impl)
    with pytest.raises(want.type) as got:
        Decomposition(kind, axes).validate(shape, sizes, k, impl)
    assert str(got.value) == str(want.value)
    assert not Decomposition(kind, axes).is_valid(shape, sizes, k, impl)


@pytest.mark.parametrize("n,ny,nz", [(4, 32, 32), (8, 32, 32), (6, 12, 8),
                                     (16, 64, 16)])
def test_pencil_grid_for_matches_reference(n, ny, nz):
    assert pencil_grid_for(n, ny, nz) == ref_pencil_grid_for(n, ny, nz)


def test_builder_errors_are_loud():
    dec = Decomposition("pencil", ("data", "model"))
    with pytest.raises(schedule_lib.ScheduleError):
        schedule_lib.Schedule("bad", -1, schedule_lib.layout_for(dec),
                              (schedule_lib.Stage("bad", fft_axis=1),))
    with pytest.raises(schedule_lib.ScheduleError):
        schedule_lib.Schedule(
            "bad", -1, schedule_lib.layout_for(dec),
            (schedule_lib.Stage("bad", comm_axis="model", split_axis=0,
                                concat_axis=1),))


class _FakeMesh:
    """Enough of a mesh for plan construction and the models."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())
        self.device = "cpu"
        self.coords = {a: 0 for a in self.shape}


@pytest.mark.parametrize("kind,layout", [("pencil", "natural"),
                                         ("pencil", "spectral"),
                                         ("slab", "natural")])
def test_flops_model_matches_reference_formula(kind, layout):
    dec, ref_dec = _decomps(kind)
    shape = (32, 16, 64)
    mesh = _FakeMesh({a: SIZES[a] for a in AXES[kind]})
    plan = Croft3D(shape, mesh, dec, FFTOptions(output_layout=layout))
    sched = ref_build(ref_dec, RefOptions(output_layout=layout), -1)
    want = sum(5.0 * e * math.log2(n) for _, e, n
               in sched.fft_events(shape, mesh.shape)) * ref_dec.n_procs(
        mesh.shape)
    assert plan.flops_model() == want
    meshless = Croft3D(shape, device="cpu")
    assert meshless.flops_model() == 5.0 * math.prod(shape) * sum(
        math.log2(s) for s in shape)
    assert plan.local_shape() == ref_dec.local_shape(shape, mesh.shape)


def test_croft3d_rejects_unported_and_bad_problems():
    # r2c runs meshless and packed, and distributed by embedding (cell)
    assert Croft3D((8, 8, 8), problem="r2c", device="cpu").strategy == "packed"
    assert Croft3D((8, 8, 8), _FakeMesh({"a": 2, "b": 2, "c": 2}),
                   Decomposition("cell", ("a", "b", "c")),
                   problem="r2c").strategy == "embed"
    with pytest.raises(ValueError, match="problem"):
        Croft3D((8, 8, 8), problem="c2c_grad", device="cpu")
    with pytest.raises(ValueError, match="Decomposition"):
        Croft3D((8, 8, 8), _FakeMesh({"p": 2}), device="cpu")


class _Posted:
    """A posted collective's work handle: its wait is logged."""

    def __init__(self, log):
        self.log = log

    def wait(self):
        self.log.append("wait")


class _LoopbackMesh:
    """One rank of a two-rank axis whose peer holds the same block: every
    post and every wait is logged, and the data lands at the wait."""

    device = torch.device("cpu")

    def __init__(self, log):
        self.log = log

    def axis_size(self, axis):
        return 2

    def axis_index(self, axis):
        return 0

    def all_to_all(self, x, axis, split_axis, concat_axis):
        self.log.append("post")
        mine = x.chunk(2, split_axis)[0]
        return Pending([_Posted(self.log)],
                       lambda: torch.cat([mine, mine], concat_axis))

    def exchange(self, sends, recvs, axis):
        self.log.append("post")

        def land():
            for (t, _), (buf, _) in zip(sends, recvs):
                buf.copy_(t)
        return Pending([_Posted(self.log)], land)


# paper step 1-4 on an x-pencil: FFT along x, then x <-> y, chunked on z
XY_STAGE = schedule_lib.Stage("x-fft+xy", fft_axis=0, impl_stage=0,
                              comm_axis="y", split_axis=0, concat_axis=1,
                              chunk_axis=2)


def _logged_stage(monkeypatch, impl, k, mode="pipelined"):
    """Run XY_STAGE on the loopback mesh with K = ``k``; returns (output,
    log of compute legs, posts and waits, growth of the overlap
    counter)."""
    log = []
    stage_pre = schedule_lib.stage_pre

    def pre(*a, **kw):
        log.append("pre")
        return stage_pre(*a, **kw)
    monkeypatch.setattr(schedule_lib, "stage_pre", pre)
    counter = metrics_lib.get_registry().counter(
        schedule_lib.CHUNKS_OVERLAPPED)
    before = counter.value
    opts = FFTOptions(overlap_k=k, transpose_impl=impl, overlap_mode=mode,
                      local_impl="pallas")
    g = torch.Generator().manual_seed(3)
    blk = torch.complex(torch.randn(8, 4, 8, generator=g),
                        torch.randn(8, 4, 8, generator=g))
    out = schedule_lib.run_stage(blk, XY_STAGE, -1, opts,
                                 _LoopbackMesh(log))
    return out, log, counter.value - before


@pytest.mark.parametrize("mode", ["pipelined", "unrolled"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("impl", ["alltoall", "ring"])
def test_chunk_collective_posted_before_next_fft(monkeypatch, impl, k, mode):
    """Chunk i's pack and collective are queued before chunk i+1's compute
    leg, so chunk i's transfer runs under chunk i+1's FFT on the card; the
    waits follow the last post.  The output is bitwise K = 1's."""
    out, log, grown = _logged_stage(monkeypatch, impl, k, mode)
    assert log == ["pre", "post"] * k + ["wait"] * k
    assert grown == k - 1
    one, log1, grown1 = _logged_stage(monkeypatch, impl, 1, mode)
    assert log1 == ["pre", "post", "wait"] and grown1 == 0
    assert torch.equal(out, one)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pairwise_stage_stays_serial(monkeypatch, k):
    """The pairwise baseline waits on each round inside its collective
    leg: nothing is in flight under the next chunk's FFT, and the counter
    stays where it was."""
    out, log, grown = _logged_stage(monkeypatch, "pairwise", k)
    assert log == ["pre", "post", "wait"] * k
    assert grown == 0
    assert torch.equal(out, _logged_stage(monkeypatch, "ring", 1)[0])


# --- a plan holds its schedules ---------------------------------------------

SHARDING_CASES = [(kind, layout) for kind in AXES
                  for layout in ("natural", "spectral")
                  if not (kind == "cell" and layout == "spectral")]


@pytest.mark.parametrize("kind,layout", SHARDING_CASES)
def test_c2c_shardings_are_the_decompositions_slices(kind, layout):
    """A c2c plan's shardings, read from the layouts of the schedules it
    holds, are the ranges ``Decomposition.slices`` gives, on every
    rank."""
    dec, _ = _decomps(kind)
    shape = (32, 16, 64)
    mesh = _FakeMesh({a: SIZES[a] for a in schedule_lib.flat_axes(
        AXES[kind])})
    plan = Croft3D(shape, mesh, dec, FFTOptions(output_layout=layout))
    for coords in itertools.product(*map(range, mesh.shape.values())):
        mesh.coords = dict(zip(mesh.shape, coords))
        assert plan.input_sharding == dec.slices(shape, mesh, mesh.coords)
        assert plan.output_sharding == dec.slices(shape, mesh, mesh.coords,
                                                  layout)


class _MirrorMesh(_FakeMesh):
    """A fake mesh whose every peer holds this rank's block: an
    all-to-all lands the rank's own piece from each of them."""

    device = torch.device("cpu")

    def all_to_all(self, x, axis, split_axis, concat_axis):
        p = self.shape[axis]
        mine = x.chunk(p, split_axis)[0]
        return Pending.done(torch.cat([mine] * p, concat_axis))


@pytest.mark.parametrize("kind,layout", [(None, "natural"),
                                         ("pencil", "natural"),
                                         ("pencil", "spectral"),
                                         ("slab", "natural"),
                                         ("slab", "spectral")])
def test_plan_runs_the_schedules_it_built(monkeypatch, kind, layout):
    """After construction a plan's transforms build no schedule and
    validate nothing: forward, filtered forward and inverse run the two
    schedules the plan holds."""
    shape = (16, 16, 8)
    if kind is None:
        plan = Croft3D(shape, device="cpu")
    else:
        dec, _ = _decomps(kind)
        plan = Croft3D(shape, _MirrorMesh({a: SIZES[a] for a in AXES[kind]}),
                       dec, FFTOptions(output_layout=layout))
    calls, ran = [], []

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(schedule_lib, "build_c2c",
                        counted("build_c2c", schedule_lib.build_c2c))
    monkeypatch.setattr(schedule_lib, "build_local_c2c", counted(
        "build_local_c2c", schedule_lib.build_local_c2c))
    monkeypatch.setattr(Decomposition, "validate",
                        counted("validate", Decomposition.validate))
    run_schedule = schedule_lib.run_schedule
    monkeypatch.setattr(schedule_lib, "run_schedule",
                        lambda blk, sched, *a, **kw: ran.append(sched.sign)
                        or run_schedule(blk, sched, *a, **kw))
    shard = plan.input_sharding or tuple(slice(0, n) for n in shape)
    x = torch.randn(*(s.stop - s.start for s in shard),
                    dtype=torch.complex64)
    y = plan.forward(x)
    plan.forward_filtered(x, torch.ones_like(y))
    plan.inverse(y)
    assert calls == [] and ran == [-1, -1, +1]
    want = "local/c2c" if kind is None else f"{kind}/c2c/{layout}"
    assert plan._sched_fwd.name == want


@pytest.mark.parametrize("kind", [None, "pencil"])
def test_scheduled_call_rejects_unknown_norm(kind):
    """A misspelt norm raises on a mesh too, where it once meant no
    scaling at all."""
    x = torch.zeros(4, 4, 4, dtype=torch.complex64)
    if kind is None:
        call = lambda: distributed.scheduled_fft3d(
            x, None, schedule_lib.build_local_c2c(+1), norm="forward")
    else:
        dec, _ = _decomps(kind)
        mesh = _MirrorMesh({a: 2 for a in AXES[kind]})
        call = lambda: distributed.ifft3d(x, mesh, dec, norm="forward")
    with pytest.raises(ValueError, match="unknown norm 'forward'"):
        call()
