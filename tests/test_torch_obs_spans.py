"""The port's hot-path spans (``repro_torch.obs.tracer.span``): free when
nothing records, ``repro_torch.*`` ranges under ``torch.profiler``, the
profiled session's record (``obs.profiled()``), and no tensor held by
any of it.  The ``cuda`` case holds the card's peak memory equal with
tracing off, a tracer installed and a profiler running."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_ranks
from repro_torch import obs
from repro_torch.core import Croft3D, FFTOptions, poisson_solve
from repro_torch.obs import tracer as tracer_lib

N = 16
OPTS = FFTOptions(local_impl="pallas")

# innermost enclosing repro_torch range of each span (None: outermost)
C2C_NESTING = {
    "croft3d:forward": {None},
    "croft3d:inverse": {None},
    "stage:fft": {"croft3d:forward", "croft3d:inverse"},
    "inverse:normalize": {"croft3d:inverse"},
}
POISSON_NESTING = {
    "poisson:solve": {None},
    "poisson:multiplier": {"poisson:solve"},
    "croft3d:forward": {"poisson:solve"},
    "croft3d:inverse": {"poisson:solve"},
    "real:pack_two": {"croft3d:forward"},
    "real:unpack_two": {"croft3d:forward"},
    "real:unfold_dc_plane": {"croft3d:forward"},
    "stage:fft": {"croft3d:forward", "croft3d:inverse"},
    "real:fold_dc_plane": {"croft3d:inverse"},
    "real:repack_halves": {"croft3d:inverse"},
    "real:split_pairs": {"croft3d:inverse"},
    "inverse:normalize": {"croft3d:inverse"},
}
PENCIL_NESTING = {
    "croft3d:forward": {None},
    "croft3d:inverse": {None},
    **{name: {"croft3d:forward", "croft3d:inverse"}
       for name in ("stage:fft", "transpose:pack", "transpose:collective",
                    "transpose:unpack", "stage:cat")},
    # the default local FFT: 16-point axes take one DFT product; a
    # K-chunk block with no (A, N, C) view around its axis takes one
    # layout copy first
    "matmul:dft": {"stage:fft"},
    "matmul:relayout": {"stage:fft"},
    "inverse:normalize": {"croft3d:inverse"},
}


def nesting(events) -> dict:
    """{span name: set of the innermost repro_torch range around it} from
    a chrome trace's host ranges."""
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"][len("repro_torch."):])
                     for e in events if e.get("ph") == "X"
                     and e.get("name", "").startswith("repro_torch.")),
                    key=lambda r: (r[0], -r[1]))
    out, stack = {}, []
    for s, e, name in ranges:
        while stack and stack[-1][1] < e:
            stack.pop()
        out.setdefault(name, set()).add(stack[-1][2] if stack else None)
        stack.append((s, e, name))
    return out


def profiled_trace(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; (its chrome trace events, the
    session's record)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"], obs.profiled()


def c2c_roundtrip():
    plan = Croft3D((N,) * 3, device="cpu", opts=OPTS)
    x = torch.randn((N,) * 3, dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(1))
    return lambda: plan.inverse(plan.forward(x))


def r2c_poisson():
    plan = Croft3D((N,) * 3, device="cpu", problem="r2c", opts=OPTS)
    f = torch.randn((N,) * 3, generator=torch.Generator().manual_seed(2))
    return lambda: poisson_solve(f, plan)


CASES = {"c2c_roundtrip": (c2c_roundtrip, C2C_NESTING),
         "r2c_poisson": (r2c_poisson, POISSON_NESTING)}


def assert_no_tensor(obj, where="") -> None:
    if isinstance(obj, torch.Tensor):
        raise AssertionError(f"a tensor at {where}")
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert_no_tensor(v, f"{where}.{k}")
    elif isinstance(obj, (list, tuple, set)):
        for i, v in enumerate(obj):
            assert_no_tensor(v, f"{where}[{i}]")


# --- off: nothing recorded, no profiler range opened ---------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_off_spans_are_null_and_open_no_range(case, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tracer_lib.get_tracer() is tracer_lib.NOOP
    assert obs.span("transpose:pack", "pack",
                    torch.device("cpu")) is tracer_lib._NULL_SPAN
    assert obs.span("stage:fft", "fft") is tracer_lib._NULL_SPAN
    before = tracer_lib._record
    CASES[case][0]()()
    # the off path wrote nothing: the session record is the one it was
    assert tracer_lib._record is before


# --- under a profiler: ranges, nesting, the record -------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_profiled_ranges_nest(case, tmp_path):
    make, want = CASES[case]
    events, record = profiled_trace(make(), tmp_path)
    got = nesting(events)
    assert got == want
    assert set(record) == set(want)


@pytest.mark.parametrize("solves", [1, 2, 3])
def test_profiled_counts_equal_the_calls(solves, tmp_path):
    """Each Poisson solve and each meshless c2c round trip opens 3
    ``stage:fft`` spans a direction, one ``croft3d:forward`` and one
    ``inverse:normalize``."""
    solve, roundtrip = r2c_poisson(), c2c_roundtrip()

    def run():
        for _ in range(solves):
            solve()
            roundtrip()
    _, record = profiled_trace(run, tmp_path)
    assert record["poisson:multiplier"]["count"] == solves
    assert record["poisson:solve"]["count"] == solves
    assert record["croft3d:forward"]["count"] == 2 * solves
    assert record["stage:fft"]["count"] == 12 * solves
    assert record["inverse:normalize"]["count"] == 2 * solves
    assert all(r["host_s"] > 0 and r["device_s"] is None
               for r in record.values())


def test_a_read_starts_a_fresh_record():
    roundtrip = c2c_roundtrip()
    with profile(activities=[ProfilerActivity.CPU]):
        roundtrip()
    first = obs.profiled()
    assert first["croft3d:forward"]["count"] == 1
    # reads with no span between them return the same record
    assert obs.profiled() is first
    with profile(activities=[ProfilerActivity.CPU]):
        roundtrip()
        roundtrip()
    second = obs.profiled()
    assert second is not first
    assert second["croft3d:forward"]["count"] == 2
    assert first["croft3d:forward"]["count"] == 1


def test_a_tracer_takes_the_spans_and_the_record_none():
    roundtrip = c2c_roundtrip()
    with profile(activities=[ProfilerActivity.CPU]):
        roundtrip()
    read = obs.profiled()
    with obs.tracing() as tr:
        roundtrip()
    names = [e["name"] for e in tr.events()]
    assert names.count("croft3d:forward") == 1
    assert names.count("stage:fft") == 6
    assert obs.profiled() is read


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_span_arg_event_or_record_holds_a_tensor(case, tmp_path):
    run = CASES[case][0]()
    with obs.tracing() as tr:
        run()
    for ev in tr.events():
        assert all(isinstance(v, (int, str)) for v in ev["args"].values()), \
            ev
        assert_no_tensor(ev, ev["name"])
    assert tr.device_ms() == {}           # nothing ran on a card
    _, record = profiled_trace(run, tmp_path)
    assert_no_tensor(record, "record")
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("poisson:multiplier", "epilogue",
                      torch.device("cpu"), chunks=2) as sp:
            pass
    assert_no_tensor([getattr(sp, k) for k in type(sp).__slots__], "span")


class FakeEvent:
    """A timing event on a clock that ticks 1 ms at every record."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.t = FakeEvent.clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.mark.parametrize("sink", ["record", "tracer"])
def test_device_time_is_the_pairs_elapsed_time(sink, monkeypatch):
    """Each span's device time is its pair's elapsed time; pairs are read
    in passes and their events recorded again by later spans."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(tracer_lib, "_spare_events",
                        tracer_lib.collections.defaultdict(list))
    FakeEvent.made = 0
    card = torch.device("cuda", 0)
    spans = 3 * tracer_lib._READ_EVERY + 7

    def run():
        for _ in range(spans):
            with obs.span("transpose:pack", "pack", card):
                pass
    if sink == "record":
        with profile(activities=[ProfilerActivity.CPU]):
            run()
        row = obs.profiled()["transpose:pack"]
        assert row["count"] == spans
        assert row["device_s"] == pytest.approx(spans * 1e-3)
    else:
        with obs.tracing() as tr:
            run()
        assert tr.device_ms() == {"transpose:pack":
                                  pytest.approx(spans * 1.0)}
        assert all(e["args"]["device_ms"] == 1.0 for e in tr.events())
    # events made: the pairs that waited for one pass, not one per span
    assert FakeEvent.made <= 2 * (tracer_lib._READ_EVERY + 1)


@pytest.mark.parametrize("sink", ["record", "tracer"])
def test_an_anchor_reads_its_pairs_at_its_exit(sink, monkeypatch):
    """An anchor (a ``plan`` span) reads the completed pairs at its exit,
    so the next transform records the same events again; a span without
    device time inside it (``stage:fft``) reads none."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(tracer_lib, "_spare_events",
                        tracer_lib.collections.defaultdict(list))
    FakeEvent.made = 0
    card = torch.device("cuda", 0)

    waiting = []

    def run(pairs):
        for _ in range(100):
            with obs.span("croft3d:forward", "plan", problem="c2c"):
                for _ in range(3):
                    with obs.span("transpose:pack", "pack", card):
                        pass
                    with obs.span("stage:fft", "fft"):
                        pass
                    waiting.append(len(pairs().pending))
    if sink == "record":
        with profile(activities=[ProfilerActivity.CPU]):
            run(lambda: tracer_lib._record._pairs)
        record = tracer_lib._record
        assert not record._pairs.pending    # read at the last anchor's exit
        assert record.spans["stage:fft"]["device_s"] is None
        assert obs.profiled()["transpose:pack"]["device_s"] == \
            pytest.approx(0.3)
    else:
        with obs.tracing() as tr:
            run(lambda: tr._pairs)
        assert not tr._pairs.pending
        assert tr.device_ms() == {"transpose:pack": pytest.approx(300.0)}
        assert all("device_ms" not in e["args"] for e in tr.events()
                   if e["name"] != "transpose:pack")
    assert waiting == [1, 2, 3] * 100
    assert FakeEvent.made == 6


# --- four gloo ranks: the pencil transposes -------------------------------------

WORKER = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from torch_ranks import join, leave
from repro_torch import obs
from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
from repro_torch.core.distributed import build_schedule
from test_torch_obs_spans import assert_no_tensor, nesting

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
N = 16
join(rank, port, 4)
mesh = make_mesh((2, 2), ("y", "z"), device="cpu")
dec = Decomposition("pencil", ("y", "z"))
rec = {}
for impl in ("alltoall", "ring"):
    opts = FFTOptions(overlap_k=2, transpose_impl=impl)
    plan = Croft3D((N,) * 3, mesh, dec, opts)
    g = torch.Generator().manual_seed(3)
    full = torch.randn((N,) * 3, dtype=torch.complex64, generator=g)
    x = full[plan.input_sharding].contiguous()
    y = plan.inverse(plan.forward(x))          # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = plan.inverse(plan.forward(x))
    record = obs.profiled()
    assert_no_tensor(record, "record")
    path = f"{out}/trace{rank}-{impl}.json"
    prof.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    ks, ffts = [], 0
    for sign in (-1, +1):
        sched = build_schedule(dec, opts, sign)
        k_eff = sched.effective_k((N,) * 3, mesh.shape, opts.overlap_k)
        ks += k_eff
        by_stage = dict(zip((i for i, _ in sched.comm_stages()), k_eff))
        ffts += sum(by_stage.get(i, 1) for i, st in enumerate(sched.stages)
                    if st.fft_axis is not None)
    rec[impl] = {
        "counts": {k: v["count"] for k, v in record.items()},
        "nesting": {k: sorted(v, key=str) for k, v in nesting(events).items()},
        "chunks": sum(ks), "chunked_stages": sum(k > 1 for k in ks),
        "comm_stages": len(ks), "ffts": ffts,
        "roundtrip_err": float((y - x).abs().max()),
    }
json.dump(rec, open(f"{out}/rank{rank}.json", "w"))
leave(mesh)
"""


@pytest.fixture(scope="module")
def pencil_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("spans")
    torch_ranks.spawn(WORKER, 4, [out], out)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("impl", ["alltoall", "ring"])
def test_pencil_ranges_nest(pencil_ranks, impl):
    want = {k: sorted(v, key=str) for k, v in PENCIL_NESTING.items()}
    for rec in pencil_ranks:
        assert rec[impl]["nesting"] == want
        assert rec[impl]["roundtrip_err"] < 1e-5


@pytest.mark.parametrize("impl", ["alltoall", "ring"])
def test_pencil_counts_one_pack_collective_unpack_a_chunk(pencil_ranks,
                                                          impl):
    for rec in pencil_ranks:
        r = rec[impl]
        # a natural-layout pencil round trip: 4 transposes a transform,
        # each in K = 2 chunks
        assert (r["comm_stages"], r["chunks"], r["chunked_stages"]) == \
            (8, 16, 8)
        c = r["counts"]
        assert c["transpose:pack"] == c["transpose:collective"] == \
            c["transpose:unpack"] == r["chunks"]
        assert c["stage:cat"] == r["chunked_stages"]
        # one a chunk of each FFT stage (the restoring transposes of
        # the natural layout run no FFT)
        assert c["stage:fft"] == r["ffts"] == 10
        assert c["croft3d:forward"] == c["croft3d:inverse"] == 1
        assert c["inverse:normalize"] == 1


# --- on the card: tracing moves no tensor's lifetime ------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c2c_roundtrip", "r2c_poisson"])
def test_tracing_keeps_the_peak_on_the_card(cuda_device, case):
    """``max_memory_allocated`` of one step at 256^3 is the same with
    tracing off, a ``Tracer`` installed, and a profiler recording; the
    device-timed spans report time, and the others take no events."""
    n = 256
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    if case == "c2c_roundtrip":
        plan = Croft3D((n,) * 3, opts=OPTS)
        x = torch.randn((n,) * 3, dtype=torch.complex64, device=cuda_device,
                        generator=gen)

        def step():
            return plan.inverse(plan.forward(x))
    else:
        plan = Croft3D((n,) * 3, problem="r2c", opts=OPTS)
        x = torch.randn((n,) * 3, device=cuda_device, generator=gen)

        def step():
            return poisson_solve(x, plan)

    def peak():
        torch.cuda.synchronize(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        y = step()
        torch.cuda.synchronize(cuda_device)
        del y
        return torch.cuda.max_memory_allocated(cuda_device)

    step()                                              # warm
    off = peak()
    with obs.tracing() as tr:
        on = peak()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiled = peak()
    record = obs.profiled()
    assert off == on == profiled, (off, on, profiled)
    assert tr.device_ms()["inverse:normalize"] > 0
    assert record["inverse:normalize"]["device_s"] > 0
    # anchors and the spans no metric reads carry no timing events
    assert "stage:fft" not in tr.device_ms()
    assert record["croft3d:inverse"]["device_s"] is None
    assert record["stage:fft"]["device_s"] is None
