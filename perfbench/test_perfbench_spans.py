"""The readers of the port's own spans and counter, fed a made-up record:
nothing off the card, nothing from a program that keeps no such record,
and the right milliseconds per step otherwise."""

import dataclasses

import pytest

from perfbench.harness.spec import Bench

STEPS = 40


@dataclasses.dataclass
class Ctx:
    card: bool
    steps: int = STEPS

    def on_card(self) -> bool:
        return self.card


def row(count, device_s):
    return {"count": count, "host_s": 1e-3 * count, "device_s": device_s}


RECORD = {
    "poisson:multiplier": row(STEPS, 0.48),
    "inverse:normalize": row(STEPS, 0.12),
    "real:pack_two": row(STEPS, 0.1),
    "real:unpack_two": row(STEPS, 0.9),          # a kernel's: left out
    "real:unfold_dc_plane": row(STEPS, 0.2),
    "real:fold_dc_plane": row(STEPS, 0.3),
    "real:repack_halves": row(STEPS, 0.9),       # a kernel's: left out
    "real:split_pairs": row(STEPS, 0.04),
    "transpose:pack": row(8 * STEPS, 1.0),
    "transpose:collective": row(8 * STEPS, 0.5),  # the NCCL launch: left out
    "transpose:unpack": row(8 * STEPS, 1.2),
    "stage:cat": row(4 * STEPS, 0.8),
    "stage:fft": row(10 * STEPS, 3.0),
}
SPAN_METRICS = {
    "multiplier_ms_per_step": 0.48 / STEPS * 1e3,
    "normalize_ms_per_step": 0.12 / STEPS * 1e3,
    "realpipe_glue_ms_per_step": (0.1 + 0.2 + 0.3 + 0.04) / STEPS * 1e3,
    "transpose_copy_ms_per_step": (1.0 + 1.2 + 0.8) / STEPS * 1e3,
}


@pytest.fixture
def record(monkeypatch):
    import repro_torch.obs
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: RECORD)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_ms_per_step(record, metric):
    reader = Bench().reader(metric)
    assert reader.COMBINE == "max"
    assert reader.read(Ctx(card=False)) is None
    assert reader.read(Ctx(card=True)) == pytest.approx(SPAN_METRICS[metric])


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_reads_nothing_without_the_record(monkeypatch, metric):
    """A program that keeps no record (the parent of the spans), or one
    that recorded none of the metric's spans, or spans timed on no card,
    gives nothing and raises nothing."""
    import repro_torch.obs
    reader = Bench().reader(metric)
    monkeypatch.delattr(repro_torch.obs, "profiled")
    assert reader.read(Ctx(card=True)) is None
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: {},
                        raising=False)
    assert reader.read(Ctx(card=True)) is None
    untimed = {k: dict(v, device_s=None) for k, v in RECORD.items()}
    monkeypatch.setattr(repro_torch.obs, "profiled", lambda: untimed)
    assert reader.read(Ctx(card=True)) is None


def test_comm_init_reader(monkeypatch):
    from repro_torch.obs import metrics
    reader = Bench().reader("comm_init_s")
    assert reader.COMBINE == "max"
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "get_registry", lambda: reg)
    assert reader.read(Ctx(card=True)) is None        # no mesh, no counter
    reg.counter("mesh_comm_init_seconds").inc(2.75)
    assert reader.read(Ctx(card=False)) is None
    assert reader.read(Ctx(card=True)) == pytest.approx(2.75)
