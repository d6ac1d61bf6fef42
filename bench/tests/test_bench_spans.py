"""The readers of the program's own spans and counters
(``repro_torch/tracing.py``): on a canned trace that holds program spans,
on the program's registry, and on a traced run of each small cell."""
import importlib
import time
from pathlib import Path

import pytest
import torch

from bench import harness, tracing
from bench.metrics import _spans
from repro_torch import tracing as program

CANNED = Path(__file__).resolve().parent / "data" / "canned_trace_spans.json"
SMALL = {
    "kron22-match": ({"scale": 9}, {"schedule": {
        "window": 128, "tile_size": 64, "reorder": "degree"}}),
    "kron22-raw": ({"scale": 9}, {"call": {
        "tile_size": 64, "vector_rounds": 1, "spec": "u8"}}),
    "urand22-raw": ({"scale": 9}, {"call": {
        "tile_size": 64, "vector_rounds": 1, "spec": "u8"}}),
}
SPAN_READERS = ("match_copy_host_ms", "match_sync_wait_ms",
                "raw_sync_wait_ms")
SCHEDULE_READERS = ("schedule_reorder_s", "schedule_split_s",
                    "schedule_window_rows_s", "schedule_pairs_s",
                    "schedule_gather_map_s")
REGISTRY_READERS = SCHEDULE_READERS + (
    "match_h2d_mb", "window_tier_fallback_pct", "global_tier_fallback_pct",
    "raw_fallback_pct")
FALLBACK = ("window_tier_fallback_pct", "global_tier_fallback_pct",
            "raw_fallback_pct")


def events(top="skipper_match", drop=()):
    """The canned trace's events, its top spans named ``top``, with no
    span named in ``drop``."""
    out = []
    for e in tracing.load_events(CANNED):
        if e["name"] in drop:
            continue
        if e["name"] == "skipper_match":
            e = dict(e, name=top)
        out.append(e)
    return out


def record(**kw):
    rec = tracing.reduce(events(**kw))
    rec.update(work={}, setup={})
    return rec


def read(name, rec):
    return importlib.import_module(f"bench.metrics.{name}").read(rec)


@pytest.fixture
def registry():
    program.reset()
    yield program
    program.reset()


def test_span_readers_sum_the_spans_inside_the_calls():
    rec = record()
    # copies of 60 + 40 and 90 us in the two calls, less the 30 us of the
    # 40 in which a kernel queued before runs on the card (the device's
    # own copies are the copy's work and stay); the copy between the calls
    # and the device's copy of a span are left out
    assert read("match_copy_host_ms", rec) == pytest.approx(0.080)
    # checks of 30 and 20 us; the one after the last call is left out
    assert read("match_sync_wait_ms", rec) == pytest.approx(0.025)
    # no call holds the raw entry's top span
    assert read("raw_sync_wait_ms", rec) is None


def test_raw_reader_reads_the_raw_entry():
    rec = record(top="skipper")
    assert read("raw_sync_wait_ms", rec) == pytest.approx(0.025)
    assert read("match_copy_host_ms", rec) is None
    assert read("match_sync_wait_ms", rec) is None


@pytest.mark.parametrize("name,top,span", [
    ("match_copy_host_ms", "skipper_match", "skipper_match.copy"),
    ("match_sync_wait_ms", "skipper_match", "kernels.id_check"),
    ("raw_sync_wait_ms", "skipper", "kernels.id_check")])
def test_work_gone_reads_zero(name, top, span):
    """A call with no such span reads 0, not nothing: a change that takes
    the copy or the check away keeps its metric."""
    assert read(name, record(top=top, drop=(span,))) == 0.0


@pytest.mark.parametrize("name", SPAN_READERS + REGISTRY_READERS)
def test_no_calls_give_nothing(name, registry):
    with registry.span("skipper_match"):
        registry.count("h2d_bytes", 8)
    assert read(name, record(drop=("bench.call",))) is None


@pytest.mark.parametrize("name", SPAN_READERS + REGISTRY_READERS)
def test_a_program_without_spans_gives_nothing(name, monkeypatch):
    """A program that does not trace itself has neither the spans in its
    trace nor the registry: every reader leaves its metric out."""
    monkeypatch.setattr(_spans, "registry", lambda: None)
    rec = record(drop=("skipper_match", "skipper_match.copy",
                       "skipper_match.window_tier",
                       "skipper_match.global_tier", "skipper_match.gather",
                       "kernels.id_check"))
    assert read(name, rec) is None


def test_registry_readers(registry):
    for name in SCHEDULE_READERS:
        with registry.span("schedule." + name[len("schedule_"):-2]):
            pass
    for _ in range(2):
        with registry.span("skipper_match"):
            registry.count("h2d_bytes", 1_500_000)
    rec = record()
    for name in SCHEDULE_READERS:
        span = "schedule." + name[len("schedule_"):-2]
        assert read(name, rec) == registry.spans()[span]["last_s"] > 0
    assert read("match_h2d_mb", rec) == pytest.approx(1.5)
    # nothing recorded yet: no tier's edges counted, so no share either (a
    # count that broke or went would otherwise read as the best share)
    for name in FALLBACK:
        assert read(name, rec) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        conf = torch.tensor([[1, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.uint8)
        from repro_torch.core import engine

        engine.count_fallback("skipper_match.window_tier", conf, 1, 8)
        engine.count_fallback("skipper_match.global_tier", conf, 2, 4)
        engine.count_fallback("skipper", conf.to(torch.int32), 1,
                              torch.tensor(6))
    assert read("window_tier_fallback_pct", rec) == pytest.approx(37.5)
    assert read("global_tier_fallback_pct", rec) == 0.0
    assert read("raw_fallback_pct", rec) == pytest.approx(50.0)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_reports_the_programs_metrics(name, tmp_path, registry):
    config, traffic = SMALL[name]
    cell = harness.load_cell(name, config=config, traffic=traffic)
    result = harness.run_cell(cell, 2**31 + 11, 0.3, True,
                              torch.device("cpu"), time.perf_counter(),
                              trace_path=tmp_path / "trace.json")
    assert result["correct"]
    new = {m["name"] for m in cell.per_layer} & set(SPAN_READERS
                                                     + REGISTRY_READERS)
    assert new and new <= set(result["metrics"])
    values = {k: result["metrics"][k]["value"] for k in new}
    for k in new & set(FALLBACK):
        assert 0.0 <= values[k] <= 100.0, k
    if name == "kron22-match":
        assert values["match_h2d_mb"] == 0.0  # nothing crosses to a card
        assert values["match_copy_host_ms"] > 0.0
        assert values["match_sync_wait_ms"] == 0.0  # no kernel, no check
        for k in SCHEDULE_READERS:
            assert values[k] > 0.0, k
    else:
        assert values["raw_sync_wait_ms"] == 0.0
