"""The reader of the raw stream's survivors (``raw_survivor_pct``): the
program's counter ``skipper.survivor_lanes`` over ``skipper.edges``; nothing
for a program that keeps no such counter, or without calls."""
import importlib

import pytest

from bench import tracing
from bench.metrics import _spans
from repro_torch import tracing as program

from test_bench_spans import record

SPEC_CELLS = ("kron22-raw", "urand22-raw")


def read(rec):
    return importlib.import_module("bench.metrics.raw_survivor_pct").read(rec)


@pytest.fixture
def registry():
    program.reset()
    yield program
    program.reset()


def test_share_of_the_edges(registry, monkeypatch):
    rec = record(top="skipper")
    assert read(rec) is None  # nothing counted
    monkeypatch.setattr(program, "recording", lambda: True)
    registry.count_device("skipper.edges", 400)
    assert read(rec) is None  # a program without the filter's counter
    registry.count_device("skipper.survivor_lanes", 6)
    assert read(rec) == pytest.approx(1.5)


def test_no_calls_or_no_registry_give_nothing(registry, monkeypatch):
    monkeypatch.setattr(program, "recording", lambda: True)
    registry.count_device("skipper.edges", 400)
    registry.count_device("skipper.survivor_lanes", 6)
    assert read(record(drop=("bench.call",))) is None
    monkeypatch.setattr(_spans, "registry", lambda: None)
    assert read(record(top="skipper")) is None


def test_listed_for_the_raw_cells_at_22():
    import json

    from bench import harness

    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in spec["per_layer"]}["raw_survivor_pct"]
    assert tuple(entry["workloads"]) == SPEC_CELLS
    assert entry["moves"] == "raw_medges_s" and entry["layer"] == "global tier"
    assert tracing.DEVICE_CATS  # the trace reader the cells use
