"""``match_staged_pct``: the share of a ``skipper_match`` call's bytes to
the card that the program stages through its pinned memory and copy
stream, read from the program's registry (``repro_torch/tracing.py``)."""
import importlib
import time
from pathlib import Path

import pytest
import torch

from bench import harness, tracing
from bench.metrics import _spans
from repro_torch import tracing as program

CANNED = Path(__file__).resolve().parent / "data" / "canned_trace_spans.json"


def record(**extra):
    rec = tracing.reduce(tracing.load_events(CANNED))
    rec.update(work={}, setup={})
    rec.update(extra)
    return rec


def read(rec):
    return importlib.import_module("bench.metrics.match_staged_pct").read(rec)


@pytest.fixture
def registry():
    program.reset()
    yield program
    program.reset()


def test_reads_the_staged_share(registry):
    for _ in range(2):
        with registry.span("skipper_match"):
            registry.count("h2d_bytes", 1_000_000 + 12)
            registry.count("h2d_staged_bytes", 1_000_000)
    assert read(record()) == pytest.approx(100.0 * 1e6 / (1e6 + 12))


@pytest.mark.parametrize("counts", [
    {"h2d_bytes": 4096},  # a program that stages nothing of its own
    {},  # nothing crossed to a card
    {"h2d_bytes": 0, "h2d_staged_bytes": 0}])
def test_nothing_staged_or_moved_gives_nothing(registry, counts):
    with registry.span("skipper_match"):
        for k, v in counts.items():
            registry.count(k, v)
    assert read(record()) is None


def test_no_calls_or_no_registry_give_nothing(registry, monkeypatch):
    registry.count("h2d_bytes", 8)
    registry.count("h2d_staged_bytes", 8)
    assert read(record(calls=[])) is None
    monkeypatch.setattr(_spans, "registry", lambda: None)
    assert read(record()) is None


def test_a_cpu_run_leaves_the_share_out(tmp_path, registry):
    """On the CPU the program moves nothing to a card: the traced run's line
    leaves the share out and is correct."""
    cell = harness.load_cell(
        "kron22-match", config={"scale": 9},
        traffic={"schedule": {"window": 128, "tile_size": 64,
                              "reorder": "degree"}})
    assert "match_staged_pct" in {m["name"] for m in cell.per_layer}
    result = harness.run_cell(cell, 2**31 + 25, 0.3, True,
                              torch.device("cpu"), time.perf_counter(),
                              trace_path=tmp_path / "trace.json")
    assert result["correct"]
    assert "match_staged_pct" not in result["metrics"]
    assert "match_h2d_mb" in result["metrics"]
