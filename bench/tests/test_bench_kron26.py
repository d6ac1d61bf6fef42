"""The cell ``kron26-raw`` (Graph500 Kronecker at scale 26 on the raw
stream) on the CPU at a small size, its configuration against scale 22's,
and the reader ``raw_tile_us``."""
import importlib
import json
from pathlib import Path

import pytest

from bench import harness, tracing
from repro_torch import tracing as program
from test_bench_run import (answer_altered, break_entry, half_left_out, run,
                            state_altered, state_unchanged)

CONFIGS = harness.ROOT / "bench" / "configs"
CANNED = Path(__file__).resolve().parent / "data" / "canned_trace.json"


def small_cell():
    return harness.load_cell(
        "kron26-raw", config={"scale": 9},
        traffic={"call": {"tile_size": 64, "vector_rounds": 1, "spec": "u8"}})


@pytest.fixture
def registry():
    program.reset()
    yield program
    program.reset()


def test_cell_is_the_kron_config_on_the_raw_stream():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == "kron26-raw")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "graph500-kron-s26", "raw-resident", 1)
    full = harness.load_cell("kron26-raw")
    assert full.config["scale"] == 26
    # the rate is left out: the harness's copies of sampled outputs in the
    # window (a 1 GiB mask each) spread it over the seeds
    assert {m["name"] for m in full.end_to_end} == {
        "raw_ms_p95", "peak_mem_gib", "setup_s"}
    assert [m["name"] for m in full.per_layer] == ["raw_tile_us"]
    assert full.per_layer[0]["moves"] == "raw_ms_p95"


def test_sound_run_is_correct():
    result = run(small_cell())
    assert result["correct"] and result["failed"] == 0
    for c in result["check"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered, state_altered],
                         ids=lambda f: f.__name__)
def test_each_fault_is_not_correct(fault, monkeypatch):
    cell = small_cell()
    break_entry(monkeypatch, cell, fault)
    result = run(cell)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["check"].values())


def test_config_is_scale_22s_generator_at_graph500s_toy_class():
    s22 = json.loads((CONFIGS / "graph500-kron-s22.json").read_text())
    s26 = json.loads((CONFIGS / "graph500-kron-s26.json").read_text())
    assert set(s26) == set(s22) | {"class"}
    differ = {k for k in s22 if s22[k] != s26[k]}
    assert differ == {"name", "source", "scale", "published", "reduced"}
    assert (s26["name"], s26["scale"], s22["scale"]) == (
        "graph500-kron-s26", 26, 22)
    assert "problem class Toy" in s26["source"]
    # the Toy class is run as published: nothing reduced
    assert s26["reduced"] == {} and set(s22["reduced"]) == {"scale"}
    assert s26["published"] == {**s22["published"], "scale": 26}


def read_tile_us(rec):
    return importlib.import_module("bench.metrics.raw_tile_us").read(rec)


def canned(**extra):
    rec = tracing.reduce(tracing.load_events(CANNED))
    rec.update(work={}, setup={})
    rec.update(extra)
    return rec


def test_raw_tile_us_reads_kernel_time_over_tiles(registry):
    # the canned trace: two calls, 200 us of the global tier's kernel each;
    # the registry: three calls (a warm one among them) of 50 tiles
    for _ in range(3):
        with registry.span("skipper"):
            registry.count("skipper.tiles", 50)
    assert read_tile_us(canned()) == pytest.approx(200.0 / 50)


def test_raw_tile_us_without_the_counter_gives_nothing(registry):
    with registry.span("skipper"):
        pass
    assert read_tile_us(canned()) is None  # a program that counts no tile
    registry.count("skipper.tiles", 50)
    assert read_tile_us(canned(calls=[])) is None
    assert read_tile_us(canned(device=[])) is None
