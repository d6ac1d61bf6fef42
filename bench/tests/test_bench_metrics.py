"""Every reader on a canned trace and a canned window, by hand."""
import importlib
import json
from pathlib import Path

import pytest

from bench import tracing, yardstick

CANNED = Path(__file__).resolve().parent / "data" / "canned_trace.json"
SPEC = json.loads((Path(__file__).resolve().parents[2]
                   / "BENCHMARK.json").read_text())
WORK = {"call": {"edges": 4000, "vertices": 500},
        "window_tier": {"edges": 1000, "vertices": 100},
        "global_tier": {"edges": 2900, "vertices": 500}}


def record(**extra):
    rec = tracing.reduce(tracing.load_events(CANNED))
    rec.update(work=WORK, setup={"schedule_s": 12.5})
    rec.update(extra)
    return rec


def read(name, rec):
    return importlib.import_module(f"bench.metrics.{name}").read(rec)


def test_reduce_keeps_the_window():
    rec = record()
    assert rec["window"] == [1000.0, 2000.0]
    assert rec["calls"] == [[1000.0, 1400.0], [1500.0, 1950.0]]
    # the kernel at 3000 lies outside; the last copy is clipped to the end
    assert len(rec["device"]) == 8
    assert rec["device"][-1]["dur"] == 10.0
    assert {e["name"] for e in rec["host"]} == {
        "aten::to", "cudaMemcpyAsync", "cudaLaunchKernel", "aten::index"}


def test_busy_and_idle():
    rec = record()
    assert tracing.busy_us(rec) == 740.0
    assert tracing.window_us(rec) == 1000.0
    assert read("device_idle_pct", rec) == pytest.approx(26.0)


def test_schedule_readers():
    rec = record()
    assert read("schedule_s", rec) == 12.5
    assert read("schedule_copy_ms", rec) == pytest.approx(0.11)


@pytest.mark.parametrize("name,tier,us", [
    ("window_tier_roofline", "window_tier", 50.0),
    ("global_tier_roofline", "global_tier", 200.0)])
def test_tier_rooflines(name, tier, us):
    want = yardstick.least_seconds(**WORK[tier]) / (us * 1e-6) * 100
    assert read(name, record()) == pytest.approx(want)


def test_call_extents_on_the_card():
    # call 1: the copy at 1010 to the global tier's end at 1380; call 2:
    # the copy at 1510 to the memset's end at 1915; the copy back at 1990
    # lies in no call
    assert tracing.call_extents_us(record()) == [370.0, 405.0]
    assert tracing.call_extents_us(record(calls=[[1950.0, 1980.0]])) == []


def test_match_roofline():
    want = yardstick.least_seconds(**WORK["call"]) / 387.5e-6 * 100
    assert read("match_roofline", record()) == pytest.approx(want)
    assert read("raw_roofline", record()) == pytest.approx(want)


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]
                                  if m["name"] != "schedule_s"])
def test_nothing_to_read_gives_nothing(name):
    rec = record(device=[], calls=[], work={})
    assert read(name, rec) is None


def test_raw_cells_have_no_window_tier_and_no_copy():
    rec = record()
    rec["device"] = [e for e in rec["device"] if "window" not in e["name"]
                     and e["cat"] != "gpu_memcpy"]
    rec["work"] = {k: v for k, v in WORK.items() if k != "window_tier"}
    assert read("window_tier_roofline", rec) is None
    assert read("schedule_copy_ms", rec) is None
    assert read("global_tier_roofline", rec) is not None
    assert read("schedule_s", record(setup={})) is None


def test_breakdown():
    out = tracing.breakdown(record())
    ops = dict(out["device_ops"])
    assert ops["skipper_boundary_async_kernel<unsigned char, unsigned char, "
               "true>"] == pytest.approx(400e-6)
    assert ops["Memcpy HtoD"] == pytest.approx(220e-6)
    gaps = dict(out["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(260e-6)
    # each gap goes to the innermost host event at its middle
    assert gaps == pytest.approx({
        "host, between calls": 205e-6, "aten::to": 20e-6,
        "host, no traced operation (in a call)": 25e-6,
        "cudaLaunchKernel": 10e-6})
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


WINDOW = {"latencies_s": [0.2 + 0.001 * i for i in range(100)],
          "window_s": 25.0, "calls": 100, "failed": 0,
          "edges_per_call": 1_000_000, "peak_bytes": 3 * 2**30,
          "setup_s": 31.5}


def read_e2e(name, window):
    return importlib.import_module(f"bench.end_to_end.{name}").read(window)


def test_end_to_end_readers():
    assert read_e2e("match_medges_s", WINDOW) == pytest.approx(4.0)
    # nearest rank: the 95th of 100 sorted calls
    assert read_e2e("match_ms_p95", WINDOW) == pytest.approx(294.0)
    assert read_e2e("peak_mem_gib", WINDOW) == 3.0
    assert read_e2e("setup_s", WINDOW) == 31.5


def test_failed_calls_complete_no_edges():
    w = dict(WINDOW, failed=100)
    assert read_e2e("match_medges_s", w) is None
    w = dict(WINDOW, failed=50)
    assert read_e2e("match_medges_s", w) == pytest.approx(2.0)


def test_short_names():
    assert tracing.short_name(
        "void (anonymous namespace)::skipper_window_async_kernel<unsigned "
        "char, unsigned char>(int const*, int const*)") == (
        "skipper_window_async_kernel<unsigned char, unsigned char>")
    assert tracing.short_name("Memcpy HtoD (Pageable -> Device)") == (
        "Memcpy HtoD")
