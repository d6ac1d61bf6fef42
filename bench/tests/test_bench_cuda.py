"""The harness on the card at a small size, and the run in a directory
that holds only the benchmark. Marked ``cuda``: each test skips, inside
the test, where there is no card. On the card:
``python -m pytest -m cuda bench/tests -q``."""
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import control, harness

pytestmark = pytest.mark.cuda

SMALL = {"kron22-match": {"schedule": {"window": 4096, "tile_size": 256,
                                       "reorder": "degree"}},
         "kron22-raw": {}, "urand22-raw": {}}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_cell(name):
    return harness.load_cell(name, config={"scale": 14},
                             traffic=SMALL[name])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_on_the_card(name, trace, tmp_path):
    device = card()
    result = harness.run_cell(small_cell(name), 2**31 + 3, 1.0, trace,
                              device, time.perf_counter(),
                              trace_path=tmp_path / "t.json")
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert {"global_tier_roofline", "raw_global_tier_roofline"} & set(result["metrics"])
        assert {"match_roofline", "raw_roofline"} & set(result["metrics"])
        assert all(0 < m["value"] < 100 for k, m in result["metrics"].items() if k.endswith("roofline"))
    else:
        assert result["metrics"]["peak_mem_gib"]["value"] > 0


@pytest.mark.parametrize("name", ["kron22-match", "urand22-raw"])
def test_control_on_the_card(name):
    out = control.readings(small_cell(name), 9, card())
    assert all(v == 0 for v in out["sound"].values())
    assert all(v == 0 for v in out["greedy"].values())
    assert out["control"]["uncovered"] > 0


def test_benchmark_alone_exits_nonzero(tmp_path):
    card()
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kron22-raw",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
