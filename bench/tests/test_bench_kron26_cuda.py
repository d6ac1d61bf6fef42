"""The cell ``kron26-raw`` on the card at scale 14, traced and untraced.
Marked ``cuda``: each test skips, inside the test, where there is no card.
On the card: ``python -m pytest -m cuda bench/tests -q``."""
import json
import time

import pytest
import torch

from bench import harness

pytestmark = pytest.mark.cuda
ROOFLINES = ("raw_roofline", "raw_global_tier_roofline")


@pytest.mark.parametrize("trace", [False, True])
def test_kron26_raw_on_the_card(trace, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell("kron26-raw", config={"scale": 14})
    # the raw cells' rooflines too, which the cell does not report
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell.per_layer += [m for m in spec["per_layer"] if m["name"] in ROOFLINES]
    result = harness.run_cell(cell, 2**31 + 26, 1.0, trace,
                              torch.device("cuda", 0), time.perf_counter(),
                              trace_path=tmp_path / "t.json")
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    metrics = {k: m["value"] for k, m in result["metrics"].items()}
    if trace:
        assert metrics["raw_tile_us"] > 0
        for k in ROOFLINES:
            assert 0 < metrics[k] < 100, k
    else:
        assert metrics["peak_mem_gib"] > 0 and metrics["raw_ms_p95"] > 0
