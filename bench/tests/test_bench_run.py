"""A run of each cell, on the CPU at a small size through the program's
plain versions: ``correct`` is true for the program, and false for the
control and for each fault the cells can have. The look for a card is
``run.py``'s, and is held here too."""
import importlib
import json
import subprocess
import sys
import time

import pytest
import torch

from bench import control, harness
from bench.reference.greedy import greedy

SMALL = {
    "kron22-match": ({"scale": 9}, {"schedule": {
        "window": 128, "tile_size": 64, "reorder": "degree"}}),
    "kron22-raw": ({"scale": 9}, {"call": {
        "tile_size": 64, "vector_rounds": 1, "spec": "u8"}}),
    "urand22-raw": ({"scale": 9}, {"call": {
        "tile_size": 64, "vector_rounds": 1, "spec": "u8"}}),
}
#: (module, function) of each cell's entry point
ENTRY = {"skipper_match": ("repro_torch.kernels.skipper_match.ops",
                           "skipper_match"),
         "skipper_raw": ("repro_torch.core.skipper", "skipper")}
CELLS = sorted(SMALL)


def small_cell(name):
    config, traffic = SMALL[name]
    return harness.load_cell(name, config=config, traffic=traffic)


def run(cell, seed=2**31 + 7, seconds=0.3, trace=False, tmp_path=None):
    path = tmp_path / "trace.json" if tmp_path else None
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), trace_path=path)


def break_entry(monkeypatch, cell, fault):
    """Put a broken entry point in the program's place: ``fault(edges,
    result) -> (mask, state)`` changes what the true entry returned."""
    mod_name, fn_name = ENTRY[cell.traffic["adapter"]]
    mod = importlib.import_module(mod_name)
    true_entry = getattr(mod, fn_name)

    def broken(edges, *args, **kwargs):
        out = true_entry(edges, *args, **kwargs)
        res = out[0] if isinstance(out, tuple) else out
        mask, state = fault(edges, res, lambda e: true_entry(e, *args,
                                                             **kwargs))
        res = type(res)(match_mask=mask, state=state, counters=res.counters)
        return (res,) + tuple(out[1:]) if isinstance(out, tuple) else res

    monkeypatch.setattr(mod, fn_name, broken)


def state_unchanged(edges, res, entry):
    """A step that returns its state unchanged: nothing matched."""
    return (torch.zeros_like(res.match_mask),
            torch.zeros_like(res.state))


def half_left_out(edges, res, entry):
    """Half of the batch left out: the second half of the stream is never
    decided."""
    from repro_torch.graphs.types import EdgeList

    half = edges.num_edges // 2
    sub = EdgeList(edges.u[:half], edges.v[:half], edges.num_vertices)
    out = entry(sub)
    part = out[0] if isinstance(out, tuple) else out
    mask = torch.cat([part.match_mask,
                      torch.zeros(edges.num_edges - half, dtype=torch.bool)])
    return mask, part.state


def answer_altered(edges, res, entry):
    """One answer altered where it is produced: the first matched edge's
    decision flipped."""
    mask = res.match_mask.clone()
    first = int(torch.nonzero(mask)[0])
    mask[first] = False
    return mask, res.state


def state_altered(edges, res, entry):
    """One vertex's state byte altered."""
    state = res.state.clone()
    state[0] = 1
    return res.match_mask, state


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    result = run(cell)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end
                                      } - {"peak_mem_gib"}  # 0 on the CPU
    for c in result["check"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ["kron22-match", "kron22-raw"])
def test_traced_run_reads_the_per_layer_metrics(name, tmp_path):
    cell = small_cell(name)
    result = run(cell, trace=True, tmp_path=tmp_path)
    assert result["correct"]
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    # the CPU puts no operation on a device: the readers of the device's
    # trace find nothing and their metrics are left out
    assert not {"match_roofline", "raw_roofline", "device_idle_pct",
                "raw_device_idle_pct"} & set(result["metrics"])
    assert "breakdown" in result and list(result)[-1] == "check"
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered, state_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ["kron22-match", "urand22-raw"])
def test_each_fault_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    break_entry(monkeypatch, cell, fault)
    result = run(cell)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["check"].values())


@pytest.mark.parametrize("name", ["kron22-match", "urand22-raw"])
def test_failed_calls_are_not_correct(name, monkeypatch):
    """A call that fails in set-up ends the run (``run.py`` exits 1 and
    prints no result); one that fails in the window counts as failed."""
    cell = small_cell(name)
    calls = []

    def boom(edges, res, entry):
        calls.append(1)
        if len(calls) > 1:  # the warm call passes
            raise RuntimeError("the entry point failed")
        return res.match_mask, res.state

    break_entry(monkeypatch, cell, boom)
    result = run(cell)
    assert not result["correct"] and result["failed"] == result["attempted"]
    calls.append(1)
    with pytest.raises(RuntimeError):
        run(cell)


@pytest.mark.parametrize("cut", ["end", "short", "one_round"])
@pytest.mark.parametrize("name", ["kron22-match", "urand22-raw"])
def test_control_in_the_programs_place(name, cut, monkeypatch):
    """The plain greedy matcher in the entry point's place passes at its
    end and fails cut one round short or after one round."""
    cell = small_cell(name)

    def reference(edges, res, entry):
        mask, state, rounds = greedy(edges.u, edges.v, edges.num_vertices)
        if cut == "end":
            return mask, state
        stop = rounds - 1 if cut == "short" else 1
        mask, state, _ = greedy(edges.u, edges.v, edges.num_vertices,
                                max_rounds=stop)
        return mask, state

    break_entry(monkeypatch, cell, reference)
    result = run(cell)
    assert result["correct"] == (cut == "end")
    if cut != "end":
        assert result["check"]["uncovered"]["value"] > 0


@pytest.mark.parametrize("name", ["kron22-match", "kron22-raw"])
def test_control_readings(name):
    out = control.readings(small_cell(name), 5, torch.device("cpu"))
    for key in ("sound", "greedy"):
        assert all(v == 0 for v in out[key].values()), key
    assert out["control"]["uncovered"] > 0
    assert out["greedy_rounds"] > 1


def test_without_a_card_run_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kron22-match",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_result_line_is_json():
    result = run(small_cell("kron22-raw"))
    line = json.dumps(result)
    assert json.loads(line)["correct"] is True
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
