"""The port's APRAM conformance package (``repro_torch.testing``) against
the JAX package's (``repro.testing``), on the same schedules (tolerance:
exact equality; the model is integer), and the port's entry points pinned
as reachable APRAM traces at both state widths. The checked-in fuzz corpus
replays clean through the port's ``replay_record``, and the port's fuzz
CLI exits 0 on a clean smoke and 1 on a mutation canary, writing only to
``tmp_path``."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import testing as jt
from repro.graphs import generators as jgen

from repro_torch import testing as pt
from repro_torch.graphs import rmat_graph
from repro_torch.interop import edges_from_arrays
from repro_torch.testing import fuzz

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "fuzz_corpus"
RECORDS = sorted(CORPUS.glob("*.json"))


def _reference_fuzzer():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import fuzz_matching

    return fuzz_matching


def _instance(seed, n=32, m=64):
    """A contended numpy-seeded stream: hubs, self-loops, padding."""
    rng = np.random.default_rng(seed)
    u = np.where(rng.random(m) < 0.3, rng.integers(0, 3, m),
                 rng.integers(0, n, m))
    v = rng.integers(0, n, m)
    v = np.where(rng.random(m) < 0.05, u, v)
    pad = rng.random(m) < 0.05
    return np.where(pad, -1, u), np.where(pad, -1, v), n


def _same_result(got, want):
    for f in ("u", "v", "schedule", "matched", "decided", "state", "owner"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.num_vertices == want.num_vertices
    assert [(e.step, e.event, e.invariant, str(e)) for e in got.violations] \
        == [(e.step, e.event, e.invariant, str(e)) for e in want.violations]


@pytest.mark.parametrize("mutation", [None] + sorted(pt.MUTATIONS))
def test_run_schedule_equals_reference(mutation):
    """Every mutation (and the true protocol) under random, round-robin and
    hub-contention schedules: the same decisions, cells, owners and
    recorded violations."""
    assert pt.MUTATIONS == jt.MUTATIONS
    for seed in (0, 1):
        inst = _instance(seed)
        m = len(inst[0])
        for sched in (pt.random_schedule(m, seed), pt.round_robin(m, 3),
                      pt.hub_contention(inst), pt.stream_order(m)):
            got = pt.run_schedule(inst, sched, mutation=mutation,
                                  strict=False)
            want = jt.run_schedule(inst, sched, mutation=mutation,
                                   strict=False)
            _same_result(got, want)


def test_schedulers_equal_reference():
    inst = _instance(3)
    m = len(inst[0])
    edges = edges_from_arrays(*inst)
    pairs = [
        (pt.stream_order(m), jt.stream_order(m)),
        (pt.random_schedule(m, 5), jt.random_schedule(m, 5)),
        (pt.round_robin(m, 4), jt.round_robin(m, 4)),
        (pt.round_robin(m, 100), jt.round_robin(m, 100)),
        (pt.hub_contention(inst), jt.hub_contention(inst)),
        (pt.hub_contention(edges), jt.hub_contention(inst)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = [s.tolist() for s in pt.exhaustive_schedules(4)]
    assert got == [s.tolist() for s in jt.exhaustive_schedules(4)]
    assert pt.MAX_EXHAUSTIVE_EVENTS == jt.MAX_EXHAUSTIVE_EVENTS
    with pytest.raises(ValueError, match="refused"):
        list(pt.exhaustive_schedules(pt.MAX_EXHAUSTIVE_EVENTS + 1))


@pytest.mark.parametrize("mutation", [None, "skip_partner_check"])
def test_sweep_equals_reference(mutation):
    inst = _instance(4)
    got = pt.sweep(inst, seeds=(0, 1), threads=(2, 5), mutation=mutation,
                   strict=False)
    want = jt.sweep(inst, seeds=(0, 1), threads=(2, 5), mutation=mutation,
                    strict=False)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _same_result(a, b)


def test_exhaustive_tiny_instance_matches_reference():
    """Every interleaving of a 5-event contended instance: the same set of
    reachable matchings in both models, each valid and maximal."""
    inst = (np.array([0, 0, 1, 2, 0]), np.array([1, 2, 2, 3, 3]), 4)
    got = {pt.run_schedule(inst, s).matching_key()
           for s in pt.exhaustive_schedules(5)}
    want = {jt.run_schedule(inst, s).matching_key()
            for s in jt.exhaustive_schedules(5)}
    assert got == want and len(got) >= 2


def test_schedule_and_mutation_are_checked():
    u, v = np.array([0, 1]), np.array([1, 2])
    with pytest.raises(ValueError, match="permutation"):
        pt.run_schedule((u, v, 3), [0, 0])
    with pytest.raises(ValueError, match="unknown mutation"):
        pt.run_schedule((u, v, 3), [0, 1], mutation="nonsense")


def test_witness_and_pin_trace_reject_bad_masks():
    mask = np.array([False, True, False, True])
    np.testing.assert_array_equal(pt.witness_schedule(None, mask),
                                  jt.witness_schedule(None, mask))
    inst = _instance(6)
    from repro_torch.core import sgmm

    good = sgmm(edges_from_arrays(*inst)).match_mask
    pt.pin_trace(inst, good, label="sgmm")
    bad = good.clone()
    bad[int(np.flatnonzero(good.numpy())[0])] = False
    with pytest.raises(pt.ConformanceError) as exc:
        pt.pin_trace(inst, bad, label="sgmm")
    assert exc.value.first_mismatch >= 0
    with pytest.raises((pt.ConformanceError, pt.ApramViolation)):
        pt.pin_trace((np.array([0, 0]), np.array([1, 2]), 3),
                     np.array([True, True]))


def test_bipartite_stream_equals_reference():
    rng = np.random.default_rng(7)
    tok = np.where(rng.random(40) < 0.1, -1, rng.integers(0, 12, 40))
    exp = rng.integers(0, 6, 40)
    got = pt.bipartite_stream(tok, exp, num_tokens=12, num_experts=6)
    want = jt.bipartite_stream(tok, exp, num_tokens=12, num_experts=6)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] == 18


def test_pin_entry_points_at_both_state_widths():
    """The port's matrix on the reference's conformance graph (RMAT scale
    7, window 64, tile 32): skipper, skipper_match's plain backend and the
    b-matching at u8 and legacy_i32, and sgmm, each a reachable trace."""
    g = rmat_graph(7, 2, seed=3)
    out = pt.pin_entry_points(g, window=64, tile_size=32, device="cpu")
    expected = {f"{entry}@{spec}"
                for entry in ("skipper", "skipper_match_torch", "bmatch")
                for spec in ("u8", "legacy_i32")} | {"sgmm"}
    assert set(out) == expected
    for name, trace in out.items():
        assert trace.num_matches > 0, name


@pytest.mark.parametrize("row", ["include_distributed", "include_chaos"])
def test_unported_rows_raise(row):
    g = rmat_graph(5, 2, seed=3)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        pt.pin_entry_points(g, device="cpu", **{row: True})


# ------------------------------------------------------------ fuzz corpus

def test_fuzz_instances_and_version_equal_reference():
    fm = _reference_fuzzer()
    assert fuzz.CORPUS_VERSION == fm.CORPUS_VERSION
    assert set(fuzz.CHECKS) == set(fm.CHECKS)
    for seed in (0, 11):
        for got, want in zip(fuzz.make_instance(seed), fm.make_instance(seed)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(fuzz.make_bmatch_instance(seed),
                             fm.make_bmatch_instance(seed)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", RECORDS, ids=lambda p: p.stem)
def test_corpus_record_replays_clean(path):
    rec = json.loads(path.read_text())
    assert rec["version"] == fuzz.CORPUS_VERSION, path.name
    assert fuzz.replay_record(rec, device="cpu"), f"{path.name}: " \
        f"{rec['error']}"


def test_corpus_has_seven_records():
    assert len(RECORDS) == 7


def test_fuzz_cli_replays_the_corpus(capsys):
    assert fuzz.main(["--replay", str(CORPUS), "--device", "cpu"]) == 0
    assert "replay: 7/7 corpus records pass" in capsys.readouterr().out


def test_fuzz_cli_clean_smoke(tmp_path):
    rc = fuzz.main(["--iterations", "3", "--time-budget", "120",
                    "--device", "cpu", "--artifacts", str(tmp_path)])
    assert rc == 0
    assert not list(tmp_path.glob("*.json"))


def test_fuzz_cli_mutation_canary_fails(tmp_path):
    """``--mutation commit_before_reserve`` must exit 1 and write a
    minimized counterexample: the fuzzer can catch a protocol bug."""
    rc = fuzz.main(["--mutation", "commit_before_reserve",
                    "--iterations", "20", "--time-budget", "120",
                    "--max-counterexamples", "1", "--device", "cpu",
                    "--artifacts", str(tmp_path)])
    assert rc == 1
    arts = list(tmp_path.glob("*.json"))
    assert arts
    rec = json.loads(arts[0].read_text())
    assert rec["mutation"] == "commit_before_reserve"
    assert rec["live_edges"] <= 6
    # the record replays the way the reference's records do: failing,
    # as long as the mutation is seeded
    assert not fuzz.replay_record(rec, device="cpu")


def test_fuzz_cli_needs_the_card_by_default(monkeypatch, tmp_path, capsys):
    """The matchers run on the card unless asked for the CPU: without one
    a fuzz run is a harness error (exit 2), never a CPU run."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = fuzz.main(["--iterations", "1", "--artifacts", str(tmp_path)])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err
