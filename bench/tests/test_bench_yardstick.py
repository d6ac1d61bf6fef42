"""The frozen yardstick counts the problem's work: one graph gives one
count, whatever schedule the program builds for it."""
import pytest
import torch

from bench import yardstick
from bench.adapters import skipper_match, skipper_raw
from bench.generators import generate

TRAFFIC = {"schedule": {"window": 65536, "tile_size": 256,
                        "reorder": "degree"},
           "call": {"vector_rounds": 1, "spec": "u8"}}


def graph(gen="kron", scale=13, seed=4):
    return generate({"generator": gen, "scale": scale, "edge_factor": 16,
                     "a": 0.57, "b": 0.19, "c": 0.19}, seed, "cpu")


def work(g, window):
    traffic = dict(TRAFFIC, schedule=dict(TRAFFIC["schedule"],
                                          window=window))
    return skipper_match.prepare(g, traffic, torch.device("cpu")).work


def test_frozen_rates():
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
    assert yardstick.problem_bytes(10, 3) == 9 * 10 + 2 * 3
    assert yardstick.least_seconds(0, 0) == 0.0
    with pytest.raises(ValueError):
        yardstick.problem_bytes(-1, 0)


def test_full_size_count():
    # kron22: 67,108,864 edges and 4,194,304 vertices
    assert yardstick.problem_bytes(67_108_864, 4_194_304) == 612_368_384


@pytest.mark.parametrize("gen", ["kron", "urand"])
def test_same_count_under_two_schedules(gen):
    g = graph(gen)
    valid = int(((g.u != g.v)).sum())
    a, b = work(g, 65536), work(g, 4096)
    assert a["call"] == b["call"] == {"edges": g.m, "vertices": g.n}
    for w in (a, b):
        # the tiers split the valid edges between them, nothing padded
        assert w["window_tier"]["edges"] + w["global_tier"]["edges"] == valid
        assert w["window_tier"]["vertices"] <= g.n
    assert (yardstick.problem_bytes(**a["call"])
            == yardstick.problem_bytes(**b["call"]))
    # the raw stream's call is the same problem
    raw = skipper_raw.prepare(g, {"call": {"tile_size": 512,
                                           "vector_rounds": 1,
                                           "spec": "u8"}},
                              torch.device("cpu")).work
    assert raw["call"] == a["call"]
    assert raw["global_tier"]["edges"] == valid
