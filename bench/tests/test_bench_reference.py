"""The plain reference: its check agrees with a brute-force reading of
validity and maximality on tiny graphs, and the plain greedy matcher is
the sequential greedy."""
import itertools
import random

import pytest
import torch

from bench.generators import generate
from bench.reference import maximal_matching as mm
from bench.reference.greedy import greedy


def brute(u, v, n, mask):
    """(valid, maximal) by the definitions, one edge at a time."""
    ends = [0] * n
    for a, b, s in zip(u, v, mask):
        if s:
            if a == b or not (0 <= a < n and 0 <= b < n):
                return False, None
            ends[a] += 1
            ends[b] += 1
    if any(e > 1 for e in ends):
        return False, None
    maximal = all(ends[a] or ends[b] for a, b in zip(u, v)
                  if a != b and 0 <= a < n and 0 <= b < n)
    return True, maximal


def tiny_graphs(count=40, seed=0):
    rng = random.Random(seed)
    for _ in range(count):
        n = rng.randint(1, 5)
        m = rng.randint(0, 7)
        u = [rng.randint(-1, n - 1) for _ in range(m)]
        v = [rng.randint(-1, n - 1) if a >= 0 else -1 for a in u]
        yield u, v, n


def state_of(u, v, n, mask):
    st = [mm.ACC] * n
    for a, b, s in zip(u, v, mask):
        if s and 0 <= a < n and 0 <= b < n and a != b:
            st[a] = st[b] = mm.MCHD
    return st


@pytest.mark.parametrize("graph", list(tiny_graphs()))
def test_check_agrees_with_brute_force(graph):
    u, v, n = graph
    ut = torch.tensor(u, dtype=torch.int32)
    vt = torch.tensor(v, dtype=torch.int32)
    for mask in itertools.product([False, True], repeat=len(u)):
        st = torch.tensor(state_of(u, v, n, mask), dtype=torch.uint8)
        got = mm.check(ut, vt, n, torch.tensor(mask, dtype=torch.bool), st)
        valid, maximal = brute(u, v, n, mask)
        assert (got["invalid"] == 0) == valid
        if valid:
            assert (got["uncovered"] == 0) == maximal
        assert got["state_off"] == 0 or not valid


def test_state_offences_are_counted():
    u = torch.tensor([0, 2], dtype=torch.int32)
    v = torch.tensor([1, 3], dtype=torch.int32)
    mask = torch.tensor([True, True])
    good = torch.tensor([2, 2, 2, 2], dtype=torch.uint8)
    assert mm.check(u, v, 4, mask, good) == {
        "shape_off": 0, "invalid": 0, "uncovered": 0, "state_off": 0}
    bad = torch.tensor([2, 0, 1, 2], dtype=torch.uint8)
    assert mm.check(u, v, 4, mask, bad)["state_off"] == 2


def test_wrong_lengths_are_counted():
    u = torch.tensor([0, 1], dtype=torch.int32)
    v = torch.tensor([1, 2], dtype=torch.int32)
    got = mm.check(u, v, 3, torch.tensor([True]),
                   torch.zeros(3, dtype=torch.uint8))
    assert got["shape_off"] == 1


def sequential(u, v, n):
    matched, mask = [False] * n, []
    for a, b in zip(u.tolist(), v.tolist()):
        ok = a != b and 0 <= a < n and 0 <= b < n and not (
            matched[a] or matched[b])
        if ok:
            matched[a] = matched[b] = True
        mask.append(ok)
    return torch.tensor(mask, dtype=torch.bool)


@pytest.mark.parametrize("gen", ["kron", "urand"])
@pytest.mark.parametrize("seed", [1, 2**33 + 1])
def test_greedy_is_the_sequential_greedy(gen, seed):
    g = generate({"generator": gen, "scale": 10, "edge_factor": 16,
                  "a": 0.57, "b": 0.19, "c": 0.19}, seed, "cpu")
    mask, state, rounds = greedy(g.u, g.v, g.n)
    assert torch.equal(mask, sequential(g.u, g.v, g.n))
    assert rounds > 1
    assert all(x == 0 for x in mm.check(g.u, g.v, g.n, mask, state).values())


@pytest.mark.parametrize("graph", list(tiny_graphs(20, seed=3)))
def test_greedy_on_tiny_graphs(graph):
    u, v, n = graph
    ut = torch.tensor(u, dtype=torch.int32)
    vt = torch.tensor(v, dtype=torch.int32)
    mask, _, _ = greedy(ut, vt, n)
    assert mask.tolist() == sequential(ut, vt, n).tolist()
