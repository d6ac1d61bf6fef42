"""The port's validators and sequential oracle against ``repro.core``:
``check_matching`` (degenerate and out-of-range inputs included),
``check_state_domain``, ``assert_matching``'s first-offending-edge message
and ``sgmm``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strategies import adversarial_edge_list, random_edge_list

from repro.core import sgmm as j_sgmm
from repro.core.validate import (
    assert_matching as j_assert,
    check_matching as j_check,
    check_state_domain as j_domain,
)
from repro.graphs import generators as jgen
from repro.graphs.types import EdgeList as JEdgeList

from repro_torch.core import (
    assert_matching,
    check_matching,
    check_state_domain,
    sgmm,
)
from repro_torch.interop import edges_from_arrays


def _pair(u, v, n):
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    return (JEdgeList(jnp.asarray(u), jnp.asarray(v), n),
            edges_from_arrays(u, v, n))


def _from_ref(g):
    return _pair(np.asarray(g.u), np.asarray(g.v), g.num_vertices)


def _check_equal(jg, tg, mask):
    ref = j_check(jg, jnp.asarray(mask))
    port = check_matching(tg, torch.from_numpy(np.array(mask)))
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].item() == np.asarray(ref[k]).item(), k


@pytest.mark.parametrize("seed", range(6))
def test_check_matching_random_masks(seed):
    jg, tg = _from_ref(random_edge_list(seed, 40, 120, self_loops=0.1,
                                        duplicates=0.1, invalid=0.1))
    rng = np.random.default_rng(seed)
    for p in (0.0, 0.05, 0.3):
        _check_equal(jg, tg, rng.random(120) < p)
    _check_equal(jg, tg, np.asarray(j_sgmm(jg).match_mask))


@pytest.mark.parametrize("case", [
    ("no_edges", np.zeros(0), np.zeros(0), 5, np.zeros(0, bool)),
    ("no_vertices", [0], [1], 0, np.ones(1, bool)),
    ("out_of_range", [0, 1, 2], [9, 2, 3], 4, np.array([1, 0, 0], bool)),
    ("only_padding", [-1, -1], [-1, -1], 3, np.zeros(2, bool)),
    ("self_loop_selected", [2, 0], [2, 1], 3, np.array([1, 0], bool)),
], ids=lambda c: c[0])
def test_check_matching_degenerate(case):
    _, u, v, n, mask = case
    jg, tg = _pair(u, v, n)
    _check_equal(jg, tg, mask)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_check_state_domain_equal(dtype):
    for vals in ([0, 2, 2, 0], [0, 1, 2, 7], [1, 1, 9, 0], []):
        a = np.asarray(vals, dtype)
        ref = j_domain(jnp.asarray(a))
        port = check_state_domain(torch.from_numpy(a))
        for k in ref:
            assert port[k].item() == np.asarray(ref[k]).item(), (vals, k)


def _messages(jg, tg, mask):
    with pytest.raises(AssertionError) as jex:
        j_assert(jg, jnp.asarray(mask), "lbl")
    with pytest.raises(AssertionError) as tex:
        assert_matching(tg, torch.from_numpy(mask), "lbl")
    return str(jex.value).split("\n")[0], str(tex.value)


def test_assert_matching_messages_equal():
    jg, tg = _pair([0, 2, 1, 3], [1, 3, 2, 4], 5)
    # collision: edges 0 and 2 share vertex 1
    ref, port = _messages(jg, tg, np.array([1, 0, 1, 0], bool))
    assert port == ref
    assert "first offending edge (1, 2) at stream index 2" in port
    # not maximal: nothing selected
    ref, port = _messages(jg, tg, np.zeros(4, bool))
    assert port == ref
    assert "first offending edge (0, 1) at stream index 0" in port
    ok = assert_matching(tg, torch.tensor([True, True, False, False]))
    assert ok == {"valid": True, "maximal": True, "num_matches": 2,
                  "num_covered_vertices": 4}


@pytest.mark.parametrize("make", [
    lambda: jgen.rmat_graph(8, 8, seed=5),
    lambda: jgen.star_graph(50),
    lambda: jgen.ring_graph(33),
    lambda: adversarial_edge_list(3),
    lambda: random_edge_list(9, 30, 100, self_loops=0.2, duplicates=0.3,
                             invalid=0.1),
], ids=["rmat", "star", "ring", "adversarial", "hazards"])
def test_sgmm_equal(make):
    jg, tg = _from_ref(make())
    ref, port = j_sgmm(jg), sgmm(tg)
    np.testing.assert_array_equal(port.match_mask.numpy(),
                                  np.asarray(ref.match_mask))
    assert port.state.dtype == torch.uint8
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))
    for f in ("edge_reads", "state_loads", "state_stores", "rounds"):
        assert int(getattr(port.counters, f)) == int(getattr(ref.counters, f))
    assert_matching(tg, port.match_mask)
