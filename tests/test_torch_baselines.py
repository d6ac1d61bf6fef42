"""The port's EMS baselines on the CPU against the JAX package's, on the
same numpy-seeded graphs (tolerance: exact equality; no floats).

``ems_idmm`` is deterministic and bit-equal as it is. ``ems_israeli_itai``
and ``sidmm`` draw JAX permutations in the reference, which torch cannot
reproduce: given the reference's own permutations (built here with JAX)
they are bit-equal — mask, state and all four counters; with the port's
own (``torch.randperm`` from a seeded generator) they are held on their
properties. The reference's own property tests of the baselines are
restated on the port."""
import jax
import numpy as np
import pytest
import torch

from repro.core.ems import ems_idmm as j_idmm
from repro.core.ems import ems_israeli_itai as j_ii
from repro.core.ems import sidmm as j_sidmm
from repro.graphs import generators as jgen
from repro.graphs.types import EdgeList as JEdgeList

from repro_torch.core import (
    assert_matching,
    conflict_table,
    ems_idmm,
    ems_israeli_itai,
    sgmm,
    sidmm,
    skipper,
)
from repro_torch.core.ems import MAX_ROUNDS
from repro_torch.graphs import (
    erdos_renyi_graph,
    grid_graph,
    rmat_graph,
)
from repro_torch.interop import edges_from_arrays

COUNTERS = ("edge_reads", "state_loads", "state_stores", "rounds")

GRAPHS = {
    "path": lambda: jgen.path_graph(257),
    "star": lambda: jgen.star_graph(100),
    "grid": lambda: jgen.grid_graph(24, 24),
    "er": lambda: jgen.erdos_renyi_graph(2000, 8000, seed=1),
    "rmat": lambda: jgen.rmat_graph(10, 8, seed=2),
}


def _pair(name):
    g = GRAPHS[name]()
    u, v = np.asarray(g.u, np.int32), np.asarray(g.v, np.int32)
    return (JEdgeList(jax.numpy.asarray(u), jax.numpy.asarray(v),
                      g.num_vertices),
            edges_from_arrays(u, v, g.num_vertices))


def assert_same(port, ref):
    np.testing.assert_array_equal(port.match_mask.numpy(),
                                  np.asarray(ref.match_mask))
    js = np.asarray(ref.state)
    assert port.state.numpy().dtype == js.dtype
    np.testing.assert_array_equal(port.state.numpy(), js)
    for f in COUNTERS:
        got = getattr(port.counters, f)
        assert got.dtype == torch.int32, f
        assert int(got) == int(getattr(ref.counters, f)), f


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_idmm_equals_reference(gname):
    jg, pg = _pair(gname)
    assert_same(ems_idmm(pg, device="cpu"), j_idmm(jg))


def _reference_priorities(m):
    """The reference's per-round permutations: ``permutation(fold_in(
    PRNGKey(0), round), m)`` (``ems.py:81``-``:82``)."""
    base = jax.random.PRNGKey(0)

    def priorities(rnd):
        key = jax.random.fold_in(base, rnd)
        return torch.from_numpy(
            np.asarray(jax.random.permutation(key, m)).astype(np.int32))

    return priorities


@pytest.mark.parametrize("gname", ["rmat", "er", "star"])
def test_israeli_itai_equals_reference_given_its_permutations(gname):
    jg, pg = _pair(gname)
    port = ems_israeli_itai(pg, priorities=_reference_priorities(pg.num_edges),
                            device="cpu")
    assert_same(port, j_ii(jg))


@pytest.mark.parametrize("gname", ["rmat", "grid"])
@pytest.mark.parametrize("batch", [512, 2048])
def test_sidmm_equals_reference_given_its_permutation(gname, batch):
    """The reference permutes the stream padded to whole batches with
    ``permutation(PRNGKey(seed), mp)`` (``ems.py:136``)."""
    jg, pg = _pair(gname)
    seed = 3
    mp = -(-pg.num_edges // batch) * batch
    perm = torch.from_numpy(np.asarray(jax.random.permutation(
        jax.random.PRNGKey(seed), mp)).astype(np.int64))
    port = sidmm(pg, batch_size=batch, perm=perm, device="cpu")
    assert_same(port, j_sidmm(jg, batch_size=batch, seed=seed))


def test_sidmm_rejects_a_permutation_of_the_wrong_length():
    _, pg = _pair("grid")
    with pytest.raises(ValueError, match="perm must be"):
        sidmm(pg, batch_size=512, perm=torch.arange(5), device="cpu")


@pytest.mark.parametrize("gname", ["rmat", "star"])
def test_own_permutations_valid_maximal_and_seeded(gname):
    """Without the reference's permutations the port draws its own from a
    seeded generator: valid, maximal, the same for a seed, and the EMS
    loop within its round cap."""
    _, pg = _pair(gname)
    for run in (lambda s: ems_israeli_itai(pg, seed=s, device="cpu"),
                lambda s: sidmm(pg, batch_size=512, seed=s, device="cpu")):
        a, b, c = run(1), run(1), run(2)
        assert_matching(pg, a.match_mask, gname)
        assert_matching(pg, c.match_mask, gname)
        assert torch.equal(a.match_mask, b.match_mask)
        assert torch.equal(a.state, b.state)
        for f in COUNTERS:
            assert int(getattr(a.counters, f)) == int(getattr(b.counters, f))
    assert int(ems_israeli_itai(pg, seed=1, device="cpu").counters.rounds) \
        <= MAX_ROUNDS


# ------------------------------------ the reference's property tests, ported

ALGOS = {
    "sgmm": lambda g: sgmm(g),
    "skipper": lambda g: skipper(g, tile_size=128, device="cpu")[0],
    "ems_ii": lambda g: ems_israeli_itai(g, device="cpu"),
    "ems_idmm": lambda g: ems_idmm(g, device="cpu"),
    "sidmm": lambda g: sidmm(g, batch_size=512, device="cpu"),
}


def test_matching_sizes_comparable():
    """All maximal matchings are within 2x of each other (any maximal
    matching is a 1/2-approximation of maximum)."""
    g = erdos_renyi_graph(3000, 12000, seed=3)
    sizes = {}
    for name, fn in ALGOS.items():
        r = fn(g)
        assert_matching(g, r.match_mask, name)
        sizes[name] = int(r.num_matches)
    lo, hi = min(sizes.values()), max(sizes.values())
    assert hi <= 2 * lo, sizes


def test_skipper_single_pass_work_efficiency():
    """Fig. 7 analogue: Skipper's accesses per edge stay in the paper's
    band; SIDMM pays more than twice as many."""
    g = rmat_graph(12, 16, seed=4)
    r_skip = skipper(g, tile_size=256, device="cpu")[0]
    r_sidmm = sidmm(g, batch_size=2048, device="cpu")
    per_edge_skip = int(r_skip.counters.total_accesses) / g.num_edges
    per_edge_sidmm = int(r_sidmm.counters.total_accesses) / g.num_edges
    assert per_edge_skip < 4.5, per_edge_skip
    assert per_edge_sidmm > 2 * per_edge_skip, (per_edge_skip, per_edge_sidmm)


def test_skipper_rounds_is_one():
    g = erdos_renyi_graph(1000, 4000, seed=5)
    assert int(skipper(g, device="cpu")[0].counters.rounds) == 1
    assert int(sidmm(g, batch_size=512, device="cpu").counters.rounds) > 1


def test_dispersed_scheduler_reduces_conflicts():
    """§IV-C/V-B: thread-dispersed scheduling makes JIT conflicts rare on
    high-locality graphs."""
    g = grid_graph(40, 40)
    _, c_disp = skipper(g, tile_size=256, with_conflicts=True,
                        dispersed=True, device="cpu")
    _, c_cont = skipper(g, tile_size=256, with_conflicts=True,
                        dispersed=False, device="cpu")
    assert int(c_disp.sum()) < int(c_cont.sum()) / 3


def test_conflicts_rare_on_random_graphs():
    """Table II analogue: conflict ratio well under 1% on random inputs."""
    g = erdos_renyi_graph(20000, 100000, seed=6)
    _, conf = skipper(g, tile_size=256, with_conflicts=True, device="cpu")
    tbl = conflict_table(conf.numpy())
    assert tbl["conflict_ratio"] < 0.01, tbl
