"""The port's raw-stream ``skipper`` on the CPU (its plain version,
``ref.ref_skipper``) against the JAX package's ``skipper`` on the same
numpy-seeded inputs: mask, state and its dtype, per-edge conflicts and the
four ``Counters``, bit for bit (tolerance: exact equality; the slice has no
floats). Also the graph helpers it brings along (``pad_edges``, the CSR
helpers, ``bipartite_graph``) and ``conflict_table``, each equal to the
reference's."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.conflicts import conflict_table as j_conflict_table
from repro.core.skipper import skipper as j_skipper
from repro.core.statespec import StateSpec as JSpec
from repro.graphs import csr as j_csr
from repro.graphs import generators as jgen
from repro.graphs.partition import pad_edges as j_pad_edges
from repro.graphs.types import EdgeList as JEdgeList

from repro_torch.core import StateSpec, conflict_table, skipper
from repro_torch.core.skipper import CONFLICT_METHODS
from repro_torch.graphs import (
    bipartite_graph,
    dedup_edges,
    edges_to_csr,
    pad_edges,
    symmetrize,
)
from repro_torch.interop import edges_from_arrays
from repro_torch.kernels.skipper_match import kernel

COUNTERS = ("edge_reads", "state_loads", "state_stores", "rounds")
SPECS = {"u8": (StateSpec.u8(), JSpec.u8()),
         "legacy_i32": (StateSpec.legacy_i32(), JSpec.legacy_i32())}

# the reference's graph zoo (tests/test_matching_core.py:21)
ZOO = {
    "path": lambda: jgen.path_graph(257),
    "ring": lambda: jgen.ring_graph(100),
    "star": lambda: jgen.star_graph(100),
    "grid": lambda: jgen.grid_graph(24, 24),
    "er": lambda: jgen.erdos_renyi_graph(2000, 8000, seed=1),
    "rmat": lambda: jgen.rmat_graph(10, 8, seed=2),
}


def _pair_arrays(u, v, n):
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    return JEdgeList(jnp.asarray(u), jnp.asarray(v), n), edges_from_arrays(
        u, v, n)


def _pair(g):
    return _pair_arrays(np.asarray(g.u), np.asarray(g.v), g.num_vertices)


def _run_both(name_or_graph, *, spec="u8", **kw):
    g = ZOO[name_or_graph]() if isinstance(name_or_graph, str) \
        else name_or_graph
    jg, pg = _pair(g)
    pspec, jspec = SPECS[spec]
    ref = j_skipper(jg, spec=jspec, **kw)
    port = skipper(pg, spec=pspec, device="cpu", **kw)
    return port, ref


def assert_same(port, ref, with_conflicts=True):
    (r, c), (jr, jc) = port, ref
    assert r.match_mask.dtype == torch.bool
    np.testing.assert_array_equal(r.match_mask.numpy(),
                                  np.asarray(jr.match_mask))
    js = np.asarray(jr.state)
    assert r.state.numpy().dtype == js.dtype
    np.testing.assert_array_equal(r.state.numpy(), js)
    for f in COUNTERS:
        got, want = getattr(r.counters, f), getattr(jr.counters, f)
        assert got.dtype == torch.int32, f
        assert int(got) == int(want), f
    if with_conflicts:
        assert c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    else:
        assert c is None and jc is None


@pytest.mark.parametrize("gname", sorted(ZOO))
def test_skipper_equals_reference_on_the_zoo(gname):
    """The zoo at the reference's test tile (128), dispersed, one vector
    round: every output bit-equal, and the Table II summary of the
    conflicts equal to the reference's."""
    port, ref = _run_both(gname, tile_size=128, with_conflicts=True)
    assert_same(port, ref)
    assert conflict_table(port[1].numpy()) == j_conflict_table(
        np.asarray(ref[1]))


# (graph, tile, dispersed, vector_rounds, spec): a few fixed shapes, so the
# reference's jitted body compiles a few times, not per case
CASES = [
    ("rmat", 32, True, 1, "u8"),
    ("rmat", 512, False, 3, "legacy_i32"),
    ("rmat", 128, True, 0, "legacy_i32"),
    ("grid", 32, False, 0, "u8"),
    ("grid", 128, True, 3, "legacy_i32"),
    ("path", 512, True, 0, "legacy_i32"),
    ("path", 32, False, 3, "u8"),
    ("er", 128, False, 1, "legacy_i32"),
    ("star", 32, True, 3, "u8"),
    ("ring", 512, False, 1, "u8"),
]


@pytest.mark.parametrize("gname,tile,dispersed,vr,spec", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_skipper_parameters_equal_reference(gname, tile, dispersed, vr,
                                            spec):
    port, ref = _run_both(gname, spec=spec, tile_size=tile,
                          dispersed=dispersed, vector_rounds=vr,
                          with_conflicts=True)
    assert_same(port, ref)


def test_skipper_without_conflicts_returns_none():
    port, ref = _run_both("grid", tile_size=128)
    assert_same(port, ref, with_conflicts=False)


def _hazard_graph():
    """Self-loops, (-1, -1) padding, half-invalid slots (-1, x) and
    duplicates in one numpy-seeded stream."""
    rng = np.random.default_rng(11)
    n, m = 300, 1500
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    v = np.where(rng.random(m) < 0.1, u, v)
    pad = rng.random(m) < 0.05
    u, v = np.where(pad, -1, u), np.where(pad, -1, v)
    half = rng.random(m) < 0.03
    u = np.where(half, -1, u)
    dup = rng.random(m) < 0.1
    src = rng.integers(0, m, m)
    u, v = np.where(dup, u[src], u), np.where(dup, v[src], v)
    return jgen._as_edgelist(u, v, n)


@pytest.mark.parametrize("dispersed", [True, False])
def test_skipper_self_loops_padding_and_duplicates(dispersed):
    port, ref = _run_both(_hazard_graph(), tile_size=32, dispersed=dispersed,
                          with_conflicts=True, vector_rounds=2)
    assert_same(port, ref)


@pytest.mark.parametrize("m", [0, 5])
def test_skipper_empty_and_all_invalid(m):
    """No edges at all, and a stream of self-loops and padding only: no
    match, all-ACC state, the reference's counters."""
    u = np.array([3, -1, 0, 2, -1][:m])
    v = np.array([3, -1, 0, 2, -1][:m])
    g = jgen._as_edgelist(u, v, 8)
    port, ref = _run_both(g, tile_size=32, with_conflicts=True)
    assert_same(port, ref)
    assert not port[0].match_mask.any()


@pytest.mark.parametrize("method", CONFLICT_METHODS)
def test_conflict_method_never_changes_the_output(method):
    """``conflict_method`` reaches the plain version's blocked predicate;
    every method gives the reference's output."""
    port, ref = _run_both("rmat", tile_size=128, with_conflicts=True,
                          conflict_method=method)
    assert_same(port, ref)


def test_skipper_rejects_unknown_conflict_method():
    _, pg = _pair(jgen.path_graph(10))
    with pytest.raises(ValueError, match="conflict_method"):
        skipper(pg, conflict_method="bogus", device="cpu")


def test_skipper_verify_and_launch_nothing_on_cpu():
    """``verify=True`` passes on a valid result; on the CPU the plain
    version runs and no kernel launches."""
    _, pg = _pair(jgen.erdos_renyi_graph(500, 2000, seed=4))
    kernel.reset_launch_counts()
    res, _ = skipper(pg, tile_size=64, verify=True, device="cpu")
    assert int(res.match_mask.sum()) > 0
    assert set(kernel.launch_counts().values()) == {0}


def test_skipper_verify_raises_on_a_failed_check(monkeypatch):
    """``verify=True`` raises ``RuntimeError`` when the check fails (here
    the check is made to report a non-maximal matching)."""
    import importlib

    # the package's ``skipper`` name is the function; this is its module
    skipper_mod = importlib.import_module("repro_torch.core.skipper")

    def failing(edges, mask):
        return {"valid": torch.tensor(True), "maximal": torch.tensor(False)}

    monkeypatch.setattr(skipper_mod, "check_matching", failing)
    _, pg = _pair(jgen.path_graph(10))
    with pytest.raises(RuntimeError, match="maximal=False"):
        skipper(pg, verify=True, device="cpu")
    skipper(pg, device="cpu")  # without verify, no check runs


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("gname", ["rmat", "path"])
def test_one_row_global_tier_equals_ref_skipper(gname, spec):
    """The card's route, ``kernel.tiles_on_card`` (the global tier over one
    state row of n cells, every tile the pair (0, 0)), given CPU tiles runs
    the global tier's plain version; that equals ``ref.ref_skipper``, the
    raw stream's plain version, bit for bit: state, mask, conflicts; and
    nothing launches."""
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.kernels.skipper_match import ref

    _, pg = _pair(ZOO[gname]())
    s = SPECS[spec][0]
    n = pg.num_vertices
    ut, vt = stream_tiles(pg, 32)
    state = torch.zeros(n, dtype=s.at_rest_dtype)
    matched, conflicts = ref.ref_skipper(state, ut, vt, vector_rounds=2)
    kernel.reset_launch_counts()
    row = torch.zeros(n, dtype=s.vmem_dtype)
    got = kernel.tiles_on_card(row, ut, vt, vector_rounds=2, spec=s)
    got = (row.to(s.at_rest_dtype), got[0], got[1].to(torch.int32))
    for a, b in zip(got, (state, matched, conflicts)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(kernel.launch_counts().values()) == {0}


def test_one_row_global_tier_counts_its_in_order_lanes_when_traced():
    """Off the card ``tiles_on_card`` walks every tile in order: under a
    profiler the counter it is given reads every valid lane, and nothing
    counts it outside one; the filtered instance is a card's alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.core.skipper import stream_tiles

    _, pg = _pair(ZOO["rmat"]())
    ut, vt = stream_tiles(pg, 32)
    assert not kernel.takes_filtered(10 ** 6, 32, "cpu")
    tracing.reset()
    row = torch.zeros(pg.num_vertices, dtype=torch.uint8)
    kernel.tiles_on_card(row, ut, vt, counter="test.lanes")
    assert "test.lanes" not in tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        kernel.tiles_on_card(row.zero_(), ut, vt, counter="test.lanes")
    assert tracing.counters()["test.lanes"] == int(
        ((ut >= 0) & (ut != vt)).sum())
    tracing.reset()


# ------------------------------------------------------------ graph helpers

@pytest.mark.parametrize("multiple", [1, 7, 32, 512])
def test_pad_edges_equals_reference(multiple):
    jg, pg = _pair(_hazard_graph())
    want = j_pad_edges(jg, multiple)
    got = pad_edges(pg, multiple)
    assert got.num_vertices == want.num_vertices
    for a, b in ((got.u, want.u), (got.v, want.v)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("drop", [True, False])
def test_dedup_and_symmetrize_equal_reference(drop):
    jg, pg = _pair(_hazard_graph())
    for got, want in ((dedup_edges(pg, drop), j_csr.dedup_edges(jg, drop)),
                      (symmetrize(pg), j_csr.symmetrize(jg))):
        assert got.num_vertices == want.num_vertices
        np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


@pytest.mark.parametrize("symmetric", [True, False])
def test_edges_to_csr_equals_reference(symmetric):
    jg, pg = _pair(jgen.rmat_graph(8, 8, seed=5))
    got = edges_to_csr(pg, symmetric)
    want = j_csr.edges_to_csr(jg, symmetric)
    assert got.num_vertices == want.num_vertices
    assert got.num_edges == want.num_edges
    assert got.offsets.dtype == torch.int32
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    assert got.degree(3) == want.degree(3)


@pytest.mark.parametrize("seed", [0, 9])
def test_bipartite_graph_equals_reference(seed):
    got = bipartite_graph(40, 12, 300, seed=seed)
    want = jgen.bipartite_graph(40, 12, 300, seed=seed)
    assert got.num_vertices == want.num_vertices == 52
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


def test_conflict_table_equals_reference():
    rng = np.random.default_rng(2)
    c = np.where(rng.random(5000) < 0.1, rng.integers(1, 400, 5000), 0)
    c = c.astype(np.int32)
    assert conflict_table(c) == j_conflict_table(c)
    assert conflict_table(np.zeros(0, np.int32)) == j_conflict_table(
        np.zeros(0, np.int32))
