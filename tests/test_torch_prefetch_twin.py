"""``ref.ref_boundary_pass_prefetched``, the plain twin of the global-tier
kernel's device-memory instance (each tile's state cells read ahead,
checked against the commits of the tiles in between, later rounds from the
tile's own commits), bit for bit against ``ref.ref_boundary_pass`` and
``ref.ref_skipper`` on the CPU: state, matched and conflicts. Inputs are
numpy-seeded; ``race`` lets a read still in flight see a commit, as a load
on the card may."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core.skipper import stream_tiles
from repro_torch.core.statespec import StateSpec
from repro_torch.graphs import rmat_graph, star_graph
from repro_torch.interop import edges_from_arrays
from repro_torch.kernels.skipper_match import ref

SPECS = {"u8": StateSpec.u8(), "legacy_i32": StateSpec.legacy_i32()}
ROUNDS = [(0, True), (1, True), (2, True), (3, True), (0, False),
          (1, False), (3, False)]


def _pair_tiles(pairs, tile, window, seed, skew=False):
    """Offset-local ids of the given (blk_u, blk_v) pairs, a state with
    some MCHD cells, self-loops and a tenth padding. ``skew`` draws the
    ids from a power law, so a few vertices take most edges."""
    rng = np.random.default_rng(seed)
    bu = np.array([p[0] for p in pairs], np.int32)
    bv = np.array([p[1] for p in pairs], np.int32)
    shape = (len(pairs), tile)

    def ids():
        if skew:
            return np.minimum(rng.zipf(1.6, shape) - 1, window - 1)
        return rng.integers(0, window, shape)

    u = ids()
    v = ids()
    v = np.where(rng.random(shape) < 0.05, u, v)  # self-loops
    v = v + np.where((bu != bv)[:, None], window, 0)
    pad = rng.random(shape) < 0.1
    state = np.where(rng.random((4, window)) < 0.1, 2, 0)
    args = [torch.from_numpy(a.astype(np.int32)) for a in
            (bu, bv, np.where(pad, -1, u), np.where(pad, -1, v))]
    return args, state


def _both(args, state, spec, vector_rounds, fallback, race=None):
    rows = torch.from_numpy(state).to(spec.vmem_dtype)
    rows_p, rows_t = rows.clone(), rows.clone()
    kw = dict(vector_rounds=vector_rounds, fallback=fallback, spec=spec)
    want = ref.ref_boundary_pass(rows_p, *args, **kw)
    gen = None if race is None else torch.Generator().manual_seed(race)
    *got, stats = ref.ref_boundary_pass_prefetched(rows_t, *args, race=gen,
                                                   **kw)
    for a, b in [(rows_t, rows_p), *zip(got, want)]:
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return stats


#: pair sequences: one row (the raw stream's), and cross-block sequences
#: whose consecutive tiles use the same offset-local ids in other rows
PAIRS = {
    "one_row": [(0, 0)] * 9,
    "cross_block": [(0, 1), (2, 3), (0, 1), (1, 2), (2, 2), (3, 3), (0, 3),
                    (1, 2), (0, 1)],
}


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("rounds", ROUNDS)
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("pairs", sorted(PAIRS))
def test_twin_equals_plain_global_tier(spec, rounds, skew, pairs):
    """Random and skewed ids, one row and cross-block pair sequences, every
    vector_rounds with the fallback on and off, at both state widths; with
    and without racing reads."""
    vector_rounds, fallback = rounds
    args, state = _pair_tiles(PAIRS[pairs], 24, 48, 1 + 7 * skew)
    for race in (None, 1):
        _both(args, state, SPECS[spec], vector_rounds, fallback, race)


@pytest.mark.parametrize("tile", [1, 2, 31, 100, 512, 896])
def test_twin_at_each_tile_width(tile):
    """Tiles of 1 to 896 lanes (the device instance's widest), cross-block
    pairs and a racing read."""
    args, state = _pair_tiles(PAIRS["cross_block"], tile, 3 * tile + 5, tile)
    stats = _both(args, state, StateSpec.u8(), 1, True, race=tile)
    assert stats["free_rounds"] >= stats["free_tiles"]


def test_twin_counts_stale_lanes_and_later_rounds():
    """A lane on a vertex the tile before committed reads ACC/ACC ahead and
    is stale; a path inside a tile needs a round after round 0. Racing
    reads can only lower the stale count."""
    tile, tiles = 16, 6
    u = np.full((tiles, tile), -1)
    v = np.full((tiles, tile), -1)
    for k in range(tiles):
        u[k, :3] = 100 + 10 * k, 101 + 10 * k, 102 + 10 * k  # a path
        v[k, :3] = 101 + 10 * k, 102 + 10 * k, 103 + 10 * k
        if k:
            u[k, 3], v[k, 3] = 100 + 10 * (k - 1), 200 + k  # stale
    zeros = np.zeros(tiles, np.int32)
    args = [torch.from_numpy(a.astype(np.int32)) for a in (zeros, zeros, u, v)]
    state = np.zeros((1, 256), np.int64)
    stats = _both(args, state, StateSpec.u8(), 1, True)
    assert stats == dict(stale_lanes=tiles - 1, later_round_tiles=tiles,
                         free_tiles=tiles, free_rounds=2 * tiles)
    raced = _both(args, state, StateSpec.u8(), 1, True, race=3)
    assert raced["stale_lanes"] <= stats["stale_lanes"]


def _raw_stream(case):
    if case == "rmat":
        return rmat_graph(9, 8, seed=3)
    if case == "star":
        return star_graph(300)
    rng = np.random.default_rng(5)
    n, m = 200, 1200
    u = rng.integers(0, n, m)
    v = np.where(rng.random(m) < 0.1, u, rng.integers(0, n, m))
    return edges_from_arrays(u, v, n)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("dispersed", [True, False])
@pytest.mark.parametrize("tile", [3, 64, 512])
@pytest.mark.parametrize("case", ["rmat", "star", "uniform"])
def test_twin_equals_ref_skipper(spec, dispersed, tile, case):
    """The raw stream (one state row, every tile the pair (0, 0)), laid out
    as ``skipper`` lays it out: the twin equals ``ref_skipper``."""
    g = _raw_stream(case)
    sp = SPECS[spec]
    ut, vt = stream_tiles(g, tile, dispersed)
    n = g.num_vertices
    state = torch.zeros(n, dtype=sp.at_rest_dtype)
    matched, conflicts = ref.ref_skipper(state, ut, vt, vector_rounds=2)
    row = torch.zeros((1, n), dtype=sp.vmem_dtype)
    pairs = torch.zeros((ut.shape[0],), dtype=torch.int32)
    got_m, got_c, _ = ref.ref_boundary_pass_prefetched(
        row, pairs, pairs, ut, vt, vector_rounds=2, spec=sp,
        race=torch.Generator().manual_seed(tile))
    torch.testing.assert_close(row[0].to(sp.at_rest_dtype), state, rtol=0,
                               atol=0)
    assert torch.equal(got_m > 0, matched)
    assert torch.equal(got_c.to(torch.int32), conflicts)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), tile=st.integers(1, 40),
       tiles=st.integers(1, 12), window=st.integers(2, 60),
       rounds=st.sampled_from(ROUNDS), spec=st.sampled_from(sorted(SPECS)),
       skew=st.booleans(), race=st.booleans())
def test_twin_property(seed, tile, tiles, window, rounds, spec, skew, race):
    """Any pair sequence over four rows, any tile, window, rounds and
    width: the twin equals the plain global tier."""
    rng = np.random.default_rng(seed)
    pairs = [tuple(sorted(p)) for p in rng.integers(0, 4, (tiles, 2))]
    args, state = _pair_tiles(pairs, tile, window, seed, skew)
    _both(args, state, SPECS[spec], *rounds, race=seed if race else None)
