"""``ref.ref_skipper_filtered``, the plain twin of the global-tier kernel's
filtered instance (a filter against a stale snapshot of the state, then the
survivors resolved in packs, in tile order), bit for bit against
``ref.ref_skipper`` on the CPU: state, mask, conflicts and the counters
``skipper`` derives from them. Any lag and any pack size must give the same
result; only the number of survivors moves. Inputs are numpy-seeded."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.skipper import stream_tiles
from repro_torch.core.statespec import StateSpec
from repro_torch.graphs import rmat_graph
from repro_torch.interop import edges_from_arrays
from repro_torch.kernels.skipper_match import kernel, ref
from strategies import given, seeds, settings, st

SPECS = {"u8": StateSpec.u8(), "legacy_i32": StateSpec.legacy_i32()}
#: the filter's lag in tiles; None: every tile against the first state
LAGS = [0, 1, 7, None]
TILES = [32, 65, 260, 512, 516]


def _edges(case, m, seed):
    """About ``m`` edges: ``kron`` an RMAT graph (skewed degrees), ``uniform``
    uniform endpoints over m / 4 vertices, ``dense`` 64 vertices (past the
    first tiles nearly every lane dies); each with 5 % self-loops."""
    rng = np.random.default_rng(seed)
    if case == "kron":
        scale = max(5, int(np.log2(max(m // 8, 32))))
        g = rmat_graph(scale, max(1, m >> scale), seed=seed)
        u, v, n = g.u.numpy()[:m], g.v.numpy()[:m], g.num_vertices
    else:
        n = 64 if case == "dense" else max(8, m // 4)
        u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    v = np.where(rng.random(len(u)) < 0.05, u, v)
    return edges_from_arrays(u, v, n)


@functools.lru_cache(maxsize=None)
def _plain(case, tile, tiles, vector_rounds, dispersed=True):
    """The stream's tiles and ``ref_skipper``'s state, mask and conflicts."""
    g = _edges(case, tile * tiles - tile // 3, tiles)
    ut, vt = stream_tiles(g, tile, dispersed)
    state = torch.zeros(g.num_vertices, dtype=torch.uint8)
    matched, conflicts = ref.ref_skipper(state, ut, vt,
                                         vector_rounds=vector_rounds)
    return ut, vt, state, matched, conflicts


def _tiles(tile):
    """Tiles for a stream of about 10,000 edges, and at least 12."""
    return max(12, 10_000 // tile)


def _twin(ut, vt, n, spec, **kw):
    state = torch.zeros(n, dtype=spec.vmem_dtype)
    matched, conflicts, stats = ref.ref_skipper_filtered(state, ut, vt, **kw)
    return state, matched, conflicts, stats


def _same(got, want):
    state, matched, conflicts = want
    g_state, g_matched, g_conflicts = got[:3]
    assert torch.equal(g_state.to(torch.uint8), state)
    assert torch.equal(g_matched, matched)
    assert torch.equal(g_conflicts, conflicts)


@pytest.mark.parametrize("vector_rounds", [1, 2, 3])
@pytest.mark.parametrize("lag", LAGS)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", ["kron", "uniform", "dense"])
def test_twin_equals_ref_skipper(case, tile, lag, vector_rounds):
    """Kron-like, uniform and dense streams, tiles whose last warp is short
    (65, 260, 516) and whole (32, 512), every lag, one to three vector
    rounds: the twin equals ``ref_skipper``. The state width alternates
    with the rounds."""
    ut, vt, *want = _plain(case, tile, _tiles(tile), vector_rounds)
    spec = SPECS["u8" if vector_rounds % 2 else "legacy_i32"]
    got = _twin(ut, vt, want[0].shape[0], spec, vector_rounds=vector_rounds,
                lag=lag)
    _same(got, want)
    stats = got[3]
    valid = int(((ut >= 0) & (ut != vt)).sum())
    assert stats["survivor_lanes"] <= valid
    if lag is None:  # every lane against the first, all-ACC state
        assert stats["survivor_lanes"] == valid


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("vector_rounds", [0, 1, 3])
@pytest.mark.parametrize("dispersed", [True, False])
def test_twin_at_both_widths(spec, vector_rounds, dispersed):
    """Both state widths, no vector round too, both layouts, a pack of a
    few tiles (so packs end inside the lag)."""
    ut, vt, *want = _plain("kron", 65, 150, vector_rounds, dispersed)
    got = _twin(ut, vt, want[0].shape[0], SPECS[spec],
                vector_rounds=vector_rounds, lag=7, pack=200)
    _same(got, want)


@pytest.mark.parametrize("lag", LAGS)
def test_twin_on_a_dense_stream_of_thousands_of_tiles(lag):
    """64 vertices, 2,000 tiles of 32: after the first tiles every lane
    dies, in the filter or at its pack's re-read."""
    ut, vt, *want = _plain("dense", 32, 2000, 1)
    got = _twin(ut, vt, 64, SPECS["u8"], vector_rounds=1, lag=lag)
    _same(got, want)
    assert got[3]["survivor_lanes"] < ut.numel() // 10 or lag is None


@pytest.mark.parametrize("tile", [32, 260])
@pytest.mark.parametrize("case", ["kron", "uniform"])
def test_lag_zero_passes_exactly_the_lanes_free_at_their_tile(case, tile):
    """With no lag the filter reads each tile's state as its tile begins:
    its survivors are the lanes free at round 0, which either match or are
    blocked in round 0 (and count a conflict)."""
    ut, vt, *want = _plain(case, tile, _tiles(tile), 1)
    _, matched, conflicts = want
    got = _twin(ut, vt, want[0].shape[0], SPECS["u8"], lag=0)
    _same(got, want)
    assert got[3]["survivor_lanes"] == int((matched | (conflicts > 0)).sum())


def test_twin_rejects_a_pack_narrower_than_a_tile():
    ut, vt, *want = _plain("uniform", 65, 12, 1)
    with pytest.raises(ValueError, match="pack"):
        _twin(ut, vt, want[0].shape[0], SPECS["u8"], pack=64)
    assert kernel.FILTERED_THREADS >= kernel.BOUNDARY_ASYNC_MAX_THREADS


@settings(max_examples=40, deadline=None)
@given(seed=seeds, tile=st.integers(1, 40), tiles=st.integers(1, 30),
       n=st.integers(2, 80), lag=st.sampled_from([0, 1, 2, 5, None]),
       rounds=st.integers(0, 3), extra=st.integers(0, 60),
       spec=st.sampled_from(sorted(SPECS)), skew=st.booleans())
def test_twin_property(seed, tile, tiles, n, lag, rounds, extra, spec, skew):
    """Any stream, tile, lag, pack (a tile's width and up) and width: the
    twin equals ``ref_skipper``."""
    rng = np.random.default_rng(seed)
    m = tile * tiles
    if skew:
        u = np.minimum(rng.zipf(1.6, m) - 1, n - 1)
        v = np.minimum(rng.zipf(1.6, m) - 1, n - 1)
    else:
        u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    u = np.where(rng.random(m) < 0.05, -1, u)  # padding
    g = edges_from_arrays(u, np.where(u < 0, -1, v), n)
    ut, vt = stream_tiles(g, tile, bool(seed % 2))
    state = torch.zeros(n, dtype=torch.uint8)
    want = (state, *ref.ref_skipper(state, ut, vt, vector_rounds=rounds))
    got = _twin(ut, vt, n, SPECS[spec], vector_rounds=rounds, lag=lag,
                pack=tile + extra)
    _same(got, want)
