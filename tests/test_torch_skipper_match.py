"""The port's ``skipper_match`` and ``skipper_match_window`` on the CPU
against the JAX package's (``backend="xla"``, and the Pallas window kernel
in interpret mode): mask, state, conflicts and ``Counters`` bit-equal."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.statespec import StateSpec as JSpec
from repro.graphs import generators as jgen
from repro.graphs.types import EdgeList as JEdgeList
from repro.graphs.windows import build_window_schedule as j_build
from repro.kernels.skipper_match import skipper_match as j_match
from repro.kernels.skipper_match import skipper_match_window as j_window

from repro_torch.core import assert_matching
from repro_torch.core.statespec import StateSpec
from repro_torch.core.types import Counters, MatchResult
from repro_torch.interop import (
    edges_from_arrays,
    schedule_from_arrays,
    spec_from_names,
)
from repro_torch.kernels.skipper_match import (
    ops,
    skipper_match,
    skipper_match_window,
)

SPECS = ["u8", "legacy_i32"]
COUNTERS = ("edge_reads", "state_loads", "state_stores", "rounds")


def _pair(u, v, n):
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    return (JEdgeList(jnp.asarray(u), jnp.asarray(v), n),
            edges_from_arrays(u, v, n))


def _from_ref(g):
    return _pair(np.asarray(g.u), np.asarray(g.v), g.num_vertices)


def _graph(name):
    return _from_ref({
        "rmat10": lambda: jgen.rmat_graph(10, 4, seed=1),
        "grid": lambda: jgen.grid_graph(16, 20),
        "star": lambda: jgen.star_graph(300),
        "path": lambda: jgen.path_graph(400),
        "er": lambda: jgen.erdos_renyi_graph(500, 1800, seed=2),
    }[name]())


def assert_results_equal(port, ref):
    (r, c), (jr, jc) = port, ref
    assert r.match_mask.dtype == torch.bool
    np.testing.assert_array_equal(r.match_mask.numpy(),
                                  np.asarray(jr.match_mask))
    assert r.state.dtype == torch.uint8
    np.testing.assert_array_equal(r.state.numpy(), np.asarray(jr.state))
    assert c.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    for f in COUNTERS:
        assert int(getattr(r.counters, f)) == int(getattr(jr.counters, f)), f


def _run_both(jg, tg, spec, vector_rounds=1, **kw):
    ref = j_match(jg, backend="xla", with_conflicts=True,
                  vector_rounds=vector_rounds, spec=getattr(JSpec, spec)(),
                  **kw)
    port = skipper_match(tg, device="cpu", with_conflicts=True,
                         vector_rounds=vector_rounds,
                         spec=getattr(StateSpec, spec)(), **kw)
    assert_results_equal(port, ref)
    return port


@pytest.mark.parametrize("reorder", ["none", "degree"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("graph", ["rmat10", "grid", "star", "path", "er"])
def test_skipper_match_equal(graph, spec, reorder):
    jg, tg = _graph(graph)
    (r, _) = _run_both(jg, tg, spec, window=128, tile_size=64,
                       reorder=reorder, vector_rounds=1 + (graph == "er"))
    assert_matching(tg, r.match_mask, graph)


def _pinned(n):
    rng = np.random.default_rng(n)
    u = rng.integers(0, n, 4 * n)
    v = rng.integers(0, n, 4 * n)
    return _pair(np.minimum(u, v), np.maximum(u, v), n)


def _all_boundary():
    rng = np.random.default_rng(3)
    return _pair(rng.integers(0, 128, 1500), rng.integers(128, 640, 1500),
                 640)


def _same_block():
    rng = np.random.default_rng(4)
    u = np.concatenate([rng.integers(0, 128, 600), rng.integers(256, 384, 5)])
    v = np.concatenate([rng.integers(0, 128, 600), rng.integers(256, 384, 5)])
    return _pair(np.minimum(u, v), np.maximum(u, v), 384)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", [
    ("pinned701", lambda: _pinned(701), 128, 64),
    ("pinned700", lambda: _pinned(700), 256, 64),
    ("pinned901", lambda: _pinned(901), 128, 32),
    ("all_boundary", _all_boundary, 128, 64),
    ("same_block", _same_block, 128, 64),
    ("empty_global", lambda: _from_ref(jgen.erdos_renyi_graph(120, 400,
                                                              seed=5)),
     128, 64),
], ids=lambda c: c[0])
def test_skipper_match_pinned_shapes(case, spec):
    label, make, window, tile = case
    jg, tg = make()
    s = j_build(jg, window, tile)
    if label == "all_boundary":
        assert s.num_intra == 0
    if label == "same_block":
        assert (s.boundary_blk_u == s.boundary_blk_v).any()
    if label == "empty_global":
        assert s.num_boundary_tiles == 0
    else:
        assert s.num_boundary_tiles > 0
    (r, _) = _run_both(jg, tg, spec, window=window, tile_size=tile,
                       vector_rounds=2)
    assert_matching(tg, r.match_mask, label)


@pytest.mark.parametrize("spec", SPECS)
def test_skipper_match_empty_and_selfloops(spec):
    jg, tg = _pair([3, 5, -1], [3, 5, -1], 10)
    (r, c) = _run_both(jg, tg, spec, window=16, tile_size=64)
    assert int(r.match_mask.sum()) == 0
    jg, tg = _pair(np.zeros(0), np.zeros(0), 10)
    _run_both(jg, tg, spec, window=16, tile_size=64)


@pytest.mark.parametrize("spec", SPECS)
def test_skipper_match_on_reference_schedule(spec):
    """The reference's own schedule, carried across, gives the reference's
    result."""
    jg, tg = _graph("rmat10")
    s = j_build(jg, 128, 64, reorder="greedy")
    ref = j_match(jg, schedule=s, backend="xla", with_conflicts=True,
                  spec=getattr(JSpec, spec)())
    port = skipper_match(
        tg, schedule=schedule_from_arrays(dataclasses.asdict(s)),
        device="cpu", with_conflicts=True,
        spec=spec_from_names(**dataclasses.asdict(getattr(JSpec, spec)())))
    assert_results_equal(port, ref)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_skipper_match_window_equal(spec, fallback, vector_rounds):
    rng = np.random.default_rng(vector_rounds)
    m, window = 200, 64
    u = rng.integers(0, window, m)
    v = rng.integers(0, window, m)
    v[::9] = u[::9]
    u[::17] = v[::17] = -1
    st0 = np.where(rng.random(window) < 0.15, 2, 0).astype(np.int32)
    ref = j_window(jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32),
                   jnp.asarray(st0), tile_size=64,
                   vector_rounds=vector_rounds, fallback=fallback,
                   interpret=True, spec=getattr(JSpec, spec)())
    port = skipper_match_window(
        torch.from_numpy(u.astype(np.int32)),
        torch.from_numpy(v.astype(np.int32)), torch.from_numpy(st0),
        tile_size=64, vector_rounds=vector_rounds, fallback=fallback,
        spec=getattr(StateSpec, spec)(), device="cpu")
    for a, b in zip(port, ref):
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_verify_true_passes_and_returns_same():
    _, tg = _graph("er")
    r1 = skipper_match(tg, window=128, tile_size=64, device="cpu",
                       verify=True)
    r2 = skipper_match(tg, window=128, tile_size=64, device="cpu")
    torch.testing.assert_close(r1.match_mask, r2.match_mask, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs the original edge list"):
        skipper_match(schedule=ops.build_window_schedule(tg, 128, 64),
                      device="cpu", verify=True)


def test_verify_raises_on_a_bad_result():
    _, tg = _graph("path")
    good = skipper_match(tg, window=128, tile_size=64, device="cpu")
    unmatched = MatchResult(torch.zeros_like(good.match_mask), good.state,
                            good.counters)
    with pytest.raises(RuntimeError, match="maximal=False.*first offending "
                       r"edge \(0, 1\) at stream index 0"):
        ops._verify(tg, unmatched)
    dirty = MatchResult(good.match_mask, torch.full_like(good.state, 1),
                        good.counters)
    with pytest.raises(RuntimeError, match="rsvd_leaked=400"):
        ops._verify(tg, dirty)


def test_faults_not_ported():
    _, tg = _graph("star")
    for kw in ({"faults": object()}, {"on_fault": "recover"},
               {"on_fault": "report"}):
        with pytest.raises(NotImplementedError, match="queue 1, item 9"):
            skipper_match(tg, device="cpu", **kw)
    with pytest.raises(ValueError, match="on_fault"):
        skipper_match(tg, device="cpu", on_fault="ignore")


def test_counters_and_result_types():
    z = Counters.zeros()
    assert int(z.total_accesses) == 0 and z.edge_reads.dtype == torch.int32
    _, tg = _graph("grid")
    r = skipper_match(tg, window=128, tile_size=64, device="cpu")
    assert int(r.num_matches) == int(r.match_mask.sum())
    assert int(r.counters.total_accesses) == int(
        r.counters.edge_reads + r.counters.state_loads
        + r.counters.state_stores)


# ------------------------------------------------ the global tier's instance --
@pytest.mark.parametrize("window,tile,spec,instance", [
    (65536, 256, "u8", "staged"),          # the full-scale cell: 128 KB rows
    (65536, 256, "legacy_i32", "device"),  # 512 KB of rows do not fit
    (256, 256, "legacy_i32", "staged"),
    (95056, 256, "u8", "staged"),          # the largest u8 window at tile 256
    (95072, 256, "u8", "device"),
    (8192, 1024, "legacy_i32", "staged"),
    (16384, 1024, "legacy_i32", "device"),  # the largest ring beside the rows
    (100, 32, "u8", "device"),             # 100 B rows: no whole 16-B units
    (100, 32, "legacy_i32", "staged"),
])
def test_global_tier_instance_by_shape(window, tile, spec, instance):
    """The asynchronous global tier keeps the pair's two state rows in
    shared memory when they fit beside the ring and a row is a whole number
    of 16-byte bulk-copy units; otherwise its state stays in device memory.
    The choice depends on the window, the tile and the state width, never
    on the number of vertices."""
    from repro_torch.kernels.skipper_match import kernel

    sp = getattr(StateSpec, spec)()
    assert kernel.boundary_instance(window, tile, sp) == instance
    staged = (kernel.boundary_async_smem_bytes(window, tile, sp, True)
              + kernel.ASYNC_STATIC_SMEM)
    assert (staged <= kernel.MAX_SMEM_BYTES) == (
        instance == "staged" or window * sp.vmem_bytes % 16 != 0)


def test_global_tier_shared_memory_layout():
    """Dynamic: two state rows (staged only) and four ring stages of four
    tiles' pairs and u and v ids. Static: nine mbarriers, and the free
    flags and the free list (32 warp counts, the free lanes' u and v ids)
    for the largest tile."""
    from repro_torch.kernels.skipper_match import kernel

    u8 = StateSpec.u8()
    ring = 4 * (4 * 8 + 4 * 8 * 256)
    assert kernel.boundary_async_smem_bytes(65536, 256, u8, True) == (
        2 * 65536 + ring)
    assert kernel.boundary_async_smem_bytes(65536, 256, u8, False) == ring
    assert kernel.boundary_async_smem_bytes(
        64, 33, u8, False) == 4 * (32 + 32 * 33)
    assert kernel.ASYNC_STATIC_SMEM == 72 + 1024 + 4 * (32 + 2048)


def test_global_tier_wrapper_on_the_cpu_runs_the_plain_version():
    """On CPU tensors ``boundary_tier`` runs ``ref_boundary_pass`` whatever
    instance is named; an unknown instance raises."""
    from repro_torch.kernels.skipper_match import kernel, ref

    sch = ops.build_window_schedule(_all_boundary()[1], 128, 64)
    nb = sch.num_boundary_tiles
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    args = (put(sch.boundary_blk_u), put(sch.boundary_blk_v),
            put(sch.boundary_ulocal).reshape(nb, 64),
            put(sch.boundary_vlocal).reshape(nb, 64))
    rows = torch.zeros((sch.num_windows, 128), dtype=torch.uint8)
    want_rows = rows.clone()
    want = ref.ref_boundary_pass(want_rows, *args)
    for instance in (None, "staged", "device"):
        got_rows = rows.clone()
        got = kernel.boundary_tier(got_rows, *args, instance=instance)
        assert torch.equal(got_rows, want_rows)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="instance"):
        kernel.boundary_tier(rows.clone(), *args, instance="shared")
