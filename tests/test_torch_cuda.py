"""The CUDA kernels against their plain PyTorch versions on the card: the
matcher's bit for bit, flash attention within the stated tolerances; and
the serving path on the card. Marked ``cuda``: each test skips without a
card. This file imports no jax, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import assert_matching, sgmm
from repro_torch.core.statespec import StateSpec
from repro_torch.graphs import build_window_schedule, rmat_graph, star_graph
from repro_torch.kernels.skipper_match import (
    kernel,
    ref,
    skipper_match,
    skipper_match_window,
)

SPECS = ["u8", "legacy_i32"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(*pairs):
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_skipper_match_kernels_equal_plain(cuda_device, spec, vector_rounds):
    g = rmat_graph(11, 8, seed=4)
    kw = dict(window=256, tile_size=64, reorder="degree",
              vector_rounds=vector_rounds, spec=getattr(StateSpec, spec)(),
              with_conflicts=True, device=cuda_device)
    kernel.reset_launch_counts()
    rk, ck = skipper_match(g, backend="cuda", verify=True, **kw)
    assert kernel.launch_counts() == {kernel.WINDOW_ASYNC: 1,
                                      kernel.WINDOW_TIER: 0,
                                      kernel.BOUNDARY_ASYNC: 1,
                                      kernel.BOUNDARY: 0}
    rp, cp = skipper_match(g, backend="torch", **kw)
    _same((rk.match_mask, rp.match_mask), (rk.state, rp.state), (ck, cp))
    assert_matching(g, rk.match_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_skipper_match_counts_its_copies_and_fallback(cuda_device,
                                                      vector_rounds):
    """``h2d_bytes`` is what a call moves to the card: the schedule arrays
    it puts there and the three int32 scalars of its counters; under a
    profiler the tiers' fallback counters equal the edges blocked in every
    vector round of the kernels' per-edge conflicts, and each tier's id
    check is one span."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    g = rmat_graph(11, 8, seed=4)
    s = build_window_schedule(g, 256, 256, reorder="degree")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, conf = skipper_match(g, schedule=s, vector_rounds=vector_rounds,
                                with_conflicts=True, device=cuda_device)
    got = tracing.counters()
    put = (s.u_tiles, s.v_tiles, s.window_ids, s.boundary_ulocal,
           s.boundary_vlocal, s.boundary_blk_u, s.boundary_blk_v,
           s.stream_src, s.perm)
    assert got["h2d_bytes"] == sum(a.nbytes for a in put) + 3 * 4
    assert got["h2d_staged_bytes"] == sum(a.nbytes for a in put)
    conf = conf.cpu().numpy()
    for tier, idx in (("window_tier", s.edge_index),
                      ("global_tier", s.boundary_index)):
        want = int((conf[idx[idx >= 0]] == vector_rounds).sum())
        assert got[f"skipper_match.{tier}.fallback_edges"] == want, tier
    assert tracing.spans()["kernels.id_check"]["count"] == 2
    tracing.reset()


#: the schedule arrays ``skipper_match`` puts on the card, each its own
#: pinned block
PUT = ("u_tiles", "v_tiles", "window_ids", "boundary_ulocal",
       "boundary_vlocal", "boundary_blk_u", "boundary_blk_v", "stream_src",
       "perm")


def _plain(g, s):
    res, conf = skipper_match(g, schedule=s, backend="torch",
                              with_conflicts=True, device="cpu")
    return res.match_mask, res.state, conf


@pytest.mark.cuda
def test_staged_calls_in_flight_equal_plain(cuda_device):
    """Three calls on two schedules, queued with no wait between them, so
    that each call's pinned blocks come back while the last call's copies
    and tiers may still run: each equals the plain version bit for bit, and
    every schedule byte went through the staging."""
    from repro_torch import tracing

    graphs = [rmat_graph(11, 8, seed=4), rmat_graph(11, 8, seed=5)]
    scheds = [build_window_schedule(g, 256, 64, reorder="degree")
              for g in graphs]
    want = [_plain(g, s) for g, s in zip(graphs, scheds)]
    torch.cuda.synchronize(cuda_device)
    tracing.reset()
    got = []
    for i in (0, 1, 0):
        res, conf = skipper_match(graphs[i], schedule=scheds[i],
                                  with_conflicts=True, device=cuda_device)
        got.append((i, (res.match_mask, res.state, conf)))
    torch.cuda.synchronize(cuda_device)
    for i, outs in got:
        _same(*((a.cpu(), b) for a, b in zip(outs, want[i])))
    staged = sum(getattr(scheds[i], k).nbytes for i, _ in got for k in PUT)
    counts = tracing.counters()
    assert counts["h2d_staged_bytes"] == staged
    assert counts["h2d_bytes"] == staged + 3 * 3 * 4
    tracing.reset()


@pytest.mark.cuda
def test_skipper_match_is_done_with_the_schedule_at_return(cuda_device):
    """Garbage written into every schedule array as soon as the call
    returns, before the card is waited for, changes nothing: the program
    read the caller's memory before it returned."""
    g = rmat_graph(11, 8, seed=4)
    s = build_window_schedule(g, 256, 64, reorder="degree")
    want = _plain(g, s)
    torch.cuda.synchronize(cuda_device)
    res, conf = skipper_match(g, schedule=s, with_conflicts=True,
                              device=cuda_device)
    rng = np.random.default_rng(0)
    for k in PUT:
        a = getattr(s, k)
        a[...] = rng.integers(-2**31, 2**31, a.shape, dtype=np.int32)
    torch.cuda.synchronize(cuda_device)
    _same(*((a.cpu(), b) for a, b in
            zip((res.match_mask, res.state, conf), want)))


@pytest.mark.cuda
def test_staging_waits_for_no_kernel(cuda_device):
    """A staged array's host copy and DMA go on while the current stream
    still runs a kernel queued before: the host returns and the copy lands
    before that kernel ends, and the stream reads the array after it."""
    from repro_torch.kernels.skipper_match import ops

    a = np.arange(1 << 20, dtype=np.int32)
    ops._stage(torch.from_numpy(a), cuda_device)  # the pinned block, once
    torch.cuda.synchronize(cuda_device)
    torch.cuda._sleep(1_000_000_000)  # about half a second of the stream
    busy = torch.cuda.Event()
    busy.record()
    t = ops._stage(torch.from_numpy(a), cuda_device)
    landed = torch.cuda.Event()
    landed.record(ops._copy_stream(cuda_device))
    assert not busy.query()
    landed.synchronize()
    assert not busy.query()
    a[:] = -1
    assert torch.equal(t.cpu(), torch.arange(1 << 20, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_tier_kernels_equal_plain(cuda_device, spec):
    sp = getattr(StateSpec, spec)()
    s = build_window_schedule(star_graph(2000), 256, 64)
    put = lambda a: torch.from_numpy(a.astype(np.int32)).to(cuda_device)  # noqa: E731
    u2, v2 = put(s.u_tiles), put(s.v_tiles)
    st0 = torch.zeros((s.num_rows, s.window), dtype=sp.vmem_dtype,
                      device=cuda_device)
    got = kernel.window_tier(u2, v2, st0, tile_size=64, spec=sp)
    want = ref.ref_window_tier(u2, v2, st0, tile_size=64, spec=sp)
    _same(*zip(got, want))
    nb = s.num_boundary_tiles
    rows_k = torch.zeros((s.num_windows, s.window), dtype=sp.vmem_dtype,
                         device=cuda_device)
    rows_k[put(s.window_ids).long()] = got[0]
    rows_p = rows_k.clone()
    args = (put(s.boundary_blk_u), put(s.boundary_blk_v),
            put(s.boundary_ulocal).reshape(nb, 64),
            put(s.boundary_vlocal).reshape(nb, 64))
    got = kernel.boundary_tier(rows_k, *args, spec=sp)
    want = ref.ref_boundary_pass(rows_p, *args, spec=sp)
    _same((rows_k, rows_p), *zip(got, want))


@pytest.mark.cuda
def test_match_window_kernel_equal_plain(cuda_device):
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.integers(0, 100, 500).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, 100, 500).astype(np.int32))
    st0 = torch.from_numpy(np.where(rng.random(100) < 0.1, 2, 0)
                           .astype(np.uint8))
    got = skipper_match_window(u.cuda(), v.cuda(), st0.cuda(), 128,
                               backend="cuda")
    want = skipper_match_window(u, v, st0, 128, device="cpu")
    _same(*((a.cpu(), b) for a, b in zip(got, want)))
    # a whole stream in one window from all-ACC is the sequential greedy
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    from repro_torch.interop import edges_from_arrays
    oracle = sgmm(edges_from_arrays(lo.numpy(), hi.numpy(), 100))
    _, m, _ = skipper_match_window(lo.cuda(), hi.cuda(),
                                   torch.zeros(100, dtype=torch.uint8,
                                               device=cuda_device), 128)
    _same((m.cpu().bool(), oracle.match_mask))


@pytest.mark.cuda
def test_window_tier_rejects_oversized_state(cuda_device):
    u = torch.full((1, 256), -1, dtype=torch.int32, device=cuda_device)
    st0 = torch.zeros((1, 65536), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.window_tier(u, u, st0, tile_size=256,
                           spec=StateSpec.legacy_i32())


@pytest.mark.cuda
def test_kernels_reject_out_of_range_ids(cuda_device):
    u = torch.full((1, 64), -1, dtype=torch.int32, device=cuda_device)
    u[0, 0] = 40
    st0 = torch.zeros((1, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="out of range"):
        kernel.window_tier(u, u + 1, st0, tile_size=64)


# ----------------------------------------------- the asynchronous window tier --
#: (state, counter) widths of the kernels' four instances
WIDTHS = [(s, c) for s in ("uint8", "int32") for c in ("uint8", "int32")]
WINDOW = 256


def _window_case(case, tile, seed):
    """Numpy-seeded window-tier inputs ``(u, v, state)`` of one case, at
    window 256 (every row a whole number of 16-byte units), with G tiles a
    ring stage:

    * ``rows``: three rows of 2G + 5 tiles (two whole stages and a partial
      one), a quarter padding, self-loops, a caller state with MCHD cells;
    * ``short_row``: one row of 5 tiles, fewer than a stage and than the
      ring's stages;
    * ``dead_row``: two rows of G + 1 tiles against a state all MCHD;
    * ``star``: every slot on vertex 0, two rows of G + 4 tiles;
    * ``late_free``: one row of 2G tiles (two whole stages) whose slots are
      all dead but the last lane of tile G - 1 and of tile 2G - 1, the last
      tiles of the two stages.
    """
    g = kernel.WINDOW_STAGE_TILES
    rng = np.random.default_rng(seed)
    rows, tiles = {"rows": (3, 2 * g + 5), "short_row": (1, 5),
                   "dead_row": (2, g + 1), "star": (2, g + 4),
                   "late_free": (1, 2 * g)}[case]
    shape = (rows, tiles * tile)
    u = rng.integers(0, WINDOW, shape)
    v = rng.integers(0, WINDOW, shape)
    state = np.where(rng.random((rows, WINDOW)) < 0.1, 2, 0)
    if case == "rows":
        v = np.where(rng.random(shape) < 0.05, u, v)
        pad = rng.random(shape) < 0.25
        u, v = np.where(pad, -1, u), np.where(pad, -1, v)
    elif case == "dead_row":
        state[:] = 2
    elif case == "star":
        u[:] = 0
        state[:] = 0
    elif case == "late_free":
        state[:] = 2
        state[:, 1:5] = 0
        u, v = u % (WINDOW - 5) + 5, v % (WINDOW - 5) + 5
        u[0, g * tile - 1], v[0, g * tile - 1] = 1, 2
        u[0, 2 * g * tile - 1], v[0, 2 * g * tile - 1] = 3, 4
    return u.astype(np.int32), v.astype(np.int32), state


def _run_window_tiers(case, tile, widths, vector_rounds, fallback, device):
    sp = StateSpec(vmem=widths[0], wire=widths[0], counter=widths[1])
    u, v, state = (torch.from_numpy(a).to(device) for a in
                   _window_case(case, tile, tile + len(case)))
    st0 = state.to(sp.vmem_dtype)
    kw = dict(tile_size=tile, vector_rounds=vector_rounds, fallback=fallback,
              spec=sp)
    assert kernel.window_instance(WINDOW, tile, sp) == "async"
    kernel.reset_launch_counts()
    got = kernel.window_tier(u, v, st0, **kw)
    first = kernel.window_tier_sync(u, v, st0, **kw)
    want = ref.ref_window_tier(u, v, st0, **kw)
    torch.cuda.synchronize()
    _same(*zip(got, want), *zip(first, want))
    assert kernel.launch_counts()[kernel.WINDOW_ASYNC] == 1
    assert kernel.launch_counts()[kernel.WINDOW_TIER] == 1
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("tile", [33, 64, 65, 98, 164, 256, 1024])
@pytest.mark.parametrize("case", ["rows", "short_row", "dead_row", "star",
                                  "late_free"])
def test_async_window_tier_equals_plain_and_first_kernel(
        cuda_device, widths, tile, case):
    """skipper_window_async_kernel bit for bit against ref_window_tier and
    skipper_window_tier_kernel: states, matched and conflicts, in each of
    the four (state, counter) widths. Tile 33 puts every row but the first
    off a 16-byte boundary (its ids come by cp.async); tiles 65, 98 and
    164 end in a warp of fewer lanes than the warps before it; at tile
    1024 the kernel runs 1,024 threads, the most it takes."""
    want = _run_window_tiers(case, tile, widths, 1, True, cuda_device)
    if case == "late_free":   # the skip kept both lone free slots
        g = kernel.WINDOW_STAGE_TILES
        assert int(want[1][0, g * tile - 1]) == 1
        assert int(want[1][0, 2 * g * tile - 1]) == 1
        assert int(want[1].to(torch.int64).sum()) == 2
    if case == "dead_row":
        assert int(want[1].to(torch.int64).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [WIDTHS[0], WIDTHS[3]])
@pytest.mark.parametrize("rounds", [(2, True), (1, False), (2, False)])
@pytest.mark.parametrize("case", ["rows", "star", "late_free"])
def test_async_window_tier_rounds_and_fallback(cuda_device, widths, rounds,
                                               case):
    """The same with two vector rounds and with the fallback off."""
    _run_window_tiers(case, 64, widths, *rounds, cuda_device)


@pytest.mark.cuda
def test_window_tier_profile_leaves_the_result(cuda_device):
    """The optional cycle profile fills its counters (stages timed, dead
    stages, walked and free tiles counted, added over the rows) and changes
    no output."""
    sp = StateSpec.u8()
    u, v, state = (torch.from_numpy(a).to(cuda_device)
                   for a in _window_case("rows", 64, 1))
    st0 = state.to(torch.uint8)
    prof = torch.full((len(kernel.WINDOW_PROFILE_FIELDS),), 7,
                      dtype=torch.int64, device=cuda_device)
    got = kernel.window_tier(u, v, st0, tile_size=64, spec=sp, profile=prof)
    want = kernel.window_tier(u, v, st0, tile_size=64, spec=sp)
    torch.cuda.synchronize()
    _same(*zip(got, want))
    cyc = dict(zip(kernel.WINDOW_PROFILE_FIELDS, prof.tolist()))
    assert cyc["total"] > 0 and cyc["stage_wait"] > 0
    assert 0 < cyc["free_tiles"] <= cyc["walked_tiles"] <= u.numel() // 64
    assert cyc["refill"] <= cyc["counters_release_refill"]
    assert cyc["tile_body"] >= cyc["tile_body_in_free_tiles"] > 0
    assert cyc["total"] == sum(cyc[f] for f in (
        "stage_wait", "dead_test", "tile_mask", "tile_body",
        "counters_release_refill"))
    # the dead row passes every stage with one barrier
    u, v, state = (torch.from_numpy(a).to(cuda_device)
                   for a in _window_case("dead_row", 64, 1))
    kernel.window_tier(u, v, state.to(torch.uint8), tile_size=64, spec=sp,
                       profile=prof)
    cyc = dict(zip(kernel.WINDOW_PROFILE_FIELDS, prof.tolist()))
    assert cyc["dead_stages"] == 2 * 2 and cyc["walked_tiles"] == 0


@pytest.mark.cuda
def test_window_instance_follows_the_shape(cuda_device):
    """At the edge of the int32 ring (window 47,532, one stage) the new
    kernel launches; one 16-byte row further, and for a row that is not
    whole 16-byte units, the first kernel does; profile= there raises."""
    i32 = StateSpec.legacy_i32()
    for window, spec, name in ((47_532, i32, kernel.WINDOW_ASYNC),
                               (47_536, i32, kernel.WINDOW_TIER),
                               (100, StateSpec.u8(), kernel.WINDOW_TIER),
                               (65_536, StateSpec.u8(), kernel.WINDOW_ASYNC)):
        rng = np.random.default_rng(window)
        u = torch.from_numpy(rng.integers(0, window, (1, 512))
                             .astype(np.int32)).to(cuda_device)
        v = torch.from_numpy(rng.integers(0, window, (1, 512))
                             .astype(np.int32)).to(cuda_device)
        st0 = torch.zeros((1, window), dtype=spec.vmem_dtype,
                          device=cuda_device)
        kernel.reset_launch_counts()
        got = kernel.window_tier(u, v, st0, tile_size=256, spec=spec)
        want = ref.ref_window_tier(u, v, st0, tile_size=256, spec=spec)
        torch.cuda.synchronize()
        _same(*zip(got, want))
        assert kernel.launch_counts()[name] == 1, (window, name)
    prof = torch.zeros(len(kernel.WINDOW_PROFILE_FIELDS), dtype=torch.int64,
                       device=cuda_device)
    ids = torch.full((1, 256), -1, dtype=torch.int32, device=cuda_device)
    st0 = torch.zeros((1, 47_536), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="first window tier"):
        kernel.window_tier(ids, ids, st0, tile_size=256, spec=i32,
                           profile=prof)


@pytest.mark.cuda
def test_match_window_defaults_to_the_card(cuda_device):
    """``skipper_match_window`` given CPU tensors and no device runs the
    new kernel on the card and returns CUDA tensors."""
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.integers(0, 128, 700).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, 128, 700).astype(np.int32))
    st0 = torch.zeros(128, dtype=torch.uint8)
    kernel.reset_launch_counts()
    got = skipper_match_window(u, v, st0, 64)
    assert kernel.launch_counts()[kernel.WINDOW_ASYNC] == 1
    assert all(t.device.type == "cuda" for t in got)
    want = skipper_match_window(u, v, st0, 64, device="cpu")
    _same(*((a.cpu(), b) for a, b in zip(got, want)))


# ----------------------------------------------- the asynchronous global tier --
def _pairs_input(pairs, tile, window, seed):
    """Global-tier tiles of the given (blk_u, blk_v) pairs: numpy-seeded
    offset-local ids (v past W on a cross-block pair), a quarter padding,
    and every tile's slot 0 on vertex 5 of its u row, so consecutive tiles
    of one pair compete."""
    rng = np.random.default_rng(seed)
    bu = np.array([p[0] for p in pairs], np.int32)
    bv = np.array([p[1] for p in pairs], np.int32)
    u = rng.integers(0, window, (len(pairs), tile))
    v = rng.integers(0, window, (len(pairs), tile)) + np.where(
        (bu != bv)[:, None], window, 0)
    u[:, 0] = 5
    pad = rng.random(u.shape) < 0.25
    pad[:, 0] = False
    return (bu, bv, np.where(pad, -1, u).astype(np.int32),
            np.where(pad, -1, v).astype(np.int32))


#: pair sequences: below, at and above the ring's depth (8 tiles), with a
#: same-block pair, single-tile pairs, a change of blk_u onto the previous
#: v row, and a v row met again after another
GLOBAL_TIER_CASES = {
    "below_ring": [(0, 1), (0, 1), (1, 1)],
    "at_ring": [(0, 0), (0, 1), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2),
                (2, 3)],
    "above_ring": [(0, 0), (0, 1), (0, 1), (0, 1), (0, 3), (1, 1), (1, 2),
                   (1, 2), (1, 3), (2, 2), (2, 3), (2, 3), (3, 3), (0, 2),
                   (0, 1), (3, 3), (1, 3), (1, 3), (2, 3), (0, 0)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("instance", ["staged", "device"])
@pytest.mark.parametrize("tile", [64, 33, 65, 98, 164])
@pytest.mark.parametrize("case", sorted(GLOBAL_TIER_CASES))
def test_async_global_tier_equals_plain_and_first_kernel(
        cuda_device, spec, instance, tile, case):
    """skipper_boundary_async_kernel, in both instances, bit for bit
    against ref_boundary_pass and skipper_boundary_kernel: matched,
    conflicts and the state rows. Tile 33 makes the ring's bulk copies
    start off a 16-byte boundary (ragged ends by cp.async); tiles 65, 98
    and 164 end in a warp of fewer lanes than the warps before it."""
    sp = getattr(StateSpec, spec)()
    pairs = GLOBAL_TIER_CASES[case]
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in
                 _pairs_input(pairs, tile, 256, len(pairs) + tile))
    rng = np.random.default_rng(tile)
    state = torch.from_numpy(np.where(rng.random((4, 256)) < 0.1, 2, 0)
                             .astype(np.dtype(sp.vmem))).to(cuda_device)
    rows_a, rows_s, rows_p = state.clone(), state.clone(), state.clone()
    kernel.reset_launch_counts()
    got = kernel.boundary_tier(rows_a, *args, spec=sp, instance=instance)
    first = kernel.boundary_tier_sync(rows_s, *args, spec=sp)
    want = ref.ref_boundary_pass(rows_p, *args, spec=sp)
    torch.cuda.synchronize()
    _same((rows_a, rows_p), (rows_s, rows_p), *zip(got, want),
          *zip(first, want))
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("instance", ["staged", "device", None])
def test_async_global_tier_launches_the_largest_tile(cuda_device, spec,
                                                     instance):
    """The asynchronous global tier launches at its largest tile,
    ``BOUNDARY_ASYNC_MAX_THREADS`` lanes, in both instances (the block its
    registers fit, which the analyzer's ``registers`` rule holds); a tile
    of 1,024 lanes (``instance`` None) takes the first global tier. Each
    bit for bit against the plain version."""
    sp = getattr(StateSpec, spec)()
    tile = (kernel.MAX_THREADS if instance is None
            else kernel.BOUNDARY_ASYNC_MAX_THREADS)
    pairs = GLOBAL_TIER_CASES["at_ring"]
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in
                 _pairs_input(pairs, tile, 2048, 7))
    state = torch.zeros((4, 2048), dtype=sp.vmem_dtype, device=cuda_device)
    rows_a, rows_p = state.clone(), state.clone()
    kernel.reset_launch_counts()
    got = kernel.boundary_tier(rows_a, *args, spec=sp, instance=instance)
    want = ref.ref_boundary_pass(rows_p, *args, spec=sp)
    torch.cuda.synchronize()
    _same((rows_a, rows_p), *zip(got, want))
    first = instance is None
    assert kernel.launch_counts()[kernel.BOUNDARY] == int(first)
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == int(not first)
    if first:
        with pytest.raises(ValueError, match="at most 896 lanes"):
            kernel.boundary_tier(rows_a, *args, spec=sp, instance="device")


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["staged", "device"])
def test_global_tier_profile_leaves_the_result(cuda_device, instance):
    """The optional cycle profile fills its counters (every tile timed,
    free tiles and their rounds counted) and changes no output."""
    sp = StateSpec.u8()
    pairs = GLOBAL_TIER_CASES["above_ring"]
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in
                 _pairs_input(pairs, 64, 256, 3))
    state = torch.zeros((4, 256), dtype=torch.uint8, device=cuda_device)
    rows_a, rows_p = state.clone(), state.clone()
    prof = torch.zeros(len(kernel.PROFILE_FIELDS), dtype=torch.int64,
                       device=cuda_device)
    got = kernel.boundary_tier(rows_a, *args, spec=sp, instance=instance,
                               profile=prof)
    want = ref.ref_boundary_pass(rows_p, *args, spec=sp)
    torch.cuda.synchronize()
    _same((rows_a, rows_p), *zip(got, want))
    cyc = dict(zip(kernel.PROFILE_FIELDS, prof.tolist()))
    assert cyc["total"] > 0 and 0 < cyc["free_tiles"] <= len(pairs)
    assert cyc["free_rounds"] >= cyc["free_tiles"]
    assert cyc["tile_body"] >= cyc["tile_body_in_free_tiles"]
    # the read-ahead's counts: the device instance's equal its twin's (a
    # racing read may see a commit and so not be stale); the staged
    # instance reads nothing ahead, and with the fallback runs round 1 in
    # every tile with a free lane
    twin = ref.ref_boundary_pass_prefetched(state.clone(), *args, spec=sp)[2]
    if instance == "device":
        assert cyc["stale_lanes"] <= twin["stale_lanes"]
        for f in ("later_round_tiles", "free_tiles", "free_rounds"):
            assert cyc[f] == twin[f], f
    else:  # the device instance's own counts
        assert cyc["stale_lanes"] == cyc["later_round_tiles"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["window", "staged", "device"])
@pytest.mark.parametrize("tile", [65, 98, 164, 260, 516])
def test_free_list_rank_in_a_partial_last_warp(cuda_device, tier, tile):
    """Tiles whose last warp has fewer lanes than there are warps before
    it. In each, the last lane's edge shares a vertex with a free lane of
    the warp before, and every other slot is padding: the free list has to
    rank the last lane after that lane (the counts of every earlier warp
    added), so that it is blocked, then dead. Each kernel that ranks free
    lanes (the window tier, both global-tier instances) bit for bit against
    its plain version."""
    tiles = 3
    u = np.full((tiles, tile), -1, np.int32)
    v = np.full((tiles, tile), -1, np.int32)
    other = 32 * ((tile - 1) // 32 - 1) + 1  # a lane of the warp before
    for k in range(tiles):
        u[k, other], v[k, other] = 10 + 10 * k, 11 + 10 * k
        u[k, -1], v[k, -1] = 10 + 10 * k, 12 + 10 * k
    state = torch.zeros((1, WINDOW), dtype=torch.uint8, device=cuda_device)
    if tier == "window":
        assert kernel.window_instance(WINDOW, tile) == "async"
        ut, vt = (torch.from_numpy(a.reshape(1, -1)).to(cuda_device)
                  for a in (u, v))
        got = kernel.window_tier(ut, vt, state, tile_size=tile)
        want = ref.ref_window_tier(ut, vt, state, tile_size=tile)
        torch.cuda.synchronize()
        _same(*zip(got, want))
        matched = want[1].view(tiles, tile)
    else:
        pairs = torch.zeros(tiles, dtype=torch.int32, device=cuda_device)
        args = (pairs, pairs, *(torch.from_numpy(a).to(cuda_device)
                                for a in (u, v)))
        rows_a, rows_p = state.clone(), state.clone()
        got = kernel.boundary_tier(rows_a, *args, instance=tier)
        want = ref.ref_boundary_pass(rows_p, *args)
        torch.cuda.synchronize()
        _same((rows_a, rows_p), *zip(got, want))
        matched = want[0]
    assert matched[:, other].tolist() == [1] * tiles
    assert matched[:, -1].tolist() == [0] * tiles


def _prefetch_case(case, tile, seed):
    """Global-tier inputs ``(pairs, u, v, state rows)`` at window 4096 that
    force each branch of the device-memory instance's read-ahead:

    * ``stale``: one row; slot 0 of every tile a fresh edge, slot 1 an edge
      on the vertex that tile's slot 0 took one tile before (its read
      ahead, taken before that commit, sees ACC/ACC: a stale lane);
    * ``chains``: one row; each tile a path of up to 12 lanes on fresh
      vertices, which its rounds take two lanes at a time (6 rounds and
      more);
    * ``cross_block``: the same offset-local ids in consecutive tiles of
      other block pairs, so the cells differ: what one tile commits must
      not overturn the next tile's reading;
    * ``partial_group``: 4k + 3 tiles (a last ring group of 3), random
      ids, a quarter padding.

    The rest of each tile is random ids on a few hundred vertices, some
    padding, a state with some MCHD cells."""
    w = 4096
    rng = np.random.default_rng(seed)
    tiles = {"stale": 9, "chains": 6, "cross_block": 8,
             "partial_group": 11}[case]
    pairs = {"cross_block": [(0, 1), (2, 3), (0, 1), (1, 2), (2, 2),
                             (3, 3), (0, 3), (1, 2)]}.get(
        case, [(0, 0)] * tiles)
    cross = np.array([a != b for a, b in pairs])[:, None]
    u = rng.integers(0, 300, (tiles, tile))
    v = rng.integers(0, 300, (tiles, tile)) + np.where(cross, w, 0)
    pad = rng.random(u.shape) < (0.25 if case == "partial_group" else 0.1)
    fresh = iter(range(1000, w))
    for k in range(tiles):
        if case == "stale":
            u[k, 0], v[k, 0] = next(fresh), next(fresh)
            if k and tile > 1:
                u[k, 1], v[k, 1] = u[k - 1, 0], next(fresh)
        elif case == "chains":
            path = [next(fresh) for _ in range(min(tile, 12) + 1)]
            for j in range(len(path) - 1):
                u[k, j], v[k, j] = path[j], path[j + 1]
        elif case == "cross_block":
            u[k, :2] = 5, 6
            v[k, :2] = np.array([8, 7]) + (w if cross[k, 0] else 0)
    if case != "partial_group":
        pad[:, :12] = False
    state = np.where(rng.random((4, w)) < 0.05, 2, 0)
    state[:, 1000:] = 0
    state[:, 5:9] = 0
    return (pairs, np.where(pad, -1, u).astype(np.int32),
            np.where(pad, -1, v).astype(np.int32), state)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rounds", [(1, True), (0, True), (3, False),
                                    (2, True)])
@pytest.mark.parametrize("tile", [32, 100, 512, 896])
@pytest.mark.parametrize("case", ["stale", "chains", "cross_block",
                                  "partial_group"])
def test_device_instance_equals_its_twin_and_plain(cuda_device, spec, rounds,
                                                   tile, case):
    """The device-memory instance, which reads each tile's cells a tile
    ahead, bit for bit against ``ref_boundary_pass`` and against its twin
    ``ref_boundary_pass_prefetched`` (state rows, matched, conflicts), on
    cases that force a stale lane, chains of three rounds and more,
    consecutive tiles of other block pairs and a partial last ring group;
    its profile's round counts equal the twin's."""
    sp = getattr(StateSpec, spec)()
    vector_rounds, fallback = rounds
    pairs, u, v, state = _prefetch_case(case, tile, tile + len(case))
    blk_u = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    blk_v = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    args = (blk_u, blk_v, torch.from_numpy(u), torch.from_numpy(v))
    rows = torch.from_numpy(state).to(sp.vmem_dtype)
    kw = dict(vector_rounds=vector_rounds, fallback=fallback, spec=sp)
    rows_p, rows_t, rows_k = rows.clone(), rows.clone(), rows.to(cuda_device)
    want = ref.ref_boundary_pass(rows_p, *args, **kw)
    *twin, stats = ref.ref_boundary_pass_prefetched(rows_t, *args, **kw)
    prof = torch.zeros(len(kernel.PROFILE_FIELDS), dtype=torch.int64,
                       device=cuda_device)
    kernel.reset_launch_counts()
    got = kernel.boundary_tier(rows_k, *(a.to(cuda_device) for a in args),
                               instance="device", profile=prof, **kw)
    torch.cuda.synchronize()
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    _same((rows_k.cpu(), rows_p), (rows_t, rows_p),
          *((a.cpu(), b) for a, b in zip(got, want)), *zip(twin, want))
    cyc = dict(zip(kernel.PROFILE_FIELDS, prof.tolist()))
    for f in ("later_round_tiles", "free_tiles", "free_rounds"):
        assert cyc[f] == stats[f], f
    assert cyc["stale_lanes"] <= stats["stale_lanes"]
    if case == "stale":
        assert stats["stale_lanes"] >= len(pairs) - 1
    if case == "chains" and fallback:
        assert stats["later_round_tiles"] == len(pairs)


@pytest.mark.cuda
def test_device_instance_sees_stale_lanes(cuda_device):
    """On a long stream whose every tile takes a vertex the tile before
    committed, the device instance's profile counts stale lanes: its reads
    a tile ahead are checked against the commits in between, and stay bit
    for bit with the plain version."""
    pairs, u, v, state = _prefetch_case("stale", 64, 5)
    reps = 200
    u = np.concatenate([u + 0] * reps)
    v = np.concatenate([v + 0] * reps)
    for k in range(1, u.shape[0]):  # fresh vertices again, tile by tile
        u[k, 0], v[k, 0] = 1000 + 2 * (k % 1500), 1001 + 2 * (k % 1500)
        u[k, 1], v[k, 1] = u[k - 1, 0], 4095 - (k % 90)
    pairs = [(0, 0)] * u.shape[0]
    args = tuple(torch.tensor(a, dtype=torch.int32, device=cuda_device)
                 for a in ([p[0] for p in pairs], [p[1] for p in pairs], u,
                           v))
    rows = torch.zeros((4, 4096), dtype=torch.uint8, device=cuda_device)
    rows_p = rows.clone()
    prof = torch.zeros(len(kernel.PROFILE_FIELDS), dtype=torch.int64,
                       device=cuda_device)
    got = kernel.boundary_tier(rows, *args, instance="device", profile=prof)
    want = ref.ref_boundary_pass(rows_p, *args)
    torch.cuda.synchronize()
    _same((rows, rows_p), *zip(got, want))
    assert dict(zip(kernel.PROFILE_FIELDS, prof.tolist()))["stale_lanes"] > 0


@pytest.mark.cuda
def test_global_tier_instance_follows_the_shape(cuda_device):
    """u8 state at window 65536 is staged; legacy_i32 there stays in
    device memory, and asking it for the staged instance raises."""
    i32 = StateSpec.legacy_i32()
    rows = torch.zeros((2, 65536), dtype=torch.int32, device=cuda_device)
    ids = torch.full((1, 256), -1, dtype=torch.int32, device=cuda_device)
    blk = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    assert kernel.boundary_instance(65536, 256, StateSpec.u8()) == "staged"
    assert kernel.boundary_instance(65536, 256, i32) == "device"
    kernel.boundary_tier(rows, blk, blk, ids, ids, spec=i32)
    with pytest.raises(ValueError, match="staged"):
        kernel.boundary_tier(rows, blk, blk, ids, ids, spec=i32,
                             instance="staged")


# ------------------------------------------------------- flash attention --
# Tolerances as in chip_smoke.py: f32 2e-5 (sums in other orders), bf16
# 2e-2 (each side rounds one f32 result to bf16).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TF32_INSTANCES = [(torch.float32, 64), (torch.float32, 80),
                  (torch.float32, 128), (torch.bfloat16, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", TF32_INSTANCES)
@pytest.mark.parametrize("s", [256, 200])
def test_tf32_pre_pass_equals_split_tf32(cuda_device, dtype, d, s):
    """The pre-pass's planes are bit-equal to ``ref.tf32_planes`` on the
    same CUDA inputs: Q * scale and K split by ``ref.split_tf32`` and
    zero-padded to whole 32-float columns, V split and transposed with
    its keys in ``ref.vt_key_order``; no K or V lo plane for bf16."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention import ref as fref

    gen = torch.Generator(device=cuda_device).manual_seed(d + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((1, 4, s, d), (1, 2, s, d),
                                        (1, 2, s, d)))
    flash.reset_launch_counts()
    got = flash.split_tf32_cuda(q, k, v, d ** -0.5)
    want = fref.tf32_planes(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash.launch_counts()[flash.FLASH_SPLIT] == 1
    assert set(got) == set(want)
    for name in got:
        if want[name] is None:
            assert got[name] is None, name
            continue
        assert torch.equal(got[name], want[name]), name
    # the transposition itself: V^T read back in key order is V's split
    order = torch.argsort(fref.vt_key_order(s)).to(cuda_device)
    v_hi, _ = fref.split_tf32(v.reshape(2, s, d))
    assert torch.equal(got["v_hi"][:, :, order], v_hi.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,blk", [
    (2, 4, 2, 256, 64, True, 0, 64),
    (1, 8, 1, 256, 128, False, 0, 128),
    (1, 6, 3, 384, 80, True, 100, 128),
    (1, 4, 2, 256, 64, False, 48, 32),
    (1, 8, 2, 1024, 128, True, 256, 128),
])
def test_flash_kernel_equal_plain(cuda_device, dtype, b, hq, hkv, s, d,
                                  causal, window, blk):
    from repro_torch.kernels.flash_attention import (
        flash_attention, online_softmax_attention)

    from repro_torch.kernels.flash_attention import kernel as flash

    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    flash.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window, block_q=blk,
                          block_k=blk)
    want = online_softmax_attention(q, k, v, block_q=blk, block_k=blk,
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    name = flash.kernel_for(dtype, d)
    assert flash.launch_counts()[name] == 1
    assert flash.launch_counts()[flash.FLASH] == 0
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLASH_TOL[dtype], err


@pytest.mark.cuda
def test_flash_launch_count_and_bad_shapes(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash

    q = torch.randn((1, 2, 128, 64), device=cuda_device)
    flash.reset_launch_counts()
    flash_attention(q, q, q)
    # CPU tensors go to the card unless the CPU is asked for
    flash_attention(q.cpu(), q.cpu(), q.cpu())
    flash_attention(q.cpu(), q.cpu(), q.cpu(), device="cpu")
    # f32: the three-term kernel, its pre-pass counted on its own
    f32 = {flash.FLASH: 0, flash.FLASH_WGMMA: 0, flash.FLASH_TF32: 2,
           flash.FLASH_SPLIT: 2}
    assert flash.launch_counts() == f32
    qb = q.to(torch.bfloat16)
    flash_attention(qb, qb, qb)
    assert flash.launch_counts() == {**f32, flash.FLASH_WGMMA: 1}
    q80 = torch.randn((1, 2, 128, 80), device=cuda_device,
                      dtype=torch.bfloat16)
    flash_attention(q80, q80, q80)
    both = {**f32, flash.FLASH_WGMMA: 1, flash.FLASH_TF32: 3,
            flash.FLASH_SPLIT: 3}
    assert flash.launch_counts() == both
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    odd = torch.randn((1, 2, 12, 64), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash_attention(t, q, q)
    assert flash.launch_counts() == both


@pytest.mark.cuda
def test_bmatch_on_card_equals_cpu(cuda_device):
    from repro_torch.core.bipartite import bmatch_assign

    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(-1, 300, 3000).astype(np.int32))
    exp = torch.from_numpy(rng.integers(0, 40, 3000).astype(np.int32))
    kw = dict(num_tokens=300, num_experts=40, token_budget=8,
              expert_capacity=80, tile_size=512, with_stats=True)
    got, gs = bmatch_assign(tok.to(cuda_device), exp.to(cuda_device), **kw)
    want, ws = bmatch_assign(tok, exp, **kw)
    assert torch.equal(got.cpu(), want)
    assert int(gs["conflicts"]) == int(ws["conflicts"])


# ---- the raw-stream matcher and the baselines on the card ------------------

def _raw_stream(case):
    """The raw-stream cases: n = 257 (a row that is no whole number of
    16-byte units: the device-memory instance), RMAT scale 10 (n = 1024:
    the staged instance), a star, and a stream with self-loops, padding,
    half-invalid slots and duplicates."""
    from repro_torch.graphs import path_graph
    from repro_torch.interop import edges_from_arrays

    if case == "path257":
        return path_graph(257)
    if case == "rmat10":
        return rmat_graph(10, 8, seed=2)
    if case == "star":
        return star_graph(600)
    rng = np.random.default_rng(11)
    n, m = 300, 1500
    u = rng.integers(0, n, m)
    v = np.where(rng.random(m) < 0.1, u, rng.integers(0, n, m))
    pad = rng.random(m) < 0.05
    u, v = np.where(pad, -1, u), np.where(pad, -1, v)
    u = np.where(rng.random(m) < 0.03, -1, u)
    return edges_from_arrays(u, v, n)


def _same_match(got, want):
    (r, c), (rp, cp) = got, want
    _same((r.match_mask.cpu(), rp.match_mask), (r.state.cpu(), rp.state),
          (c.cpu(), cp))
    for f in ("edge_reads", "state_loads", "state_stores", "rounds"):
        _same((getattr(r.counters, f).cpu(), getattr(rp.counters, f)))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("dispersed", [True, False])
@pytest.mark.parametrize("tile", [32, 256, 512, 1024])
@pytest.mark.parametrize("case", ["path257", "rmat10", "star", "hazards"])
def test_skipper_on_card_equals_plain(cuda_device, spec, dispersed, tile,
                                      case):
    """``skipper`` on the card (the global-tier kernel over one state row)
    bit for bit against its plain version on the CPU, mask, state,
    conflicts and counters; one launch a call: the asynchronous global
    tier, or the first one for tiles over 896 lanes."""
    from repro_torch.core import skipper

    g = _raw_stream(case)
    kw = dict(tile_size=tile, dispersed=dispersed, with_conflicts=True,
              spec=getattr(StateSpec, spec)(), vector_rounds=2)
    kernel.reset_launch_counts()
    got = skipper(g, verify=True, device=cuda_device, **kw)
    torch.cuda.synchronize()
    launched = (kernel.BOUNDARY if tile > kernel.BOUNDARY_ASYNC_MAX_THREADS
                else kernel.BOUNDARY_ASYNC)
    assert kernel.launch_counts() == {
        kernel.WINDOW_ASYNC: 0, kernel.WINDOW_TIER: 0,
        kernel.BOUNDARY_ASYNC: int(launched == kernel.BOUNDARY_ASYNC),
        kernel.BOUNDARY: int(launched == kernel.BOUNDARY)}
    _same_match(got, skipper(g, device="cpu", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("instance", kernel.INSTANCES)
@pytest.mark.parametrize("tile", [256, 512])
def test_raw_stream_instances_equal_plain(cuda_device, spec, instance, tile):
    """Each instance of the asynchronous global tier, named rather than
    picked, on the raw stream of RMAT scale 12 (n = 4,096, where both
    fit): state, mask and conflicts bit for bit against ``ref_skipper`` on
    the CPU, one launch. ``skipper`` takes the device-memory instance at
    any n whose row does not fit shared memory, as at RMAT scale 22. The
    instance is named on ``boundary_tier`` over the row with every tile
    the pair (0, 0), the launch ``kernel.tiles_on_card`` makes."""
    from repro_torch.core.skipper import stream_tiles

    g = rmat_graph(12, 8, seed=6)
    s = getattr(StateSpec, spec)()
    n = g.num_vertices
    ut, vt = stream_tiles(g, tile)
    state = torch.zeros(n, dtype=s.at_rest_dtype)
    matched, conflicts = ref.ref_skipper(state, ut, vt, vector_rounds=2)
    kernel.reset_launch_counts()
    row = torch.zeros((1, n), dtype=s.vmem_dtype, device=cuda_device)
    pairs = torch.zeros(ut.shape[0], dtype=torch.int32, device=cuda_device)
    got = kernel.boundary_tier(row, pairs, pairs, ut.to(cuda_device),
                               vt.to(cuda_device), vector_rounds=2, spec=s,
                               instance=instance)
    torch.cuda.synchronize()
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    _same((row[0].cpu().to(s.at_rest_dtype), state),
          (got[0].cpu() > 0, matched),
          (got[1].cpu().to(torch.int32), conflicts))
    assert kernel.boundary_instance(1 << 22, 512) == "device"


@pytest.mark.cuda
def test_boundary_tier_owns_alignment(cuda_device, monkeypatch):
    """Pairs and ids off a 16-byte address (views one element into a
    buffer) and a u8 state row off one (a view one byte in), where the
    shape takes the staged instance: ``boundary_tier`` copies the pairs
    and ids to aligned memory, launches the device-memory instance for
    the row, and equals the aligned run bit for bit; naming ``"staged"``
    for that row raises."""
    from repro_torch.core.skipper import stream_tiles

    g = rmat_graph(10, 8, seed=3)
    n = g.num_vertices
    ut, vt = (t.to(cuda_device) for t in stream_tiles(g, 256))
    pairs = torch.zeros(ut.shape[0], dtype=torch.int32, device=cuda_device)
    assert kernel.boundary_instance(n, 256) == "staged"

    def off(t, by=1):  # t's values in a view ``by`` elements into a buffer
        buf = torch.zeros(t.numel() + by, dtype=t.dtype, device=t.device)
        view = buf[by:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    lib, staged = kernel._library(), []

    class Spy:  # records the staged flag of each global-tier launch
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if not name.startswith("skipper_boundary_async_"):
                return fn

            def launch(*args):
                staged.append(args[12])
                return fn(*args)
            return launch

    monkeypatch.setattr(kernel, "_library", Spy)

    def run(row, blk, u, v):
        out = kernel.boundary_tier(row.view(1, n), blk, blk, u, v,
                                   vector_rounds=2)
        return row.cpu(), out[0].cpu(), out[1].cpu()

    def row():
        return torch.zeros(n, dtype=torch.uint8, device=cuda_device)

    want = run(row(), pairs, ut, vt)
    got_ids = run(row(), off(pairs), off(ut), off(vt))
    bad_row = off(row())
    got_row = run(bad_row, pairs, ut, vt)
    torch.cuda.synchronize()
    assert staged == [1, 1, 0]
    _same(*zip(want, got_ids), *zip(want, got_row))
    with pytest.raises(ValueError, match="16-byte address"):
        kernel.boundary_tier(bad_row.view(1, n), pairs, pairs, ut, vt,
                             instance="staged")


# ---- the global tier's filtered instance on the raw stream -----------------

def _filter_tiles_needed(device):
    """The fewest tiles for which ``tiles_on_card`` takes the filtered
    instance on this card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return kernel.FILTERED_TILES_PER_SM * sms


def _filter_stream(case, tile, tiles, seed=1):
    """Raw-stream tiles (``stream_tiles``, dispersed) of about ``tiles``
    tiles of ``tile`` lanes: ``kron`` an RMAT graph of the edges that
    takes, ``uniform`` uniform endpoints over four times as many vertices
    as lanes a tile, ``dense`` 64 vertices (every lane past the first
    tiles dies), ``matching`` disjoint edges (every lane is free), each
    with self-loops and padding."""
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.interop import edges_from_arrays

    rng = np.random.default_rng(seed)
    m = tile * tiles - tile // 3
    if case == "kron":
        scale = max(6, int(np.log2(max(m // 8, 64))))
        g = rmat_graph(scale, max(1, m >> scale), seed=seed)
        u, v, n = g.u.numpy()[:m], g.v.numpy()[:m], g.num_vertices
    elif case == "matching":
        n = 2 * m
        u, v = np.arange(0, n, 2), np.arange(1, n, 2)
        perm = rng.permutation(m)
        u, v = u[perm], v[perm]
    else:
        n = 64 if case == "dense" else 4 * tile * 8
        u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    if case != "matching":
        v = np.where(rng.random(len(u)) < 0.05, u, v)
    g = edges_from_arrays(u, v, n)
    ut, vt = stream_tiles(g, tile)
    return ut, vt, n


def _filtered_vs_plain(ut, vt, n, spec, vector_rounds, device, row=None):
    """The filtered instance, named on ``boundary_tier`` over one row,
    against ``ref_skipper`` on the CPU from the same row: state, mask,
    conflicts. Returns the card's outputs."""
    s = getattr(StateSpec, spec)()
    if row is None:
        row = torch.zeros(n, dtype=s.at_rest_dtype)
    state = row.clone()
    matched, conflicts = ref.ref_skipper(state, ut, vt,
                                         vector_rounds=vector_rounds)
    card = row.to(s.vmem_dtype).to(device).reshape(1, n)
    pairs = torch.zeros(ut.shape[0], dtype=torch.int32, device=device)
    kernel.reset_launch_counts()
    got = kernel.boundary_tier(card, pairs, pairs, ut.to(device),
                               vt.to(device), vector_rounds=vector_rounds,
                               spec=s, instance=kernel.FILTERED)
    torch.cuda.synchronize()
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    _same((card[0].cpu().to(s.at_rest_dtype), state),
          (got[0].cpu() > 0, matched),
          (got[1].cpu().to(torch.int32), conflicts))
    return card, got


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("vector_rounds", [0, 1, 3])
@pytest.mark.parametrize("tile", [32, 65, 260, 512, 516, 896])
@pytest.mark.parametrize("case", ["kron", "uniform", "dense"])
def test_filtered_instance_equals_plain(cuda_device, spec, vector_rounds,
                                        tile, case):
    """The filtered instance bit for bit against ``ref_skipper``: kron-like,
    uniform and dense streams, tile widths whose last warp is short and the
    widest the asynchronous tier takes, every vector_rounds kind (none,
    one, several), both state and counter widths."""
    ut, vt, n = _filter_stream(case, tile, 3000 // max(1, tile // 64))
    _filtered_vs_plain(ut, vt, n, spec, vector_rounds, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("tile", [64, 512])
def test_filtered_instance_all_free_and_all_dead(cuda_device, spec, tile):
    """A stream whose every lane is free (disjoint edges: each pack is
    whole tiles of free lanes, nothing dies), and the same stream over a
    row already all MCHD (every lane dies in the filter)."""
    ut, vt, n = _filter_stream("matching", tile, 2048 * 64 // tile)
    _filtered_vs_plain(ut, vt, n, spec, 1, cuda_device)
    full = torch.full((n,), 2, dtype=getattr(StateSpec, spec)().at_rest_dtype)
    card, (m, c) = _filtered_vs_plain(ut, vt, n, spec, 1, cuda_device, full)
    assert not bool((m > 0).any()) and not bool((c > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kron", "uniform"])
def test_filtered_instance_is_the_same_every_launch(cuda_device, case):
    """Twenty back-to-back launches on one input: the filter's snapshots
    and packs move with timing, the outputs do not."""
    ut, vt, n = _filter_stream(case, 512, 4096, seed=9)
    ut, vt = ut.to(cuda_device), vt.to(cuda_device)
    pairs = torch.zeros(ut.shape[0], dtype=torch.int32, device=cuda_device)
    outs = []
    for _ in range(20):
        row = torch.zeros((1, n), dtype=torch.uint8, device=cuda_device)
        m, c = kernel.boundary_tier(row, pairs, pairs, ut, vt,
                                    instance=kernel.FILTERED)
        outs.append((row, m, c))
    torch.cuda.synchronize()
    for got in outs[1:]:
        _same(*zip(got, outs[0]))
    state = torch.zeros(n, dtype=torch.uint8)
    matched, conflicts = ref.ref_skipper(state, ut.cpu(), vt.cpu())
    _same((outs[0][0][0].cpu(), state), (outs[0][1].cpu() > 0, matched),
          (outs[0][2].cpu().to(torch.int32), conflicts))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("side", [-1, 0])
def test_skipper_takes_the_filter_from_its_tile_threshold(
        cuda_device, monkeypatch, spec, side):
    """``skipper`` one tile below ``FILTERED_TILES_PER_SM`` tiles a SM
    launches a single-block instance (the one the row's shape picks), and
    from there the filtered one (the C entry's instance code 2);
    one launch of ``skipper_boundary_async_kernel`` a call either way, and
    the result bit for bit the plain version's."""
    from repro_torch.core import skipper
    from repro_torch.interop import edges_from_arrays

    tile = 64
    tiles = _filter_tiles_needed(cuda_device) + side
    assert kernel.takes_filtered(tiles, tile, cuda_device) == (side == 0)
    rng = np.random.default_rng(4)
    n, m = 5000, tiles * tile
    g = edges_from_arrays(rng.integers(0, n, m), rng.integers(0, n, m), n)
    lib, codes = kernel._library(), []

    class Spy:  # records the instance code of each global-tier launch
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if not name.startswith("skipper_boundary_async_"):
                return fn

            def launch(*args):
                codes.append(args[12])
                return fn(*args)
            return launch

    kw = dict(tile_size=tile, with_conflicts=True, vector_rounds=1,
              spec=getattr(StateSpec, spec)())
    kernel.reset_launch_counts()
    monkeypatch.setattr(kernel, "_library", Spy)
    got = skipper(g, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert len(codes) == 1 and (codes[0] == 2) == (side == 0)
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    _same_match(got, skipper(g, device="cpu", **kw))


@pytest.mark.cuda
def test_short_streams_and_profiles_keep_the_single_block(cuda_device):
    """The callers below the threshold keep today's single-block instance:
    the engine's slab pass (32 tiles), and a ``profile=`` request, which
    names the device instance; ``takes_filtered`` is false off the card, for
    tiles over 896 lanes and below the threshold."""
    from repro_torch.core import engine

    need = _filter_tiles_needed(cuda_device)
    assert not kernel.takes_filtered(need, 1024, cuda_device)
    assert not kernel.takes_filtered(need - 1, 512, cuda_device)
    assert not kernel.takes_filtered(10 * need, 512, "cpu")
    assert kernel.takes_filtered(need, 896, cuda_device)
    rng = np.random.default_rng(2)
    n, tile = 4096, 256
    u = torch.from_numpy(rng.integers(0, n, 32 * tile).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, n, 32 * tile).astype(np.int32))
    state = torch.zeros(n, dtype=torch.uint8, device=cuda_device)
    kernel.reset_launch_counts()
    engine.stream_pass(state, u.to(cuda_device), v.to(cuda_device), n=n,
                       vector_rounds=1, tile_size=tile)
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    with pytest.raises(ValueError, match="filtered"):
        row = torch.zeros((1, n), dtype=torch.uint8, device=cuda_device)
        pairs = torch.zeros(32, dtype=torch.int32, device=cuda_device)
        prof = torch.zeros(len(kernel.PROFILE_FIELDS), dtype=torch.int64,
                           device=cuda_device)
        kernel.boundary_tier(row, pairs, pairs,
                             u.to(cuda_device).reshape(32, tile),
                             v.to(cuda_device).reshape(32, tile),
                             instance=kernel.FILTERED, profile=prof)


@pytest.mark.cuda
def test_filtered_geometry_comes_from_the_source(cuda_device):
    """The wrapper's block and lag (the CPU twin's defaults) are the CUDA
    source's, its shared memory and scratch come from the source's own
    functions, and the C entry refuses a scratch one word short."""
    from repro_torch.kernels import _build

    lib = kernel._library()
    assert lib.skipper_filtered_threads() == kernel.FILTERED_THREADS
    assert lib.skipper_filtered_lag() == kernel.FILTERED_LAG
    assert kernel.filtered_smem_bytes() <= _build.MAX_SMEM_BYTES
    tile = 64
    words = kernel.filtered_scratch_words(tile)
    assert words > 2 * kernel.FILTERED_LAG * tile
    ut, vt, n = _filter_stream("uniform", tile, 8)
    ut, vt = ut.to(cuda_device), vt.to(cuda_device)
    row = torch.zeros((1, n), dtype=torch.uint8, device=cuda_device)
    out = torch.empty(ut.shape, dtype=torch.uint8, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for given, want in ((words - 1, 1), (words, 0)):
        scratch = torch.empty((given,), dtype=torch.int32, device=cuda_device)
        err = lib.skipper_boundary_async_uint8_uint8(
            None, None, ut.data_ptr(), vt.data_ptr(), row.data_ptr(),
            out.data_ptr(), out.data_ptr(), ut.shape[0], tile, n, 1, 1, 2,
            kernel.filtered_smem_bytes(), None, scratch.data_ptr(), given,
            None, stream)
        torch.cuda.synchronize()
        assert err == want  # 1: cudaErrorInvalidValue


@pytest.mark.cuda
def test_skipper_counts_its_survivors_only_under_a_profiler(cuda_device):
    """``skipper.survivor_lanes`` exists under a profiler, at most the
    valid lanes (``skipper.edges``) and more than none; outside a profiler
    nothing counts it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.core import skipper

    g = rmat_graph(16, 16, seed=3)
    assert kernel.takes_filtered(-(-g.num_edges // 512), 512, cuda_device)
    tracing.reset()
    skipper(g, device=cuda_device)
    assert "skipper.survivor_lanes" not in tracing.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        skipper(g, device=cuda_device)
    got = tracing.counters()
    assert 0 < got["skipper.survivor_lanes"] <= got["skipper.edges"]
    tracing.reset()


@pytest.mark.cuda
def test_skipper_defaults_to_the_card(cuda_device):
    from repro_torch.core import skipper

    res, conf = skipper(rmat_graph(9, 4, seed=1), tile_size=64)
    assert res.match_mask.device.type == "cuda" and conf is None
    assert res.state.device.type == "cuda"


@pytest.mark.cuda
def test_baselines_on_card_equal_plain(cuda_device):
    """IDMM as it is, Israeli–Itai and SIDMM given the same permutations:
    the card's run equals the CPU's, mask, state and counters."""
    from repro_torch.core import ems_idmm, ems_israeli_itai, sidmm

    g = rmat_graph(10, 8, seed=2)
    m = g.num_edges
    gen = torch.Generator().manual_seed(5)
    pris = [torch.randperm(m, generator=gen).to(torch.int32)
            for _ in range(128)]
    perm = torch.randperm(-(-m // 512) * 512, generator=gen)
    runs = [lambda d: ems_idmm(g, device=d),
            lambda d: ems_israeli_itai(g, priorities=pris.__getitem__,
                                       device=d),
            lambda d: sidmm(g, batch_size=512, perm=perm, device=d)]
    for run in runs:
        got, want = run(cuda_device), run("cpu")
        assert got.match_mask.device.type == "cuda"
        _same((got.match_mask.cpu(), want.match_mask),
              (got.state.cpu(), want.state))
        for f in ("edge_reads", "state_loads", "state_stores", "rounds"):
            _same((getattr(got.counters, f).cpu(),
                   getattr(want.counters, f)))
        assert_matching(g, got.match_mask)


@pytest.mark.cuda
def test_pin_entry_points_on_card(cuda_device):
    """The APRAM oracle on masks from the card: skipper, both backends of
    skipper_match and the b-matching, at both widths, and sgmm."""
    from repro_torch.testing import pin_entry_points

    out = pin_entry_points(rmat_graph(7, 2, seed=3), window=64,
                           tile_size=32, device=cuda_device)
    assert {"skipper_match_cuda@u8", "skipper_match_cuda@legacy_i32",
            "skipper@u8", "skipper@legacy_i32", "sgmm",
            "distributed@u8", "chaos_recover@legacy_i32"} <= set(out)
    assert len(out) == 13


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("tile", [64, 256, 1024])
@pytest.mark.parametrize("vector_rounds", [0, 2])
def test_stream_pass_kernel_equals_plain(cuda_device, dtype, tile,
                                         vector_rounds):
    """``engine.stream_pass`` on the card (the global-tier kernel as one
    state row, in place, at the state's width; invalid slots written as
    (-1, -1) first) against its plain version, from a state with MCHD
    cells, on a slab with self-loops, half-invalid slots and padding."""
    from repro_torch.core import engine

    gen = torch.Generator().manual_seed(tile + vector_rounds)
    n, slab = 3000, 6 * tile
    u = torch.randint(0, n, (slab,), generator=gen, dtype=torch.int32)
    v = torch.randint(0, n, (slab,), generator=gen, dtype=torch.int32)
    v = torch.where(torch.rand(slab, generator=gen) < 0.05, u, v)
    u = torch.where(torch.rand(slab, generator=gen) < 0.05, -1, u)
    st0 = torch.where(torch.rand(n, generator=gen) < 0.1, 2, 0).to(dtype)
    kw = dict(n=n, vector_rounds=vector_rounds, tile_size=tile)
    sk, sp = st0.to(cuda_device), st0.to(cuda_device)
    kernel.reset_launch_counts()
    out_k = engine.stream_pass(sk, u.to(cuda_device), v.to(cuda_device),
                               backend="cuda", **kw)
    launched = kernel.launch_counts()
    out_p = engine.stream_pass(sp, u.to(cuda_device), v.to(cuda_device),
                               backend="torch", **kw)
    assert out_k[0] is sk and sk.dtype == dtype
    _same(*zip(out_k, out_p))
    wide = tile > kernel.BOUNDARY_ASYNC_MAX_THREADS
    assert launched[kernel.BOUNDARY if wide else kernel.BOUNDARY_ASYNC] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("sharded", [False, True])
def test_distributed_kernels_equal_plain(cuda_device, spec, sharded):
    """``distributed_skipper`` on one rank, clean and under each fault site
    with ``on_fault="recover"``: the kernels against the plain path on the
    same CUDA tensors (mask, state, counters, every stats field)."""
    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.core.faults import FaultPlan

    g = rmat_graph(10, 8, seed=5).to(cuda_device)
    kw = dict(block_size=128, tile_size=64, spec=getattr(StateSpec, spec)(),
              device=cuda_device)
    if sharded:
        kw.update(window=256, reorder="degree")
    plans = [None] + [FaultPlan(seed=7, **p) for p in (
        dict(drop_proposals=0.3), dict(truncate_retry=0),
        dict(corrupt_state=0.05), dict(lose_shard=0), dict(skip_drain=True))]
    fields = ("proposals", "lost_proposals", "requeued", "retry_overflow",
              "undrained", "gathered_bytes", "recovery_attempts",
              "residual_edges", "recovered_matches", "corrupted_cells")
    for plan in plans:
        pol = dict(faults=plan, on_fault="recover", verify=True) \
            if plan is not None else {}
        rk, sk = distributed_skipper(g, backend="cuda", **kw, **pol)
        rp, sp = distributed_skipper(g, backend="torch", **kw, **pol)
        _same((rk.match_mask, rp.match_mask), (rk.state, rp.state))
        for f in ("edge_reads", "state_loads", "state_stores"):
            _same((getattr(rk.counters, f), getattr(rp.counters, f)))
        for f in fields:
            assert int(torch.as_tensor(getattr(sk, f))) == int(
                torch.as_tensor(getattr(sp, f))), (plan, f)
        assert_matching(g, rk.match_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_skipper_match_faults_kernels_equal_plain(cuda_device, spec):
    """``skipper_match`` under each site live at one rank, and combined,
    with ``"report"`` and ``"recover"``: kernels against plain."""
    from repro_torch.core.faults import FaultPlan

    g = rmat_graph(11, 8, seed=4)
    kw = dict(window=256, tile_size=64, reorder="degree", with_conflicts=True,
              spec=getattr(StateSpec, spec)(), device=cuda_device)
    for plan in (dict(drop_proposals=0.3), dict(corrupt_state=0.05),
                 dict(lose_shard=0),
                 dict(drop_proposals=0.25, corrupt_state=0.05, lose_shard=1)):
        for pol in ("report", "recover"):
            fp = FaultPlan(seed=7, **plan)
            rk, ck, repk = skipper_match(g, backend="cuda", faults=fp,
                                         on_fault=pol, **kw)
            rp, cp, repp = skipper_match(g, backend="torch", faults=fp,
                                         on_fault=pol, **kw)
            _same((rk.match_mask, rp.match_mask), (rk.state, rp.state),
                  (ck, cp))
            assert repk == repp


@pytest.mark.cuda
def test_smoke_serve_on_card(cuda_device):
    from repro_torch.launch.serve import serve

    kw = dict(num_requests=3, slots=2, prompt_len=24, max_new=4,
              device=cuda_device)
    out1, stats = serve("granite-moe-3b-a800m", True, **kw)
    out2, _ = serve("granite-moe-3b-a800m", True, **kw)
    assert out1 == out2 and sorted(out1) == [0, 1, 2]
    assert stats["decoded"] == sum(len(v) for v in out1.values())


@pytest.mark.cuda
def test_analyzer_clean_on_built_kernels(cuda_device):
    """Every template instance of the matcher's and the attention's
    kernels (the global tier's filtered instance among them) and every
    entry target analyzes to no ERROR, and so does src/repro_torch."""
    from repro_torch.analysis import run_analysis

    report = run_analysis()
    assert report.clean, report.render()
    assert len(report.targets_analyzed) == 46


@pytest.mark.cuda
def test_analyzer_catches_each_dropped_proxy_fence(cuda_device, tmp_path):
    """Each of the three ``fence.proxy.async`` of the matcher's source
    (the staged global tier's row write-back, its final write-back, and the
    window tier's) guards generic stores that a bulk store then reads:
    built without it, the kernel it sits in gets a PROXY ERROR from
    ``smem-barrier``; built with all three, none."""
    from repro_torch.analysis.build import demangle, parse_ptx
    from repro_torch.analysis.rules.barrier import hazards
    from repro_torch.kernels import _build

    lines = kernel.SOURCE.read_text().splitlines()
    fences = [n for n, ln in enumerate(lines)
              if "fence.proxy.async.shared::cta" in ln]
    assert len(fences) == 3
    copies = []
    for i, n in enumerate(fences):
        path = tmp_path / f"skipper_match_nofence{i}.cu"
        path.write_text("\n".join(lines[:n] + lines[n + 1:]) + "\n")
        copies.append(path)
    built = _build.build(kernel.SOURCE, *copies, ptx=True)

    def proxy(path):
        entries = parse_ptx(Path(built[str(path)]["path"]).read_text())
        return {demangle(m).name for m, e in entries.items()
                if any(k == "PROXY" for _, _, k, _ in hazards(e))}

    assert proxy(kernel.SOURCE) == set()
    assert proxy(copies[0]) == {kernel.BOUNDARY_ASYNC}
    assert proxy(copies[1]) == {kernel.BOUNDARY_ASYNC}
    assert proxy(copies[2]) == {kernel.WINDOW_ASYNC}


@pytest.mark.cuda
def test_analyzer_checks_the_filtered_instance_beside_its_atomics(
        cuda_device, tmp_path):
    """``ATOMIC_ORDERED`` accepts the filtered instance's pairs of shared
    atomics and nothing else: built without the barrier between its reads
    of the pack's bases and its table inserts, or the one between its reads
    of the claims and its commits, that instance gets an ERROR from
    ``smem-barrier``; built as it is, none."""
    import types

    from repro_torch.analysis.build import demangle, parse_ptx
    from repro_torch.analysis.report import Severity
    from repro_torch.analysis.rules.barrier import SmemBarrier
    from repro_torch.kernels import _build

    lines = kernel.SOURCE.read_text().splitlines()
    guards = ("every read of the bases precedes the table's inserts",
              "every read of the claims precedes the commits")
    copies = []
    for i, text in enumerate(guards):
        at = [n for n, ln in enumerate(lines) if text in ln]
        assert len(at) == 1 and "__syncthreads();" in lines[at[0]]
        path = tmp_path / f"skipper_match_nobarrier{i}.cu"
        path.write_text("\n".join(lines[:at[0]] + lines[at[0] + 1:]) + "\n")
        copies.append(path)
    built = _build.build(kernel.SOURCE, *copies, ptx=True)

    def errors(path):
        entries = parse_ptx(Path(built[str(path)]["path"]).read_text())
        out = {}
        for m, e in entries.items():
            d = demangle(m)
            if d.name == kernel.BOUNDARY_ASYNC and d.template[-1] == "2":
                art = types.SimpleNamespace(ptx=e, mangled=m, name=str(d))
                out[d.template] = [f for f in SmemBarrier().check_kernel(art)
                                   if f.severity is Severity.ERROR]
        assert len(out) == 4  # the (state, counter) widths
        return out

    assert not any(errors(kernel.SOURCE).values())
    for path in copies:
        assert all(errors(path).values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dropped_dma_wait", "dynamic_gather",
                                  "hardcoded_state_dtype",
                                  "swapped_writeback"])
def test_analyzer_catches_each_canary(cuda_device, name):
    from repro_torch.analysis import analyze_mutation
    from repro_torch.analysis.runner import caught

    assert caught(name, analyze_mutation(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dynamic_gather", "swapped_writeback"])
def test_canary_equals_its_plain_version(cuda_device, name):
    from repro_torch.analysis import mutations
    from repro_torch.analysis.rules.order import fixture

    x = fixture("boundary", StateSpec.u8(), cuda_device)
    sk, sp = x["state"].clone(), x["state"].clone()
    args = (x["blk_u"], x["blk_v"], x["u"], x["v"])
    got = mutations.boundary_tier(name, sk, *args)
    want = mutations.plain(name, sp, *args)
    torch.cuda.synchronize()
    _same((sk, sp), *zip(got, want))


# ---------------------------------------------------------- training path --
def _train_step_on(device, arch, seed=0):
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.launch import adapters
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    mask = rng.random((2, 32)) > 0.2
    model = adapters.init_fn(torch.Generator().manual_seed(seed),
                             cfg).to(device)
    opt = adamw.init_state(dict(model.named_parameters()), tcfg)
    batch = {"tokens": torch.from_numpy(tokens).to(device),
             "mask": torch.from_numpy(mask).to(device)}
    opt, metrics = make_train_step(cfg, tcfg)(model, opt, batch)
    return (dict(model.named_parameters()), opt,
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_smoke_train_step_on_card_equals_cpu(cuda_device, arch):
    """One f32 train step on the card against the same step on the CPU:
    loss and grad norm within 1e-4 relative, the moments within 1e-4 of
    each leaf's largest magnitude; the parameters within 1e-4 plus what a
    gradient error of 1e-4 moves AdamW's first update ``lr * g / (|g| +
    1e-8)`` (``g`` is ``mu / (1 - beta1)``)."""
    p1, o1, m1 = _train_step_on(cuda_device, arch)
    p0, o0, m0 = _train_step_on("cpu", arch)
    for k in ("loss", "grad_norm"):
        assert abs(m1[k] - m0[k]) <= 1e-4 * abs(m0[k])
    assert m1["lr"] == m0["lr"] and m1["step"] == m0["step"] == 1
    for k, want in p0.items():
        for a, b in ((o1.mu[k], o0.mu[k]), (o1.nu[k], o0.nu[k])):
            assert ((a.cpu() - b).abs().max()
                    <= 1e-4 * b.abs().max() + 1e-30), k
        g = o0.mu[k].double() / 0.1
        dg = 1e-4 * g.abs().max()
        slack = m0["lr"] * torch.clamp(
            dg / (torch.clamp(g.abs() - dg, min=0.0) + 1e-8), max=2.0)
        d = (p1[k].detach().cpu().double() - want.detach().double()).abs()
        assert (d <= 1e-4 * want.detach().abs().max() + slack).all(), k


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_docs,seq_len", [(0, 4, 2048), (1, 16, 128),
                                                 (2, 40, 256)])
def test_pack_documents_on_card_equals_cpu(cuda_device, seed, n_docs,
                                           seq_len):
    """The packer on the card launches the global-tier kernel once and
    packs the rows the CPU packs, bit for bit."""
    from repro_torch.data import pack_documents

    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 100, size=int(n)).astype(np.int32)
            for n in rng.integers(8, seq_len, size=n_docs)]
    kernel.reset_launch_counts()
    rows, mask = pack_documents(docs, n_docs // 2 + 1, seq_len,
                                device=cuda_device)
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    want = pack_documents(docs, n_docs // 2 + 1, seq_len, device="cpu")
    assert np.array_equal(rows, want[0]) and np.array_equal(mask, want[1])


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A bf16 smoke model and its AdamW state on the card, after one step,
    saved asynchronously and restored into a fresh model: bit for bit."""
    import dataclasses

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.launch import adapters
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              dtype="bfloat16", remat=True)
    tcfg = TrainConfig(warmup_steps=1)

    def fresh(seed):
        m = adapters.init_fn(torch.Generator(device=cuda_device)
                             .manual_seed(seed), cfg)
        return m, adamw.init_state(dict(m.named_parameters()), tcfg)

    live, opt = fresh(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 1, cfg.vocab_size, (2, 32)).astype(np.int32)).to(cuda_device),
             "mask": torch.ones((2, 32), dtype=torch.bool,
                                device=cuda_device)}
    opt, _ = make_train_step(cfg, tcfg)(live, opt, batch)
    ck = Checkpointer(str(tmp_path))
    T.save(ck, 1, live, opt, cfg)
    ck.wait()
    restored, ropt = fresh(1)
    assert T.restore(ck, None, restored, ropt, cfg)["step"] == 1
    assert int(ropt.step) == 1
    for (k, a), b in zip(restored.named_parameters(), live.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b), k
        assert torch.equal(ropt.mu[k], opt.mu[k])
        assert torch.equal(ropt.nu[k], opt.nu[k])


@pytest.mark.cuda
def test_train_defaults_to_the_card(cuda_device):
    """``train`` without a device runs on the card: the packer launches
    the global-tier kernel once a step, and the losses are finite."""
    from repro_torch.launch.train import train

    kernel.reset_launch_counts()
    # at 2048 tokens a row every step's documents have pairs to match
    losses = train("granite-moe-3b-a800m", smoke=True, steps=3,
                   batch_size=2, seq_len=2048, ckpt_dir=None)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 3


# ------------------------------------------------ ssm, hybrid, audio, vlm --
FAMILY_ARCHS = ["mamba2-130m", "zamba2-2.7b", "whisper-large-v3",
                "qwen2-vl-2b"]
FAMILY_TOL = 1e-4


def _family_batch(cfg, seed, b=2, s=32):
    """Tokens, the vlm's image prefix (16 patches, 4x4) and M-RoPE
    positions, the audio frames, made with numpy from ``seed``."""
    from repro_torch.models.vlm import make_mrope_positions

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = make_mrope_positions(
            b, 16 + s, 16, (4, 4)).numpy()
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    want = want.double()
    return float((got.cpu().double() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_and_decode_on_card_equal_cpu(cuda_device, arch):
    """The smoke config in f32, the same weights on the card and on the
    CPU: prefill logits and every cache tensor, then three decode steps
    (the CPU's greedy tokens fed to both), within 1e-4 of each tensor's
    largest magnitude; ``pos`` and ``cur`` equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import adapters

    cfg = get_smoke_config(arch)
    batch = _family_batch(cfg, 0)
    models = {d: adapters.init_fn(torch.Generator().manual_seed(0),
                                  cfg).to(d) for d in ("cpu", cuda_device)}

    def check(runs):
        (l0, c0), (l1, c1) = runs["cpu"], runs[cuda_device]
        assert l1.device.type == "cuda" and _rel(l1, l0) <= FAMILY_TOL
        assert set(c0) == set(c1)
        for k, v in c0.items():
            if k == "cur":
                assert c1[k] == v
            elif v.dtype == torch.int32:
                assert torch.equal(c1[k].cpu(), v), k
            else:
                assert _rel(c1[k], v) <= FAMILY_TOL, k
        return torch.argmax(l0[:, -1:], -1).to(torch.int32)

    with torch.no_grad():
        runs = {d: adapters.prefill_fn(m, {k: v.to(d) for k, v in
                                           batch.items()}, cfg, max_len=56)
                for d, m in models.items()}
        tok = check(runs)
        for _ in range(3):
            runs = {d: adapters.decode_fn(m, runs[d][1], tok.to(d), cfg)
                    for d, m in models.items()}
            tok = check(runs)
