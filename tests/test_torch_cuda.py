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
@pytest.mark.parametrize("tile", [33, 64, 256, 1024])
@pytest.mark.parametrize("case", ["rows", "short_row", "dead_row", "star",
                                  "late_free"])
def test_async_window_tier_equals_plain_and_first_kernel(
        cuda_device, widths, tile, case):
    """skipper_window_async_kernel bit for bit against ref_window_tier and
    skipper_window_tier_kernel: states, matched and conflicts, in each of
    the four (state, counter) widths. Tile 33 puts every row but the first
    off a 16-byte boundary (its ids come by cp.async); at tile 1024 the
    kernel runs 1,024 threads, the most it takes."""
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
@pytest.mark.parametrize("tile", [64, 33])
@pytest.mark.parametrize("case", sorted(GLOBAL_TIER_CASES))
def test_async_global_tier_equals_plain_and_first_kernel(
        cuda_device, spec, instance, tile, case):
    """skipper_boundary_async_kernel, in both instances, bit for bit
    against ref_boundary_pass and skipper_boundary_kernel: matched,
    conflicts and the state rows. Tile 33 makes the ring's bulk copies
    start off a 16-byte boundary (ragged ends by cp.async)."""
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
    any n whose row does not fit shared memory, as at RMAT scale 22."""
    from repro_torch.core.skipper import stream_tiles, tiles_on_card

    g = rmat_graph(12, 8, seed=6)
    s = getattr(StateSpec, spec)()
    n = g.num_vertices
    ut, vt = stream_tiles(g, tile)
    state = torch.zeros(n, dtype=s.at_rest_dtype)
    matched, conflicts = ref.ref_skipper(state, ut, vt, vector_rounds=2)
    kernel.reset_launch_counts()
    got = tiles_on_card(ut.to(cuda_device), vt.to(cuda_device), n,
                        vector_rounds=2, spec=s, instance=instance)
    torch.cuda.synchronize()
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    _same((got[0].cpu(), state), (got[1].cpu(), matched),
          (got[2].cpu(), conflicts))
    assert kernel.boundary_instance(1 << 22, 512) == "device"


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
            "skipper@u8", "skipper@legacy_i32", "sgmm"} <= set(out)
    assert len(out) == 9


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
    """Every template instance of the three kernels and every entry target
    analyzes to no ERROR, and so does src/repro_torch."""
    from repro_torch.analysis import run_analysis

    report = run_analysis()
    assert report.clean, report.render()
    assert len(report.targets_analyzed) == 40


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
