"""The port's first-claim engine against ``repro.core.engine``, bit for bit,
on random tiles with -1 padding, self-loops, duplicates and hubs, and the
plain window tier against the reference's xla twin and Pallas kernel
(interpret mode)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strategies import adversarial_edge_list, random_edge_list

from repro.core import engine as jeng
from repro.core.statespec import StateSpec as JSpec
from repro.graphs import rmat_graph as j_rmat
from repro.graphs.windows import build_window_schedule as j_build

from repro_torch.core import engine as teng
from repro_torch.core.statespec import StateSpec
from repro_torch.kernels.skipper_match import kernel, ref

T = 64
SPECS = ["u8", "legacy_i32"]


def _tiles(seed):
    """[k, T] int32 tiles of a hub/chain/duplicate/self-loop/padding mix
    (canonical, as the schedules deliver them)."""
    if seed % 2:
        e = adversarial_edge_list(seed, n=64, m=3 * T)
    else:
        e = random_edge_list(seed, 48, 3 * T, self_loops=0.1,
                             duplicates=0.2, invalid=0.1)
    u, v = np.asarray(e.u), np.asarray(e.v)
    u, v = np.minimum(u, v), np.maximum(u, v)
    return u.reshape(-1, T), v.reshape(-1, T), e.num_vertices


def _state(seed, n, dtype=np.uint8, frac=0.2):
    rng = np.random.default_rng(1000 + seed)
    return np.where(rng.random(n) < frac, 2, 0).astype(dtype)


def _eq(port, ref_arr):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref_arr))


@pytest.mark.parametrize("seed", range(4))
def test_share_matrix_equal(seed):
    ut, vt, _ = _tiles(seed)
    for u, v in zip(ut, vt):
        valid = (u != v) & (u >= 0)
        _eq(teng.share_matrix(torch.from_numpy(u), torch.from_numpy(v),
                              torch.from_numpy(valid)),
            jeng.share_matrix(jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(valid)))


@pytest.mark.parametrize("method", ["matrix", "sort", "scatter"])
@pytest.mark.parametrize("seed", range(4))
def test_blocked_forms_equal(method, seed):
    ut, vt, n = _tiles(seed)
    rng = np.random.default_rng(seed)
    for u, v in zip(ut, vt):
        valid = (u != v) & (u >= 0)
        tu, tv, tval = map(torch.from_numpy, (u, v, valid))
        ju, jv, jval = map(jnp.asarray, (u, v, valid))
        if method == "matrix":
            tb = teng.blocked_from_matrix(teng.share_matrix(tu, tv, tval))
            jb = jeng.blocked_from_matrix(jeng.share_matrix(ju, jv, jval))
        elif method == "sort":
            tb = teng.blocked_by_claim_sort(tu, tv, tval, n)
            jb = jeng.blocked_by_claim_sort(ju, jv, jval, n)
        else:
            tb = teng.blocked_by_claim_scatter(tu, tv, tval, n)
            jb = jeng.blocked_by_claim_scatter(ju, jv, jval, n)
        for _ in range(3):
            free = valid & (rng.random(T) < 0.7)
            _eq(tb(torch.from_numpy(free)), jb(jnp.asarray(free)))


def test_claim_sort_overflow_raises():
    u = torch.zeros(T, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 key overflow"):
        teng.blocked_by_claim_sort(u, u, u >= 0, 2**31 // T)


@pytest.mark.parametrize("seed", range(3))
def test_first_claim_commit_equal(seed):
    ut, vt, n = _tiles(seed)
    st = _state(seed, n)
    rng = np.random.default_rng(seed)
    for u, v in zip(ut, vt):
        valid = (u != v) & (u >= 0)
        su, sv = st[np.where(valid, u, 0)], st[np.where(valid, v, 0)]
        matched = rng.random(T) < 0.1
        tc = teng.first_claim_commit(
            *map(torch.from_numpy, (su, sv, valid, matched)),
            teng.blocked_by_claim_scatter(*map(torch.from_numpy, (u, v, valid)),
                                          n))
        jc = jeng.first_claim_commit(
            *map(jnp.asarray, (su, sv, valid, matched)),
            jeng.blocked_by_claim_scatter(*map(jnp.asarray, (u, v, valid)), n))
        for a, b in zip(tc, jc):
            _eq(a, b)


@pytest.mark.parametrize("vector_rounds", [0, 1, 3])
@pytest.mark.parametrize("seed", range(3))
def test_rounds_and_fallback_equal(seed, vector_rounds):
    """run_first_claim_rounds, then greedy_fallback_rounds, driven with the
    caller's own gather/scatter as the kernels drive them."""
    ut, vt, n = _tiles(seed)
    for u, v in zip(ut, vt):
        valid = (u != v) & (u >= 0)
        ug, vg = np.where(valid, u, 0), np.where(valid, v, 0)

        t_state = torch.from_numpy(_state(seed, n))
        tu, tv, tval = map(torch.from_numpy, (u, v, valid))
        tb = teng.blocked_from_matrix(teng.share_matrix(tu, tv, tval))

        def t_gather(st):
            return st[torch.from_numpy(ug).long()], st[torch.from_numpy(vg).long()]

        def t_scatter(st, commit):
            st[tu[commit].long()] = 2
            st[tv[commit].long()] = 2
            return st

        tm, tcf = teng.run_first_claim_rounds(
            tu, tv, tval, lambda: t_gather(t_state),
            lambda c: t_scatter(t_state, c), vector_rounds, tb)
        t_out = teng.greedy_fallback_rounds(
            t_state, tu, tv, tval, tm, tb, gather=t_gather, scatter=t_scatter)

        cell = jeng.StateCell(jnp.asarray(_state(seed, n)))
        ju, jv, jval = map(jnp.asarray, (u, v, valid))
        jb = jeng.blocked_from_matrix(jeng.share_matrix(ju, jv, jval))

        def j_gather(st):
            return st[jnp.asarray(ug)], st[jnp.asarray(vg)]

        def j_scatter(st, commit):
            st = st.at[jnp.where(commit, ju, n)].set(2, mode="drop")
            return st.at[jnp.where(commit, jv, n)].set(2, mode="drop")

        def j_apply(c):
            cell[...] = j_scatter(cell[...], c)

        jm, jcf = jeng.run_first_claim_rounds(
            ju, jv, jval, lambda: j_gather(cell[...]), j_apply,
            vector_rounds, jb)
        _eq(tm, jm)
        _eq(tcf, jcf)
        j_out = jeng.greedy_fallback_rounds(
            cell[...], ju, jv, jval, jm, jb, gather=j_gather,
            scatter=j_scatter)
        for a, b in zip(t_out, j_out):
            _eq(a, b)


@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("method", ["auto", "matrix", "sort", "scatter"])
@pytest.mark.parametrize("seed", range(3))
def test_tile_pass_equal(seed, method, fallback):
    ut, vt, n = _tiles(seed)
    t_state = torch.from_numpy(_state(seed, n))
    j_state = jnp.asarray(_state(seed, n))
    for k, (u, v) in enumerate(zip(ut, vt)):
        spec_t = StateSpec.u8() if k % 2 else None
        spec_j = JSpec.u8() if k % 2 else None
        t_out = teng.tile_pass(
            t_state, torch.from_numpy(u), torch.from_numpy(v), n=n,
            vector_rounds=1 + k % 2, fallback=fallback,
            conflict_method=method, spec=spec_t)
        j_out = jeng.tile_pass(
            j_state, jnp.asarray(u), jnp.asarray(v), n=n,
            vector_rounds=1 + k % 2, fallback=fallback,
            conflict_method=method, spec=spec_j)
        j_state = j_out[0]
        assert t_out[2].dtype == (torch.uint8 if spec_t else torch.int32)
        for a, b in zip(t_out, j_out):
            _eq(a, b)


@pytest.mark.parametrize("same_block", [False, True])
@pytest.mark.parametrize("spec", SPECS)
def test_tile_pass_pair_equal(same_block, spec):
    window, num_windows = 32, 4
    rng = np.random.default_rng(11 + same_block)
    dt = np.uint8 if spec == "u8" else np.int32
    rows = _state(3, num_windows * window, dt).reshape(num_windows, window)
    t_rows, j_rows = torch.from_numpy(rows.copy()), jnp.asarray(rows)
    for k in range(4):
        bu = int(rng.integers(0, num_windows))
        bv = bu if same_block else int(rng.integers(bu, num_windows))
        hi = window if bu == bv else 2 * window
        lo_v = 0 if bu == bv else window
        u = rng.integers(0, window, T).astype(np.int32)
        v = rng.integers(lo_v, hi, T).astype(np.int32)
        v[::7] = u[::7] if bu == bv else v[::7]      # self-loops
        u[5::11] = v[5::11] = -1                       # padding
        v[3::13] = v[2::13]                            # hub-ish repeats
        t_out = teng.tile_pass_pair(
            t_rows, torch.from_numpy(u), torch.from_numpy(v), bu, bv,
            window=window, vector_rounds=1 + k % 2,
            spec=getattr(StateSpec, spec)())
        j_out = jeng.tile_pass_pair(
            j_rows, jnp.asarray(u), jnp.asarray(v), bu, bv, window=window,
            vector_rounds=1 + k % 2, spec=getattr(JSpec, spec)())
        j_rows = j_out[0]
        for a, b in zip(t_out, j_out):
            _eq(a, b)


@pytest.fixture(scope="module")
def rmat9_schedule():
    g = j_rmat(9, 4, seed=2)
    return j_build(g, window=128, tile_size=64, reorder="degree")


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_window_tier_pass_equal(rmat9_schedule, reference, spec,
                                vector_rounds):
    s = rmat9_schedule
    kw = dict(window=s.window, tiles_per_window=s.tiles_per_window,
              tile_size=s.tile_size, vector_rounds=vector_rounds)
    j_out = jeng.window_tier_pass(
        jnp.asarray(s.u_tiles), jnp.asarray(s.v_tiles), backend=reference,
        interpret=True, spec=getattr(JSpec, spec)(), **kw)
    t_out = teng.window_tier_pass(
        torch.from_numpy(s.u_tiles), torch.from_numpy(s.v_tiles),
        backend="torch", spec=getattr(StateSpec, spec)(), **kw)
    assert t_out[0].dtype == getattr(StateSpec, spec)().vmem_dtype
    assert t_out[1].dtype == getattr(StateSpec, spec)().counter_dtype
    for a, b in zip(t_out, j_out):
        _eq(a, b)


def test_window_tier_wrapper_on_cpu_is_plain(rmat9_schedule):
    """Given CPU tensors, the kernel wrapper runs the plain version and
    launches nothing."""
    s = rmat9_schedule
    u, v = torch.from_numpy(s.u_tiles), torch.from_numpy(s.v_tiles)
    st0 = torch.zeros((s.num_rows, s.window), dtype=torch.uint8)
    kernel.reset_launch_counts()
    got = kernel.window_tier(u, v, st0, tile_size=s.tile_size)
    want = ref.ref_window_tier(u, v, st0, tile_size=s.tile_size)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kernel.launch_counts() == {kernel.WINDOW_TIER: 0,
                                      kernel.BOUNDARY: 0}


def test_boundary_wrapper_on_cpu_is_plain(rmat9_schedule):
    s = rmat9_schedule
    nb = s.num_boundary_tiles
    assert nb > 0
    args = [torch.from_numpy(a) for a in (
        s.boundary_blk_u, s.boundary_blk_v,
        s.boundary_ulocal.reshape(nb, -1), s.boundary_vlocal.reshape(nb, -1))]
    rows_a = torch.from_numpy(_state(5, s.num_windows * s.window)).reshape(
        s.num_windows, s.window)
    rows_b = rows_a.clone()
    got = kernel.boundary_tier(rows_a, *args)
    want = ref.ref_boundary_pass(rows_b, *args)
    torch.testing.assert_close(rows_a, rows_b, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_window_tier_rejects_bad_inputs():
    u = torch.zeros((1, 64), dtype=torch.int64)
    st0 = torch.zeros((1, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        kernel.window_tier(u, u, st0, tile_size=64)
    u = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of tile_size"):
        kernel.window_tier(u, u, st0, tile_size=48)
    with pytest.raises(ValueError, match="spec.vmem"):
        kernel.window_tier(u, u, st0.int(), tile_size=64)
    with pytest.raises(ValueError, match="tile_size"):
        kernel.window_tier(torch.zeros((1, 2048), dtype=torch.int32),
                           torch.zeros((1, 2048), dtype=torch.int32), st0,
                           tile_size=2048)
