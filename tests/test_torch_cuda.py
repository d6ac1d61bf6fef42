"""The CUDA kernels against their plain PyTorch versions on the card, bit
for bit. Marked ``cuda``: each test skips without a card. This file
imports no jax, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
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
    assert all(n == 1 for n in kernel.launch_counts().values())
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
    want = skipper_match_window(u, v, st0, 128)
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
