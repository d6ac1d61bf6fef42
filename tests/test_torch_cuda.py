"""The CUDA kernels against their plain PyTorch versions on the card: the
matcher's bit for bit, flash attention within the stated tolerances; and
the serving path on the card. Marked ``cuda``: each test skips without a
card. This file imports no jax, so it runs on a machine that has only
PyTorch:

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


# ------------------------------------------------------- flash attention --
# Tolerances as in chip_smoke.py: f32 2e-5 (sums in other orders), bf16
# 2e-2 (each side rounds one f32 result to bf16).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,blk", [
    (2, 4, 2, 256, 64, True, 0, 64),
    (1, 8, 1, 256, 128, False, 0, 128),
    (1, 6, 3, 384, 80, True, 100, 128),
    (1, 4, 2, 256, 64, False, 48, 32),
])
def test_flash_kernel_equal_plain(cuda_device, dtype, b, hq, hkv, s, d,
                                  causal, window, blk):
    from repro_torch.kernels.flash_attention import (
        flash_attention, online_softmax_attention)

    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    got = flash_attention(q, k, v, causal=causal, window=window, block_q=blk,
                          block_k=blk)
    want = online_softmax_attention(q, k, v, block_q=blk, block_k=blk,
                                    causal=causal, window=window)
    torch.cuda.synchronize()
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
    flash_attention(q.cpu(), q.cpu(), q.cpu())
    assert flash.launch_counts() == {flash.FLASH: 1}
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    odd = torch.randn((1, 2, 12, 64), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash_attention(t, q, q)
    assert flash.launch_counts() == {flash.FLASH: 1}


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
    assert len(report.targets_analyzed) == 17


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
