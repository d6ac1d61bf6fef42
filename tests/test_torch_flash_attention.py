"""The port's flash attention entry point on the CPU (its plain
online-softmax path) against the JAX package's ``flash_attention`` (Pallas,
interpret mode) and ``ref_attention``, on the same numpy-seeded inputs.

Tolerances are the JAX package's own (``tests/test_kernels.py``): 2e-5 in
f32 (the two frameworks sum in other orders), 2e-2 in bf16 against the f32
oracle (bf16 output rounding), 1e-4 against the model's chunked attention.
The CUDA kernels are held against the same plain path on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here the three-term TF32
kernel's arithmetic, emulated with ``ref.split_tf32``, is held against the
JAX package's kernel at the same 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import ref_attention as jax_ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    kernel,
    online_softmax_attention,
    ref_attention,
)
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import kv_range
from repro_torch.models.layers import gqa_attention_chunked

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (2, 4, 2, 256, 64),
    (1, 8, 1, 256, 128),
    (2, 4, 4, 128, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep(dtype, b, hq, hkv, s, d, causal):
    tol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = both(inputs(b * 17 + s, b, hq, hkv, s, d),
                                      dtype)
    got = flash_attention(tq, tk, tv, causal=causal, block_q=64, block_k=64,
                          device="cpu")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    oracle = f32(jax_ref(jq, jk, jv, causal=causal))
    assert np.abs(f32(got) - oracle).max() < tol
    if dtype == "float32":
        assert np.abs(f32(got) - f32(want)).max() < tol
    else:
        # bf16 rounds at other places in the two frameworks: each within the
        # oracle's tolerance, so within twice it of each other
        assert np.abs(f32(got) - f32(want)).max() < 2 * tol


@pytest.mark.parametrize("window", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sliding_window(window, causal):
    """Causal windows trim ``lo``; a non-causal window masks without
    trimming, so rows meet wholly masked chunks first (the -1e30 sentinel's
    p = 1 until a real score wipes it)."""
    (jq, jk, jv), (tq, tk, tv) = both(inputs(window, 1, 4, 2, 512, 64),
                                      "float32")
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          block_q=64, block_k=64, device="cpu").numpy()
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64))
    oracle = np.asarray(jax_ref(jq, jk, jv, causal=causal, window=window))
    assert np.abs(got - want).max() < 2e-5
    assert np.abs(got - oracle).max() < 2e-5


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32),
                                           (False, 48)])
def test_ref_attention_matches_reference(causal, window):
    (jq, jk, jv), (tq, tk, tv) = both(inputs(5, 2, 6, 3, 128, 80), "float32")
    got = ref_attention(tq, tk, tv, causal=causal, window=window).numpy()
    want = np.asarray(jax_ref(jq, jk, jv, causal=causal, window=window))
    assert np.abs(got - want).max() < 2e-5


def test_flash_attention_matches_model_attention():
    """The entry point against the port's chunked model attention, in the
    model's [B, S, H, D] layout."""
    rng = np.random.default_rng(3)
    b, hq, hkv, s, d = 2, 8, 2, 256, 64
    q = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    model_out = gqa_attention_chunked(q, k, v, causal=True, q_chunk=128,
                                      kv_chunk=64)
    kern_out = flash_attention(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)), causal=True,
        block_q=64, block_k=64, device="cpu").transpose(1, 2)
    assert (model_out - kern_out).abs().max().item() < 1e-4


def test_kv_range_trimming():
    """hi trims to the causal frontier whenever causal is set; lo trims to
    the window only when causal and window are both set."""
    assert kv_range(3, 64, 64, 512, True, 0) == range(0, 4)
    assert kv_range(3, 64, 64, 512, False, 0) == range(0, 8)
    assert kv_range(3, 64, 64, 512, True, 64) == range(2, 4)
    assert kv_range(3, 64, 64, 512, False, 64) == range(0, 8)
    assert kv_range(0, 128, 64, 512, True, 0) == range(0, 2)
    assert kv_range(7, 64, 128, 512, True, 100) == range(2, 4)


def test_online_twin_is_the_cpu_path_and_launches_nothing():
    _, (tq, tk, tv) = both(inputs(9, 1, 4, 2, 128, 64), "float32")
    kernel.reset_launch_counts()
    got = flash_attention(tq, tk, tv, window=32, block_q=32, block_k=64,
                          device="cpu")
    want = online_softmax_attention(tq, tk, tv, block_q=32, block_k=64,
                                    window=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not any(kernel.launch_counts().values())


@pytest.mark.parametrize("shape,kw,match", [
    ((1, 2, 128, 32), {}, "head dim"),
    ((1, 2, 200, 64), {}, "not a multiple of the blocks"),
    ((1, 2, 256, 64), {"block_k": 96}, "not a multiple of the blocks"),
    ((1, 3, 128, 64), {"hkv": 2}, "not a multiple of 2 kv"),
])
def test_unsupported_shapes_raise(shape, kw, match):
    kw = dict(kw)
    hkv = kw.pop("hkv", 1)
    q = torch.zeros(shape)
    k = torch.zeros((shape[0], hkv) + shape[2:])
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k, device="cpu", **kw)


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros((1, 2, 64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, q, q, device="cuda")


def test_shared_memory_budget():
    """The kernel's layout at the default blocks fits one block for every
    supported head dim."""
    for d in kernel.HEAD_DIMS:
        assert kernel.smem_bytes(d, 128, 128) <= kernel.MAX_SMEM_BYTES
    assert kernel.smem_bytes(64, 128, 128) == 4 * (2 * 128 * 68 + 128 * 129)


def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``device=None`` means the card, as for ``skipper_match`` and
    ``serve``: without one it raises, CPU tensors or not; ``device="cpu"``
    runs the plain version and launches nothing."""
    _, (tq, tk, tv) = both(inputs(11, 1, 2, 1, 64, 64), "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(tq, tk, tv)
    kernel.reset_launch_counts()
    got = flash_attention(tq, tk, tv, device="cpu")
    want = online_softmax_attention(tq, tk, tv, block_q=64, block_k=64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not any(kernel.launch_counts().values())


@pytest.mark.parametrize("dtype,d,name", [
    (torch.bfloat16, 64, kernel.FLASH_WGMMA),
    (torch.bfloat16, 128, kernel.FLASH_WGMMA),
    (torch.bfloat16, 80, kernel.FLASH_TF32),
    (torch.float32, 64, kernel.FLASH_TF32),
    (torch.float32, 80, kernel.FLASH_TF32),
    (torch.float32, 128, kernel.FLASH_TF32),
])
def test_kernel_dispatch_by_dtype_and_head_dim(dtype, d, name):
    """bf16 at head dim 64 or 128 goes to the bf16 tensor-core kernel; f32
    at every head dim and bf16 at D = 80 (rows padded to 96 floats) go to
    the three-term TF32 kernel. No dispatch reaches the CUDA-core
    kernel."""
    assert kernel.kernel_for(dtype, d) == name
    assert kernel.kernel_for(dtype, d) != kernel.FLASH


def test_tensor_core_kernel_shared_memory():
    """The Q tile, three stages of a K and a V chunk of 64 rows, seven
    mbarriers and 1 KB of alignment: independent of S, within one block's
    shared memory."""
    assert kernel.wgmma_smem_bytes(64) == 2 * 64 * (128 + 6 * 64) + 56 + 1024
    assert kernel.wgmma_smem_bytes(128) == (2 * 128 * (128 + 6 * 64) + 56
                                            + 1024)
    assert all(kernel.wgmma_smem_bytes(d) <= kernel.MAX_SMEM_BYTES
               for d in kernel.WGMMA_HEAD_DIMS)


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers just above |x| (0 at 0), in f32."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0,
                       torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                   e - 8))


def tensor_core_arithmetic(q, k, v, *, causal, p_terms, block_q=128,
                           block_k=64):
    """The tensor-core kernel's arithmetic in plain PyTorch: f32 scores of
    the bf16 tiles scaled in f32, the online softmax in f32, and each
    chunk's P V with P as the sum of ``p_terms`` bf16 terms (P_1 = bf16(P),
    P_2 = bf16(P - P_1), ...), added to the f32 accumulator as
    ``acc * alpha + pv``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    for qi in range(s // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        q_pos = torch.arange(qi * block_q, (qi + 1) * block_q)[:, None]
        m = torch.full((b, hq, block_q), -1e30)
        l = torch.zeros((b, hq, block_q))
        acc = torch.zeros((b, hq, block_q, d))
        for j in kv_range(qi, block_q, block_k, s, causal, 0):
            cols = slice(j * block_k, (j + 1) * block_k)
            sc = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(),
                              kk[:, :, cols]) * d ** -0.5
            if causal:
                kv_pos = torch.arange(j * block_k, (j + 1) * block_k)[None]
                sc = torch.where(kv_pos <= q_pos, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            p_mma, rest = torch.zeros_like(p), p
            for _ in range(p_terms):
                term = rest.to(torch.bfloat16).float()
                p_mma, rest = p_mma + term, rest - term
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p_mma, vv[:, :, cols])
            m = m_new
        out[:, :, rows] = (acc / torch.where(l > 0, l, 1.0)[..., None]).to(
            q.dtype)
    return out


@pytest.mark.parametrize("block", [32, 64, 128])
def test_p_in_three_bf16_terms_keeps_one_bf16_step(block):
    """Why the tensor-core kernel splits P: at granite's attention widths
    (Hq 24, Hkv 8, D 64, S 1024, causal, bf16), P as three bf16 terms keeps
    every output element within one bf16 step (+1e-6) of the plain version
    at each block size, the criterion chip_smoke.py holds the kernel to; P
    rounded once to bf16 does not. (Two terms pass at this size; on the
    card they miss a few elements at prefill_32k and at mixtral's window,
    where a row's few terms cancel.)"""
    _, (tq, tk, tv) = both(inputs(1024, 1, 24, 8, 1024, 64), "bfloat16")
    plain = online_softmax_attention(tq, tk, tv, block_q=block,
                                     block_k=block, causal=True)
    allowed = bf16_step(plain) + 1e-6

    def within(p_terms):
        got = tensor_core_arithmetic(tq, tk, tv, causal=True,
                                     p_terms=p_terms)
        return bool(((got.float() - plain.float()).abs() <= allowed).all())

    assert within(kernel.P_TERMS)
    assert not within(1)


# ------------------------------------------------ three TF32 terms ------

def numpy_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 in numpy: round the f32 magnitude to 10 stored
    mantissa bits, ties away from zero."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    out = ((bits + 0x1000) & ~np.uint64(0x1FFF)) & np.uint64(0xFFFFFFFF)
    return out.astype(np.uint32).view(np.float32)


def test_split_tf32_is_bit_exact():
    """``ref.split_tf32`` rounds as cvt.rna.tf32 does, bit for bit against a
    numpy rounding (ties and a subnormal included): ``hi`` keeps no bit in
    the low 13, and ``hi + lo`` is within ``2^-22 |x|`` of a normal
    ``x``."""
    rng = np.random.default_rng(16)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
            -6, 6, 4096),
        # exact ties: the 13 dropped bits are 0x1000
        (np.arange(1, 257, dtype=np.uint32) << 13 | 0x1000).view(np.float32)
        * np.float32(1.0),
        -np.float32([1.0, 0.5, 3.0e-39, 1.5]),
    ]).astype(np.float32)
    hi, lo = ref.split_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  numpy_tf32(x).view(np.uint32))
    np.testing.assert_array_equal(
        lo.numpy().view(np.uint32),
        numpy_tf32(x - numpy_tf32(x)).view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    # the relative bound holds for normal numbers (a subnormal has fewer
    # bits to keep; it is held bit for bit above)
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    resid = np.abs(x.astype(np.float64) - hi.numpy().astype(np.float64)
                   - lo.numpy().astype(np.float64))
    assert normal.sum() > 4000
    assert (resid[normal] <= 2.0 ** -22
            * np.abs(x[normal].astype(np.float64))).all()


def tf32x3_arithmetic(q, k, v, *, causal, window, drop=None):
    """The three-term kernel's arithmetic in plain PyTorch on its own tile
    (``kernel.TF32_GEOMETRY``): Q * scale, K, V and each chunk's P split by
    ``ref.split_tf32``; S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T and PV =
    P_hi V_hi + P_hi V_lo + P_lo V_hi (products of TF32 values are exact in
    f32); the mask, the online softmax and ``acc * alpha + pv`` as the
    plain version. ``drop`` leaves out the ``"hi_lo"`` or the ``"lo_hi"``
    term of both products."""
    b, hq, s, d = q.shape
    consumers, bk = kernel.TF32_GEOMETRY[d][:2]
    rows = 64 * consumers
    group = hq // k.shape[1]
    qh, ql = ref.split_tf32(q.float() * d ** -0.5)
    kh, kl = (t.repeat_interleave(group, 1) for t in ref.split_tf32(k))
    vh, vl = (t.repeat_interleave(group, 1) for t in ref.split_tf32(v))

    def prod(eq, ah, al, bh, bl):
        out = torch.einsum(eq, ah, bh)
        if drop != "hi_lo":
            out = out + torch.einsum(eq, ah, bl)
        if drop != "lo_hi":
            out = out + torch.einsum(eq, al, bh)
        return out

    out = torch.empty_like(q)
    for qi in range(s // rows):
        r = slice(qi * rows, (qi + 1) * rows)
        q_pos = torch.arange(qi * rows, (qi + 1) * rows)[:, None]
        m = torch.full((b, hq, rows), ref.NEG_INF)
        l = torch.zeros((b, hq, rows))
        acc = torch.zeros((b, hq, rows, d))
        for j in kv_range(qi, rows, bk, s, causal, window):
            c = slice(j * bk, (j + 1) * bk)
            sc = prod("bhqd,bhkd->bhqk", qh[:, :, r], ql[:, :, r],
                      kh[:, :, c], kl[:, :, c])
            kv_pos = torch.arange(j * bk, (j + 1) * bk)[None]
            mask = torch.ones((rows, bk), dtype=torch.bool)
            if causal:
                mask &= kv_pos <= q_pos
            if window > 0:
                mask &= kv_pos > q_pos - window
            sc = torch.where(mask, sc, ref.NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            ph, pl = ref.split_tf32(p)
            acc = acc * alpha[..., None] + prod(
                "bhqk,bhkd->bhqd", ph, pl, vh[:, :, c], vl[:, :, c])
            m = m_new
        out[:, :, r] = (acc / torch.where(l > 0, l, 1.0)[..., None]).to(
            q.dtype)
    return out


TF32_CASES = [(True, 0), (False, 0), (True, 64), (False, 48)]


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("causal,window", TF32_CASES)
def test_three_tf32_terms_hold_f32_tolerance(d, causal, window):
    """The three-term arithmetic stays within 2e-5 of the JAX package's
    kernel (Pallas, interpret mode) and of the port's plain version, on the
    numpy-seeded randn inputs the other tests use, at every head dim the
    kernel takes: causal, full and windowed."""
    (jq, jk, jv), (tq, tk, tv) = both(inputs(d + window, 1, 4, 2, 256, d),
                                      "float32")
    got = tf32x3_arithmetic(tq, tk, tv, causal=causal, window=window).numpy()
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64))
    plain = online_softmax_attention(tq, tk, tv, block_q=64, block_k=64,
                                     causal=causal, window=window).numpy()
    assert np.abs(got - want).max() < 2e-5
    assert np.abs(got - plain).max() < 2e-5


@pytest.mark.parametrize("drop", ["hi_lo", "lo_hi"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_two_tf32_terms_miss_f32_tolerance(drop, d):
    """Why three terms: leaving out either cross term of both products
    (``a_hi b_lo`` or ``a_lo b_hi``) misses 2e-5 on the same inputs."""
    (jq, jk, jv), (tq, tk, tv) = both(inputs(d, 1, 4, 2, 256, d), "float32")
    got = tf32x3_arithmetic(tq, tk, tv, causal=True, window=0,
                            drop=drop).numpy()
    want = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=64,
                                block_k=64))
    assert np.abs(got - want).max() > 2e-5


def test_tf32_planes_layout():
    """The pre-pass's planes: Q * scale and K split and zero-padded to
    whole 32-float columns (D = 80 -> 96), V split and transposed with the
    keys of each group of 8 in the order 0 2 4 6 1 3 5 7; hi + lo gives
    back the f32 values; bf16 input has no K or V lo plane."""
    _, (tq, tk, tv) = both(inputs(7, 1, 4, 2, 64, 80), "float32")
    planes = ref.tf32_planes(tq, tk, tv, 80 ** -0.5)
    assert planes["q_hi"].shape == (4, 64, 96)
    assert planes["k_lo"].shape == (2, 64, 96)
    assert planes["v_hi"].shape == (2, 80, 64)
    assert not planes["q_hi"][..., 80:].any()
    assert not planes["k_lo"][..., 80:].any()
    torch.testing.assert_close(planes["k_hi"][..., :80] + planes["k_lo"][
        ..., :80], tk.reshape(2, 64, 80), rtol=2.0 ** -22, atol=0)
    order = ref.vt_key_order(64)
    assert order[:8].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    v = planes["v_hi"] + planes["v_lo"]
    torch.testing.assert_close(v[:, :, torch.argsort(order)],
                               tv.reshape(2, 64, 80).transpose(1, 2),
                               rtol=2.0 ** -22, atol=0)
    half = ref.tf32_planes(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                           80 ** -0.5)
    assert half["k_lo"] is None and half["v_lo"] is None
    assert not ref.split_tf32(tk.bfloat16())[1].any()


@pytest.mark.parametrize("d", [64, 80, 128])
def test_tf32_kernel_shared_memory(d):
    """The three-term kernel's block: two Q planes of 64 rows a consumer
    warpgroup, two stages of K_hi, K_lo (BK x Dp) and V^T_hi, V^T_lo (D x
    BK), five mbarriers and 1 KB of alignment; independent of S and within
    one block's shared memory at every head dim."""
    consumers, bk, stages = kernel.TF32_GEOMETRY[d][:3]
    dp = ref.padded_dim(d)
    want = (4 * (2 * 64 * consumers * dp + stages * 2 * bk * (dp + d))
            + 8 * (1 + 2 * stages) + 1024)
    assert kernel.tf32_smem_bytes(d) == want <= kernel.MAX_SMEM_BYTES
    assert {64: 197_672, 80: 189_480, 128: 197_672}[d] == want
