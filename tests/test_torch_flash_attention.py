"""The port's flash attention entry point on the CPU (its plain
online-softmax path) against the JAX package's ``flash_attention`` (Pallas,
interpret mode) and ``ref_attention``, on the same numpy-seeded inputs.

Tolerances are the JAX package's own (``tests/test_kernels.py``): 2e-5 in
f32 (the two frameworks sum in other orders), 2e-2 in bf16 against the f32
oracle (bf16 output rounding), 1e-4 against the model's chunked attention.
The CUDA kernel is held against the same plain path on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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
    got = flash_attention(tq, tk, tv, causal=causal, block_q=64, block_k=64)
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
                          block_q=64, block_k=64).numpy()
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
        block_q=64, block_k=64).transpose(1, 2)
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
    got = flash_attention(tq, tk, tv, window=32, block_q=32, block_k=64)
    want = online_softmax_attention(tq, tk, tv, block_q=32, block_k=64,
                                    window=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernel.launch_counts() == {kernel.FLASH: 0}


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
        flash_attention(q, k, k, **kw)


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
