"""The port's LM serving path against the JAX package on the CPU, in f32,
on the smoke configs of granite-moe, mixtral, qwen1.5-0.5b and llama3.2-1b
(the ssm, hybrid, audio and vlm families: ``test_torch_families.py``).

Inputs are made with numpy from a seed; parameters come from the
reference's ``init_fn(PRNGKey(s), cfg)`` and are carried across with
``interop.params_from_arrays``. Tolerance: 5e-5 absolute on f32 outputs
(the two frameworks sum matrix products in other orders; the observed
differences are a few 1e-6). Integer routing outputs and greedy tokens are
compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import adapters as JA
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch import configs
from repro_torch.interop import params_from_arrays
from repro_torch.launch import adapters as TA
from repro_torch.launch import steps as TS
from repro_torch.launch.serve import serve
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.transformer import Transformer

ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b", "qwen1.5-0.5b",
         "llama3.2-1b"]
TOL = 5e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err < tol, err


def carried(arch, seed=1):
    """(reference config, params) and the port's model with those params."""
    cfg = jax_smoke(arch)
    params = JA.init_fn(jax.random.PRNGKey(seed), cfg)
    tcfg = configs.get_smoke_config(arch)
    model = Transformer(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_arrays(
        jax.tree.map(np.asarray, params), tcfg))
    return cfg, params, tcfg, model


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    assert (dataclasses.asdict(configs.get_config(arch))
            == dataclasses.asdict(jax_config(arch)))
    assert (dataclasses.asdict(configs.get_smoke_config(arch))
            == dataclasses.asdict(jax_smoke(arch)))


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen1.5-110b"])
def test_unported_arch_raises(arch):
    """The registry refuses no architecture of the reference's: the two
    that the sharding layer brought in resolve, and only an unknown arch
    raises (``KeyError``)."""
    assert configs.get_config(arch).name == arch
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    with pytest.raises(KeyError):
        configs.get_smoke_config(arch + "-no-such")


# ----------------------------------------------------------------- layers --
def test_norms_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    bias = rng.standard_normal(16).astype(np.float32)
    close(TL.rms_norm(t(x), t(scale)), JL.rms_norm(x, scale))
    close(TL.layer_norm(t(x), t(scale), t(bias)),
          JL.layer_norm(x, scale, bias))
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    for got, want in zip(TL.rope_cos_sin(t(pos), 32, 1e4),
                         JL.rope_cos_sin(jnp.asarray(pos), 32, 1e4)):
        close(got, want)
    q = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    cos, sin = JL.rope_cos_sin(jnp.asarray(pos), 32, 5e5)
    close(TL.apply_rotary(t(q), t(cos), t(sin)), JL.apply_rotary(q, cos, sin))


@pytest.mark.parametrize("s,q_chunk,kv_chunk,causal,window", [
    (64, 16, 32, True, 0),
    (64, 16, 32, True, 24),
    (64, 64, 64, False, 0),
    (48, 32, 32, True, 0),    # 48 % 32: the unchunked fallback on both axes
    (60, 16, 16, True, 20),
])
def test_gqa_attention_chunked(s, q_chunk, kv_chunk, causal, window):
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    close(TL.gqa_attention_chunked(t(q), t(k), t(v), **kw),
          JL.gqa_attention_chunked(q, k, v, **kw))


@pytest.mark.parametrize("window", [0, 6])
def test_gqa_attention_decode_rolling(window):
    """A rolling cache of 8 slots at position 11: slots hold positions
    8..11 and 4..7, one slot is empty."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    pos = np.array([8, 9, 10, 11, 4, 5, -1, 7], np.int32)
    close(TL.gqa_attention_decode(t(q), t(kc), t(vc), t(pos), 11,
                                  window=window),
          JL.gqa_attention_decode(q, kc, vc, jnp.asarray(pos),
                                  jnp.asarray(11), window=window))


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("swiglu", True),
                                      ("gelu", True)])
def test_gated_mlp_and_head(act, bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((16, 24), (16, 24), (24, 16))]
    b = ([rng.standard_normal(n).astype(np.float32) for n in (24, 24, 16)]
         if bias else [None] * 3)
    kw = dict(zip(("b_gate", "b_up", "b_down"), b))
    close(TL.gated_mlp(t(x), *map(t, w), act=act,
                       **{k: None if v is None else t(v)
                          for k, v in kw.items()}),
          JL.gated_mlp(x, *w, act=act, **kw))
    head = rng.standard_normal((16, 40)).astype(np.float32)
    close(TL.lm_head(t(x), t(head)), JL.lm_head(x, head))
    close(TL.lm_head(t(x), t(head.T.copy()), transpose=True),
          JL.lm_head(x, head.T, transpose=True))


def test_dense_init_scale_and_device():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 512), 256, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    assert abs(w.float().std().item() - 256 ** -0.5) < 2e-3


# -------------------------------------------------------------------- moe --
def _moe_case(arch, router, tokens, seed):
    cfg = dataclasses.replace(jax_smoke(arch), moe_router=router)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch),
                               moe_router=router)
    p = JM.init_moe_mlp(jax.random.PRNGKey(seed), cfg)
    x = np.random.default_rng(seed).standard_normal(
        (1, tokens, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, x


@pytest.mark.parametrize("router", ["skipper", "topk"])
@pytest.mark.parametrize("arch,tokens", [("granite-moe-3b-a800m", 96),
                                         ("mixtral-8x7b", 40)])
def test_moe_mlp(router, arch, tokens):
    cfg, tcfg, p, x = _moe_case(arch, router, tokens, 2)
    got = TM.moe_mlp(t(x), {k: t(v) for k, v in p.items()}, tcfg)
    close(got, JM.moe_mlp(jnp.asarray(x), p, cfg))


@pytest.mark.parametrize("router", ["skipper", "topk"])
def test_moe_mlp_two_routing_groups(router):
    """8192 tokens: two groups of GROUP_TOKENS, each with its own
    capacity domain."""
    cfg, tcfg, p, x = _moe_case("granite-moe-3b-a800m", router,
                                2 * TM.GROUP_TOKENS, 3)
    got = TM.moe_mlp(t(x), {k: t(v) for k, v in p.items()}, tcfg)
    close(got, JM.moe_mlp(jnp.asarray(x), p, cfg))


def _tied_scores(seed, n, e):
    """Log-softmax-like scores quantized so that ties are common."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.standard_normal((n, e)) * 2) / 2 - 3).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_skipper_router_bit_identical_on_ties(seed):
    scores = _tied_scores(seed, 200, 8)
    k, cap, kp = 2, 64, 4
    want = JM._route_group_skipper(jnp.asarray(scores), k, cap, kp)
    got = TM.route_group_skipper(t(scores), k, cap, kp)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_router_bit_identical_on_ties(seed):
    scores = _tied_scores(seed + 5, 100, 8)
    want = JM._route_group_topk(jnp.asarray(scores), 3)
    got = TM.route_group_topk(t(scores), 3)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[1], want[1])


def test_slots_are_ranks_within_group_and_expert():
    exp = torch.tensor([[0, 1, 0, 0, 1], [1, 1, 0, 1, 0]], dtype=torch.int32)
    acc = torch.tensor([[1, 1, 0, 1, 1], [1, 0, 1, 1, 1]], dtype=torch.bool)
    slots = TM.slots_of(exp, acc, 2)
    assert slots[acc].tolist() == [0, 0, 1, 1, 0, 0, 1, 1]
    assert TM.capacity_of(4096, configs.get_config("granite-moe-3b-a800m")) \
        == 1024
    assert TM.capacity_of(1, configs.get_config("granite-moe-3b-a800m")) == 8


# ------------------------------------------------------------- transformer --
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """prefill logits and cache, then three decode steps (logits, cache,
    positions). S = 40 exceeds mixtral-smoke's window of 32, so its cache
    is the rolling layout."""
    cfg, params, tcfg, model = carried(arch)
    s, max_len = 40, 48
    tok = np.random.default_rng(4).integers(
        3, cfg.vocab_size, (2, s)).astype(np.int32)
    lj, cj = JA.prefill_fn(params, {"tokens": jnp.asarray(tok)}, cfg,
                           max_len=max_len)
    with torch.no_grad():
        lt, ct = TA.prefill_fn(model, {"tokens": t(tok)}, tcfg,
                               max_len=max_len)
        close(model(t(tok)), lj)
    close(lt, lj)
    for name in ("k", "v"):
        close(ct[name], cj[name])
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    assert ct["cur"] == int(cj["cur"])
    nxt = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
    for _ in range(3):
        lj, cj = JA.decode_fn(params, cj, jnp.asarray(nxt), cfg)
        with torch.no_grad():
            lt, ct = TA.decode_fn(model, ct, t(nxt), tcfg)
        close(lt, lj)
        for name in ("k", "v"):
            close(ct[name], cj[name])
        assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
        assert ct["cur"] == int(cj["cur"])
        nxt = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)


def test_mixtral_rolling_window_cache():
    """mixtral-smoke (window 32) prefilled with 45 tokens keeps positions
    13..44 in slots pos % 32, and decodes past the window."""
    cfg, params, tcfg, model = carried("mixtral-8x7b", seed=3)
    tok = np.random.default_rng(5).integers(
        3, cfg.vocab_size, (1, 45)).astype(np.int32)
    _, cj = JA.prefill_fn(params, {"tokens": jnp.asarray(tok)}, cfg,
                          max_len=64)
    with torch.no_grad():
        _, ct = model.prefill(t(tok), max_len=64)
    pos = ct["pos"].numpy()
    assert ct["k"].shape[2] == 32
    assert np.array_equal(pos, np.asarray(cj["pos"]))
    assert sorted(pos.tolist()) == list(range(13, 45))
    assert all(p % 32 == i for i, p in enumerate(pos))
    close(ct["k"], cj["k"])
    close(ct["v"], cj["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_greedy_tokens_equal_reference(arch):
    cfg, params, tcfg, model = carried(arch, seed=2)
    tok = np.random.default_rng(6).integers(
        3, cfg.vocab_size, (1, 24)).astype(np.int32)
    j_prefill, t_prefill = JS.make_prefill_step(cfg), TS.make_prefill_step(
        tcfg)
    j_step, t_step = JS.make_serve_step(cfg), TS.make_serve_step(tcfg)
    lj, cj = j_prefill(params, {"tokens": jnp.asarray(tok)})
    lt, ct = t_prefill(model, {"tokens": t(tok)})
    close(lt, lj)
    nj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)[:, None]
    nt = torch.argmax(lt[:, -1], -1).to(torch.int32)[:, None]
    assert nt.tolist() == np.asarray(nj).tolist()
    for _ in range(4):
        nj, cj = j_step(params, cj, nj)
        nt, ct = t_step(model, ct, nt)
        assert nt.dtype == torch.int32
        assert nt.tolist() == np.asarray(nj).tolist()


def test_params_from_arrays_rejects_unknown_and_missing_keys():
    cfg = jax_smoke("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray, JA.init_fn(jax.random.PRNGKey(0), cfg))
    tcfg = configs.get_smoke_config("qwen1.5-0.5b")
    state = params_from_arrays(tree, tcfg)
    assert "blocks.1.attn.bq" in state and "lm_head" not in state
    bad = dict(tree, lm_head=tree["embed"].T)
    with pytest.raises(ValueError, match="unknown keys"):
        params_from_arrays(bad, tcfg)
    blocks = dict(tree["blocks"], attn=dict(tree["blocks"]["attn"]))
    del blocks["attn"]["bq"]
    with pytest.raises(ValueError, match="missing keys"):
        params_from_arrays(dict(tree, blocks=blocks), tcfg)
    short = dict(tree["blocks"], norm1=tree["blocks"]["norm1"][:1])
    with pytest.raises(ValueError, match="num_layers"):
        params_from_arrays(dict(tree, blocks=short), tcfg)


# ------------------------------------------------------------------ serve --
def test_serve_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve("granite-moe-3b-a800m", True, 2, 1, 8, 2, device=device)


def test_serve_on_cpu_is_seeded_and_fills_every_request():
    kw = dict(num_requests=5, slots=2, prompt_len=12, max_new=3,
              device="cpu")
    out1, stats = serve("granite-moe-3b-a800m", True, **kw)
    out2, _ = serve("granite-moe-3b-a800m", True, **kw)
    assert out1 == out2
    assert sorted(out1) == list(range(5))
    assert all(1 <= len(v) <= 3 for v in out1.values())
    assert stats["decoded"] == sum(len(v) for v in out1.values())
    assert len(stats["prefill_s"]) == 5


def test_unported_family_raises():
    """An unknown family raises what the reference's adapters raise: a
    ``KeyError`` from the family lookups of ``init_fn``, ``decode_fn`` and
    ``init_cache_fn``."""
    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-1b"),
                              family="no-such-family")
    with pytest.raises(KeyError):
        TA.init_fn(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(KeyError):
        JA.init_fn(jax.random.PRNGKey(0), cfg)
    model = TA.init_fn(torch.Generator().manual_seed(0),
                       configs.get_smoke_config("llama3.2-1b"))
    with pytest.raises(KeyError):
        TA.decode_fn(model, {}, None, cfg)
    model.cfg = cfg
    with pytest.raises(KeyError):
        TA.init_cache_fn(model, 1, 8)


@pytest.mark.parametrize("arch,max_len", [("mixtral-8x7b", 48),
                                          ("llama3.2-1b", 20)])
def test_init_cache_matches_reference(arch, max_len):
    """An empty cache: window-sized for sliding-window archs, every slot
    empty, position 0."""
    cfg, _params, tcfg, model = carried(arch)
    want = JA.init_cache_fn(cfg, 3, max_len)
    got = TA.init_cache_fn(model, 3, max_len)
    for name in ("k", "v", "pos"):
        assert tuple(got[name].shape) == want[name].shape
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    assert got["cur"] == int(want["cur"])
