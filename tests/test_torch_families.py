"""The port's ``ssm``, ``hybrid``, ``audio`` (encoder-decoder) and ``vlm``
families against the JAX package on the CPU, in f32, on the smoke configs
of mamba2-130m, zamba2-2.7b, whisper-large-v3 and qwen2-vl-2b.

Inputs are made with numpy from a seed. Parameters come from the
reference's ``init_fn(PRNGKey(s), cfg)`` with N(0, 0.05) noise added to
every leaf (so that zero-initialised norms, biases, ``A_log`` and
``dt_bias`` take part), and are carried across with
``interop.params_from_arrays``. Tolerances: 5e-5 absolute on f32 outputs,
as ``test_torch_models.py`` (the two frameworks sum matrix products in
other orders; the observed differences are a few 1e-6); the training
path's as ``test_torch_train.py``, relative to each leaf's largest
magnitude: the loss 1e-5, hidden states, gradients and moments 1e-4.
Integer outputs (greedy tokens, ``pos``, ``cur``, M-RoPE positions) are
compared exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jax_smoke
from repro.data import DataConfig as JDataConfig
from repro.launch import adapters as JA
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.models import encdec as JE
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.models import vlm as JV
from repro.optim import adamw as JO
from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.data import DataConfig
from repro_torch.interop import (
    BF16Bits,
    arrays_from_params,
    params_from_arrays,
)
from repro_torch.launch import adapters as TA
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.launch.serve import serve
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TSSM
from repro_torch.models import vlm as TV
from repro_torch.optim import adamw

ARCHS = ["mamba2-130m", "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-2b"]
TOL = 5e-5
TCFG = dict(total_steps=10, warmup_steps=2)
#: the vlm inputs: an image prefix of 16 patches on a 4x4 grid
N_IMG, GRID = 16, (4, 4)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err < tol, err


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_tree_close(got, want, tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    errs = {"/".join(str(getattr(k, "key", k)) for k in path): rel_err(a, b)
            for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree.leaves(want))}
    assert max(errs.values()) <= tol, errs


def perturbed(params, seed):
    """The reference's parameters plus N(0, 0.05) noise on every leaf."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(p.shape),
                    p.dtype) for p in leaves])


def carried(arch, seed=1, **replace):
    """(reference config, params) and the port's config and model with
    those params."""
    cfg = dataclasses.replace(jax_smoke(arch), **replace)
    params = perturbed(JA.init_fn(jax.random.PRNGKey(seed), cfg), seed)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    model = TA.init_fn(torch.Generator().manual_seed(0), tcfg)
    model.load_state_dict(params_from_arrays(
        jax.tree.map(np.asarray, params), tcfg))
    return cfg, params, tcfg, model


def batch_np(cfg, seed, b=2, s=32, mask=True):
    """A numpy batch of ``cfg``'s family: tokens (and a loss mask), the vlm
    image prefix and its M-RoPE positions, the audio frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if mask:
        m = rng.random((b, s)) > 0.2
        m[0, :3] = False
        batch["mask"] = m
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, N_IMG, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = np.array(JV.make_mrope_positions(
            b, N_IMG + s, N_IMG, GRID))
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def port_forward(model, tcfg, batch):
    b = tbatch(batch)
    with torch.no_grad():
        if tcfg.family == "vlm":
            return TV.forward(model, b["tokens"], b["image_embeds"],
                              b["mrope_positions"])
        if tcfg.family == "audio":
            return model(b["tokens"], b["frames"])
        return model(b["tokens"])


def ref_forward(params, cfg, batch):
    b = jbatch(batch)
    if cfg.family == "vlm":
        return JV.forward(params, b["tokens"], b["image_embeds"],
                          b["mrope_positions"], cfg)
    if cfg.family == "audio":
        return JE.forward(params, b["tokens"], b["frames"], cfg)
    mod = {"ssm": JSSM, "hybrid": JH}[cfg.family]
    return mod.forward(params, b["tokens"], cfg)


def assert_cache_equal(got, want):
    """Every cache tensor within TOL (floats) or equal (integers); ``cur``
    a Python int equal to the reference's."""
    assert set(got) == set(want)
    for name, w in want.items():
        if name == "cur":
            assert isinstance(got["cur"], int) and got["cur"] == int(w)
        elif np.issubdtype(np.asarray(w).dtype, np.integer):
            assert got[name].dtype == torch.int32
            assert np.array_equal(got[name].numpy(), np.asarray(w)), name
        else:
            close(got[name], w)


# ----------------------------------------------------------------- layers --
@pytest.mark.parametrize("head_dim,theta,sections", [
    (16, 1e4, (2, 3, 3)), (128, 1e6, (16, 24, 24))])
def test_mrope_cos_sin(head_dim, theta, sections):
    pos = np.random.default_rng(head_dim).integers(
        0, 3000, (3, 2, 9)).astype(np.int32)
    for got, want in zip(TL.mrope_cos_sin(t(pos), head_dim, theta, sections),
                         JL.mrope_cos_sin(jnp.asarray(pos), head_dim, theta,
                                          sections)):
        close(got, want, 1e-6)
    with pytest.raises(ValueError, match="sections"):
        TL.mrope_cos_sin(t(pos), head_dim, theta, sections[:2])


@pytest.mark.parametrize("batch,seq,n_img,grid", [
    (2, 40, 16, (4, 4)), (1, 1536, 1024, (32, 32)), (3, 12, 6, (2, 3)),
    (1, 10, 6, (3, 2)), (2, 4, 4, (2, 2))])
def test_make_mrope_positions(batch, seq, n_img, grid):
    got = TV.make_mrope_positions(batch, seq, n_img, grid)
    want = np.asarray(JV.make_mrope_positions(batch, seq, n_img, grid))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_make_mrope_positions_rejects_a_bad_grid():
    with pytest.raises(ValueError, match="grid"):
        TV.make_mrope_positions(1, 20, 16, (4, 5))


@pytest.mark.parametrize("length,channels", [(1500, 1280), (32, 64), (7, 6)])
def test_sinusoids(length, channels):
    got = TE.sinusoids(length, channels)
    assert got.dtype == np.float32
    assert np.array_equal(got, JE.sinusoids(length, channels))


@pytest.mark.parametrize("s,width", [(24, 4), (5, 4), (16, 2)])
def test_causal_conv(s, width):
    rng = np.random.default_rng(s + width)
    xbc = rng.standard_normal((2, s, 40)).astype(np.float32)
    w = rng.standard_normal((width, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    close(TSSM._causal_conv(t(xbc), t(w), t(b)),
          JSSM._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                            jnp.asarray(b)))


def ssd_inputs(s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((2, s, h)), 0).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((2, s, n)).astype(np.float32)
    cm = rng.standard_normal((2, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk,h,p,n", [
    (64, 16, 4, 8, 16),      # four chunks
    (32, 32, 2, 16, 8),      # S == chunk
    (12, 16, 3, 4, 8),       # S < chunk: one chunk of S
    (128, 64, 8, 16, 32),
    (48, 16, 2, 8, 4),
])
def test_ssd_scan(s, chunk, h, p, n):
    args = ssd_inputs(s, h, p, n, s + chunk + h)
    got = TSSM.ssd_scan(*map(t, args), chunk)
    want = JSSM.ssd_scan(*map(jnp.asarray, args), chunk)
    # the outputs reach |y| ~ 30: 5e-5 of their largest magnitude
    assert rel_err(got.numpy(), want) <= 5e-5


def test_ssd_scan_rejects_a_ragged_sequence():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TSSM.ssd_scan(*map(t, ssd_inputs(40, 2, 4, 4, 0)), 16)


def ssm_layer(seed):
    cfg = jax_smoke("mamba2-130m")
    p = perturbed(JSSM.init_ssm_layer(jax.random.PRNGKey(seed), cfg), seed)
    return cfg, configs.get_smoke_config("mamba2-130m"), p, {
        k: t(v) for k, v in p.items()}


def test_ssm_layer_train():
    cfg, tcfg, p, tp = ssm_layer(3)
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    close(TSSM.ssm_layer_train(t(x), tp, tcfg),
          JSSM.ssm_layer_train(jnp.asarray(x), p, cfg))


def test_ssm_layer_decode():
    """Three tokens from a random conv window and SSM state: the block's
    output and both states, updated in place, at every step."""
    cfg, tcfg, p, tp = ssm_layer(4)
    rng = np.random.default_rng(4)
    _, h, n, conv_ch = TSSM.ssm_dims(tcfg)
    conv = rng.standard_normal((2, cfg.ssm_conv_width - 1, conv_ch)).astype(
        np.float32)
    state = rng.standard_normal((2, h, cfg.ssm_headdim, n)).astype(
        np.float32)
    tconv, tstate = t(conv), t(state)
    jconv, jstate = jnp.asarray(conv), jnp.asarray(state)
    for _ in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        got = TSSM.ssm_layer_decode(t(x), tp, tconv, tstate, tcfg)
        want, jconv, jstate = JSSM.ssm_layer_decode(
            jnp.asarray(x), p, jconv, jstate, cfg)
        close(got, want)
        close(tconv, jconv)
        close(tstate, jstate)


def test_softplus_is_exact_above_twenty():
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 40.0, 90.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    assert np.array_equal(TSSM.softplus(x).numpy(), want)


# ---------------------------------------------------------------- families --
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, params, tcfg, model = carried(arch)
    batch = batch_np(cfg, 2, mask=False)
    close(port_forward(model, tcfg, batch), ref_forward(params, cfg, batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """prefill logits and the whole cache (the zeroed ssm/hybrid caches and
    the empty encoder-decoder self-attention cache among them), then three
    ``decode_fn`` steps with their logits and caches."""
    cfg, params, tcfg, model = carried(arch, seed=2)
    batch = batch_np(cfg, 4, mask=False)
    max_len = batch["tokens"].shape[1] + (N_IMG if cfg.family == "vlm"
                                          else 0) + 8
    lj, cj = JA.prefill_fn(params, jbatch(batch), cfg, max_len=max_len)
    with torch.no_grad():
        lt, ct = TA.prefill_fn(model, tbatch(batch), tcfg, max_len=max_len)
    close(lt, lj)
    assert_cache_equal(ct, cj)
    nxt = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
    for _ in range(3):
        lj, cj = JA.decode_fn(params, cj, jnp.asarray(nxt), cfg)
        with torch.no_grad():
            lt, ct = TA.decode_fn(model, ct, t(nxt), tcfg)
        close(lt, lj)
        assert_cache_equal(ct, cj)
        nxt = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_serve_steps_greedy_tokens_equal_reference(arch):
    cfg, params, tcfg, model = carried(arch, seed=5)
    tok = np.random.default_rng(6).integers(
        3, cfg.vocab_size, (1, 32)).astype(np.int32)
    lj, cj = JS.make_prefill_step(cfg)(params, {"tokens": jnp.asarray(tok)})
    lt, ct = TS.make_prefill_step(tcfg)(model, {"tokens": t(tok)})
    close(lt, lj)
    nj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)[:, None]
    nt = torch.argmax(lt[:, -1], -1).to(torch.int32)[:, None]
    assert nt.tolist() == np.asarray(nj).tolist()
    j_step, t_step = JS.make_serve_step(cfg), TS.make_serve_step(tcfg)
    for _ in range(5):
        nj, cj = j_step(params, cj, nj)
        nt, ct = t_step(model, ct, nt)
        assert nt.dtype == torch.int32
        assert nt.tolist() == np.asarray(nj).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, _params, tcfg, model = carried(arch)
    want = JA.init_cache_fn(cfg, 3, 20)
    got = TA.init_cache_fn(model, 3, 20)
    assert set(got) == set(want)
    for name, w in want.items():
        if name == "cur":
            assert got["cur"] == int(w) == 0
            continue
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        assert np.array_equal(got[name].numpy(), np.asarray(w)), name


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssd_decode_matches_train_forward(arch):
    """The reference's ``test_ssd_decode_matches_train_forward``, restated
    on the port (and on the hybrid family too): token-by-token recurrent
    decode from an empty cache reproduces the chunked forward's logits
    within 2e-2, the reference's bound."""
    cfg = configs.get_smoke_config(arch)
    model = TA.init_fn(torch.Generator().manual_seed(1), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, 32)).astype(np.int32))
    with torch.no_grad():
        train_logits = model(tokens)
        cache = model.init_cache(1, 32)
        outs = []
        for i in range(32):
            logits, cache = model.decode_step(cache, tokens[:, i:i + 1])
            outs.append(logits[:, 0])
    err = float((torch.stack(outs, 1) - train_logits).abs().max())
    assert err < 2e-2, err


# ----------------------------------------------------------------- interop --
@pytest.mark.parametrize("arch", ARCHS)
def test_arrays_from_params_inverts_params_from_arrays(arch):
    cfg, params, tcfg, model = carried(arch)
    tree = jax.tree.map(np.asarray, params)
    back = arrays_from_params(params_from_arrays(tree, tcfg), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    named = dict(model.named_parameters())
    like = arrays_from_params(named, tcfg, placeholders=True)
    assert (jax.tree.map(np.shape, like) == jax.tree.map(np.shape, tree))
    got = arrays_from_params(named, tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def _stacked_leaf(arch):
    """(path to a stacked leaf, the config field its dims come from)."""
    return {"mamba2-130m": (("blocks", "conv_w"), "num_layers"),
            "zamba2-2.7b": (("ssm_blocks", "in_proj"), "shared_attn_period"),
            "whisper-large-v3": (("enc_blocks", "ln2", "bias"),
                                 "encoder_layers"),
            "qwen2-vl-2b": (("blocks", "attn", "bq"), "num_layers")}[arch]


def _replace(tree, path, value):
    if len(path) == 1:
        return dict(tree, **{path[0]: value})
    return dict(tree, **{path[0]: _replace(tree[path[0]], path[1:], value)})


def _delete(tree, path):
    if len(path) == 1:
        return {k: v for k, v in tree.items() if k != path[0]}
    return dict(tree, **{path[0]: _delete(tree[path[0]], path[1:])})


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_arrays_rejects_bad_trees(arch):
    cfg, params, tcfg, model = carried(arch)
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="unknown keys"):
        params_from_arrays(dict(tree, bogus=tree["embed"]), tcfg)
    path, field = _stacked_leaf(arch)
    with pytest.raises(ValueError, match="missing keys"):
        params_from_arrays(_delete(tree, path), tcfg)
    leaf = functools.reduce(lambda n, k: n[k], path, tree)
    flat = leaf.reshape((-1,) + leaf.shape[2:]) if arch == "zamba2-2.7b" \
        else leaf[:1]
    with pytest.raises(ValueError, match=field):
        params_from_arrays(_replace(tree, path, flat), tcfg)
    state = {k: v.detach() for k, v in model.named_parameters()}
    del state[next(iter(state))]
    with pytest.raises(ValueError, match="missing keys"):
        arrays_from_params(state, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_ndims_equal_the_reference_tree(arch):
    """``reference_ndims`` gives each parameter its leaf's rank in the
    reference's tree: +2 for a hybrid ``ssm_blocks`` leaf, +1 for a
    ``blocks``/``enc_blocks``/``dec_blocks`` leaf, +0 for ``shared``,
    ``pos_embed``, ``enc_ln`` and the rest."""
    cfg, params, tcfg, model = carried(arch)
    ndims = model.reference_ndims()
    extra = {"blocks": 1, "ssm_blocks": 2, "enc_blocks": 1, "dec_blocks": 1}
    for k, p in model.named_parameters():
        path = [part for part in k.split(".") if not part.isdigit()]
        leaf = functools.reduce(lambda n, key: n[key], path, params)
        assert ndims[k] == leaf.ndim == p.dim() + extra.get(path[0], 0), k


# ---------------------------------------------------------------- training --
@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's parameters, batch, loss and gradients, and its
    train step's outputs, on ``arch``'s smoke config."""
    cfg = jax_smoke(arch)
    jtc = JTrainConfig(**TCFG)
    params = perturbed(JA.init_fn(jax.random.PRNGKey(1), cfg), 1)
    batch = batch_np(cfg, 7)
    jb = jbatch(batch)
    loss, grads = jax.jit(jax.value_and_grad(JS.make_loss_fn(cfg, jtc)))(
        params, jb)
    new_p, st, metrics = jax.jit(JS.make_train_step(cfg, jtc))(
        params, JO.init_state(params, jtc), jb)
    np_ = functools.partial(jax.tree.map, np.asarray)
    return dict(cfg=cfg, params=params, batch=batch, loss=float(loss),
                grads=np_(grads), new_params=np_(new_p), mu=np_(st.mu),
                nu=np_(st.nu), step=int(st.step),
                metrics={k: float(v) for k, v in metrics.items()})


def port_model(arch, params, **replace):
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    model = TA.init_fn(torch.Generator().manual_seed(0), tcfg)
    model.load_state_dict(params_from_arrays(
        jax.tree.map(np.asarray, params), tcfg))
    return tcfg, model


def port_grads(model, tcfg, batch):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = TS.make_loss_fn(tcfg, TrainConfig(**TCFG))(model, tbatch(batch))
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), arrays_from_params(dict(zip(named, grads)),
                                                 tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_hidden_equals_reference(arch):
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    with torch.no_grad():
        h, head, tr, targets, mask = TA.train_hidden(
            model, tbatch(ref["batch"]), tcfg)
    jh, jhead, jtr, jt_, jm = JA.train_hidden(
        ref["params"], jbatch(ref["batch"]), ref["cfg"])
    assert tr is jtr is (arch == "whisper-large-v3")
    assert rel_err(h.numpy(), jh) <= 1e-4
    assert np.array_equal(head.detach().numpy(), np.asarray(jhead))
    assert np.array_equal(targets.numpy(), np.asarray(jt_))
    assert np.array_equal(mask.numpy(), np.asarray(jm))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_reference(arch):
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    loss, grads = port_grads(model, tcfg, ref["batch"])
    assert rel_err(loss, ref["loss"]) <= 1e-5
    assert_tree_close(grads, ref["grads"], 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_remat_equals_no_remat(arch):
    """``remat=True`` (blocks under ``torch.utils.checkpoint``; hybrid's
    groups too, nested) gives the gradients of ``remat=False``."""
    ref = reference(arch)
    got = {}
    for remat in (False, True):
        tcfg, model = port_model(arch, ref["params"], remat=remat)
        got[remat] = port_grads(model, tcfg, ref["batch"])
    assert got[True][0] == got[False][0]
    assert_tree_close(got[True][1], got[False][1], 1e-6)
    assert_tree_close(got[True][1], ref["grads"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch):
    """One AdamW step: metrics, both moments and the parameters, the
    parameters within 1e-4 plus what a gradient error of 1e-4 moves the
    first update ``lr * g / (|g| + 1e-8)`` (as ``test_torch_train.py``)."""
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    tc = TrainConfig(**TCFG)
    opt = adamw.init_state(dict(model.named_parameters()), tc)
    opt, metrics = TS.make_train_step(tcfg, tc)(model, opt,
                                                tbatch(ref["batch"]))
    m = {k: float(v) for k, v in metrics.items()}
    assert int(metrics["step"]) == ref["step"] == 1
    assert rel_err(m["loss"], ref["metrics"]["loss"]) <= 1e-5
    assert rel_err(m["lr"], ref["metrics"]["lr"]) <= 1e-6
    assert rel_err(m["grad_norm"], ref["metrics"]["grad_norm"]) <= 1e-4
    assert_tree_close(arrays_from_params(opt.mu, tcfg), ref["mu"], 1e-4)
    assert_tree_close(arrays_from_params(opt.nu, tcfg), ref["nu"], 1e-4)
    got = arrays_from_params(dict(model.named_parameters()), tcfg)
    for (path, a), b, g in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree.leaves(ref["new_params"]),
                               jax.tree.leaves(ref["grads"])):
        dg = 1e-4 * np.abs(g).max()
        slack = m["lr"] * np.minimum(2.0, dg / (np.maximum(
            np.abs(g) - dg, 0.0) + 1e-8))
        assert (np.abs(a - b) <= 1e-4 * np.abs(b).max() + slack).all(), path


def test_vlm_microbatches_slice_the_position_streams():
    """``microbatches=2`` on the vlm family: each half batch takes its
    half of the ``[3, B, S]`` M-RoPE streams (axis 1), as the reference's
    scan slices them; loss and grad norm equal the reference's."""
    arch = "qwen2-vl-2b"
    cfg = jax_smoke(arch)
    jtc = JTrainConfig(microbatches=2, **TCFG)
    params = perturbed(JA.init_fn(jax.random.PRNGKey(3), cfg), 3)
    batch = batch_np(cfg, 8, b=4)
    batch["mrope_positions"][:, 2:] += 5     # the halves' streams differ
    _, _, jm = jax.jit(JS.make_train_step(cfg, jtc))(
        params, JO.init_state(params, jtc), jbatch(batch))
    tcfg, model = port_model(arch, params)
    tc = TrainConfig(microbatches=2, **TCFG)
    opt = adamw.init_state(dict(model.named_parameters()), tc)
    _, tm = TS.make_train_step(tcfg, tc)(model, opt, tbatch(batch))
    assert rel_err(float(tm["loss"]), float(jm["loss"])) <= 1e-5
    assert rel_err(float(tm["grad_norm"]), float(jm["grad_norm"])) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-large-v3"])
def test_build_batch_equals_reference(arch):
    """The vlm image prefix and M-RoPE positions, and the audio frames,
    drawn from ``default_rng(step)`` as the reference draws them; the
    packed tokens and mask as the reference packs them."""
    cfg = configs.get_smoke_config(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=64, batch_per_host=2)
    for step in (0, 3):
        got = TT.build_batch(cfg, DataConfig(**kw), step, "cpu")
        want = JT.build_batch(jax_smoke(arch), JDataConfig(**kw), step)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == {"tokens": torch.int32,
                                    "mask": torch.bool,
                                    "mrope_positions": torch.int32}.get(
                                        k, torch.float32), k
            assert np.array_equal(got[k].numpy(), np.asarray(w)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_each_family_on_the_cpu(arch):
    """``launch.train.train`` on the smoke config: 3 finite losses."""
    losses = TT.train(arch, smoke=True, steps=3, batch_size=2, seq_len=32,
                      ckpt_dir=None, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()


# ------------------------------------------------------------------- serve --
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_serve_on_cpu_is_seeded_and_fills_every_request(arch):
    kw = dict(num_requests=3, slots=2, prompt_len=16, max_new=3,
              device="cpu")
    out1, stats = serve(arch, True, **kw)
    out2, _ = serve(arch, True, **kw)
    assert out1 == out2 and sorted(out1) == [0, 1, 2]
    assert all(1 <= len(v) <= 3 for v in out1.values())
    assert stats["decoded"] == sum(len(v) for v in out1.values())


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b"])
def test_serve_refuses_the_vlm_and_audio_families(arch):
    with pytest.raises(ValueError, match="decoder-only"):
        serve(arch, True, 1, 1, 8, 2, device="cpu")


def test_bf16_leaves_cross_as_bits():
    """A bf16 hybrid's f32 leaves (``A_log``, ``D_skip``, ``dt_bias``)
    stay f32 and its bf16 leaves cross as bits."""
    tcfg = dataclasses.replace(configs.get_smoke_config("zamba2-2.7b"),
                               dtype="bfloat16")
    model = TA.init_fn(torch.Generator().manual_seed(0), tcfg)
    tree = arrays_from_params(dict(model.named_parameters()), tcfg)
    assert isinstance(tree["ssm_blocks"]["in_proj"], BF16Bits)
    assert tree["ssm_blocks"]["A_log"].dtype == np.float32
    assert tree["ssm_blocks"]["in_proj"].shape[:2] == (2, 2)
    state = params_from_arrays(tree, tcfg)
    for k, p in model.named_parameters():
        assert state[k].dtype == p.dtype and torch.equal(state[k], p), k
