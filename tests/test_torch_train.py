"""The port's training path (``repro_torch.launch.{adapters,steps,train}``,
``Transformer.forward(return_hidden=True)`` and its remat) on the CPU
against the JAX package's, in f32, on the smoke configs of llama3.2-1b
(dense, tied head) and granite-moe (MoE, Skipper router, untied head).

Inputs are made with numpy from a seed; the reference's parameters are
carried across with ``interop.params_from_arrays`` and the port's results
brought back with ``interop.arrays_from_params``. Tolerances, relative to
each leaf's largest magnitude (the two frameworks sum matrix products in
other orders; the observed differences are a few 1e-7 to 1e-6): the loss
1e-5; hidden states, gradients and AdamW moments 1e-4. The parameters
after one step: 1e-4, plus what a gradient error of 1e-4 (of its leaf's
largest gradient) can move the first AdamW update ``lr * g / (|g| +
1e-8)``: that update divides each gradient by its own magnitude, so an
element whose gradient cancels to near zero carries its rounding into the
update (measured: 2e-3 of ``lr`` on a norm scale of llama's smoke config).
The end-to-end case (the port resumed from a checkpoint the reference
wrote) holds the next two losses within 1e-4. One case runs 4 bf16 steps
at the reference's default learning rate, as the full-width configs
train, and holds each step's loss and grad norm within 1e-2 (its
docstring says why).
"""
import dataclasses
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import adapters as JA
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.optim import adamw as JO
from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.interop import arrays_from_params, params_from_arrays
from repro_torch.launch import adapters as TA
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models import moe as TM
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m"]
TCFG = dict(total_steps=10, warmup_steps=2)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tree_err(got, want) -> dict:
    """The relative error of each leaf of two pytrees of one structure."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): rel_err(a, b)
            for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree.leaves(want))}


def assert_tree_close(got, want, tol):
    errs = tree_err(got, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert max(errs.values()) <= tol, errs


def batch_np(seed, vocab, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    mask = rng.random((b, s)) > 0.2
    mask[0, :3] = False
    return {"tokens": tokens, "mask": mask}


def port_model(arch, params, **replace):
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    model = Transformer(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_arrays(
        jax.tree.map(np.asarray, params), tcfg))
    return tcfg, model


@functools.lru_cache(maxsize=None)
def reference(arch, microbatches=1):
    """The reference's parameters, batch, loss and gradients, and its
    train step's outputs, on ``arch``'s smoke config."""
    cfg = jax_smoke(arch)
    jtc = JTrainConfig(microbatches=microbatches, **TCFG)
    params = JA.init_fn(jax.random.PRNGKey(1), cfg)
    b = 2 * microbatches
    batch = batch_np(7, cfg.vocab_size, b=b)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(JS.make_loss_fn(cfg, jtc)))(
        params, jb)
    new_p, st, metrics = jax.jit(JS.make_train_step(cfg, jtc))(
        params, JO.init_state(params, jtc), jb)
    np_ = functools.partial(jax.tree.map, np.asarray)
    return dict(cfg=cfg, params=params, batch=batch, loss=float(loss),
                grads=np_(grads), new_params=np_(new_p), mu=np_(st.mu),
                nu=np_(st.nu), step=int(st.step),
                metrics={k: float(v) for k, v in metrics.items()})


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def port_grads(model, tcfg, batch):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = TS.make_loss_fn(tcfg, TrainConfig(**TCFG))(model, tbatch(batch))
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), arrays_from_params(dict(zip(named, grads)),
                                                 tcfg)


# -------------------------------------------------------------- forward ----
@pytest.mark.parametrize("arch", ARCHS)
def test_train_hidden_equals_reference(arch):
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    with torch.no_grad():
        h, head, tr, targets, mask = TA.train_hidden(
            model, tbatch(ref["batch"]), tcfg)
    jh, jhead, jtr, jt_, jm = JA.train_hidden(
        ref["params"], {k: jnp.asarray(v) for k, v in ref["batch"].items()},
        ref["cfg"])
    assert tr is jtr is False
    assert rel_err(h.numpy(), jh) <= 1e-4
    assert np.array_equal(head.detach().numpy(), np.asarray(jhead))
    assert np.array_equal(targets.numpy(), np.asarray(jt_))
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    # the logits path is the hidden path's head projection
    with torch.no_grad():
        logits = model(t(ref["batch"]["tokens"]))
    assert torch.equal(logits, h @ head)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_ndims_equal_the_reference_tree(arch):
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    ndims = model.reference_ndims()
    got = arrays_from_params(
        {k: torch.zeros([1] * (n - k.startswith("blocks.")))
         for k, n in ndims.items()}, tcfg, placeholders=True)
    assert (jax.tree.map(np.ndim, got)
            == jax.tree.map(np.ndim, ref["params"]))
    assert ndims["blocks.0.norm1"] == 2 and ndims["final_norm"] == 1


# --------------------------------------------------------- cross-entropy ----
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (60, 16), (48, 48)])
def test_chunked_ce_equals_reference(s, chunk, tied, z_loss):
    """``chunked_ce`` and ``cross_entropy``: value, and gradients in the
    hidden states and the head, against ``jax.value_and_grad``; a tied
    head is ``[V, D]`` read transposed. S=60 is not a multiple of the
    chunk: one chunk of the whole sequence."""
    rng = np.random.default_rng(s + chunk + 2 * tied)
    b, d, v = 2, 16, 40
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((v, d) if tied else (d, v)) * 0.3).astype(
        np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) > 0.3
    mask[1] = False                          # a row with no loss at all

    def jloss(h, w):
        return JS.chunked_ce(h, w, tied, targets, mask, z_loss, chunk)

    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(h, w)
    th, tw = t(h).requires_grad_(), t(w).requires_grad_()
    tl = TS.chunked_ce(th, tw, tied, t(targets), t(mask), z_loss, chunk)
    gh, gw = torch.autograd.grad(tl, (th, tw))
    tl = tl.detach()
    assert rel_err(float(tl), float(jl)) <= 1e-5
    assert rel_err(gh.numpy(), jgh) <= 1e-4
    assert rel_err(gw.numpy(), jgw) <= 1e-4
    # the full logits' cross-entropy
    from repro.models import layers as JL

    def jfull(h, w):
        return JS.cross_entropy(JL.lm_head(h, w, transpose=tied), targets,
                                mask, z_loss)

    fl, (fgh, fgw) = jax.value_and_grad(jfull, argnums=(0, 1))(h, w)
    logits = th @ (tw.T if tied else tw)
    tf = TS.cross_entropy(logits, t(targets), t(mask), z_loss)
    gh2, gw2 = torch.autograd.grad(tf, (th, tw))
    tf = tf.detach()
    assert rel_err(float(tf), float(fl)) <= 1e-5
    assert rel_err(gh2.numpy(), fgh) <= 1e-4
    assert rel_err(gw2.numpy(), fgw) <= 1e-4
    assert rel_err(float(tl), float(tf)) <= 1e-5


def test_chunked_ce_checkpoints_each_chunk(monkeypatch):
    """With grad enabled each chunk's head projection runs under a
    checkpoint (one call a chunk, recomputed in backward); without grad
    none does."""
    calls = []
    real = TS.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(TS, "checkpoint", counting)
    h = torch.randn(1, 64, 8, requires_grad=True)
    w = torch.randn(8, 20)
    tg = torch.zeros(1, 64, dtype=torch.int32)
    m = torch.ones(1, 64, dtype=torch.bool)
    TS.chunked_ce(h, w, False, tg, m, chunk=16).backward()
    assert calls == ["_chunk_ce"] * 4
    with torch.no_grad():
        TS.chunked_ce(h, w, False, tg, m, chunk=16)
    assert len(calls) == 4


# ----------------------------------------------------- loss and gradients ----
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_reference(arch):
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    loss, grads = port_grads(model, tcfg, ref["batch"])
    assert rel_err(loss, ref["loss"]) <= 1e-5
    assert_tree_close(grads, ref["grads"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    """``remat=True`` (each block under ``torch.utils.checkpoint``, through
    ``dataclasses.replace``) gives the gradients of ``remat=False``, and
    both those of the reference."""
    ref = reference(arch)
    got = {}
    for remat in (False, True):
        tcfg, model = port_model(arch, ref["params"], remat=remat)
        got[remat] = port_grads(model, tcfg, ref["batch"])
    assert got[True][0] == got[False][0]
    assert_tree_close(got[True][1], got[False][1], 1e-6)
    assert_tree_close(got[True][1], ref["grads"], 1e-4)


def test_remat_recomputes_the_same_routing(monkeypatch):
    """Under remat, backward recomputes each MoE block: the router's
    b-matching runs twice a layer, and the recompute accepts exactly the
    candidates the forward accepted."""
    ref = reference("granite-moe-3b-a800m")
    tcfg, model = port_model("granite-moe-3b-a800m", ref["params"],
                             remat=True)
    calls = []
    real = TM.bmatch_assign

    def recording(tok, exp, **kw):
        acc = real(tok, exp, **kw)
        calls.append((tok.clone(), exp.clone(), acc.clone()))
        return acc

    monkeypatch.setattr(TM, "bmatch_assign", recording)
    port_grads(model, tcfg, ref["batch"])
    n = tcfg.num_layers
    assert len(calls) == 2 * n
    # forward: layers 0..n-1; backward recomputes them from the last
    for i in range(n):
        fwd, bwd = calls[i], calls[2 * n - 1 - i]
        assert all(torch.equal(a, b) for a, b in zip(fwd, bwd))


# ----------------------------------------------------------- train step ----
def assert_step_close(opt, model, tcfg, ref, lr):
    assert_tree_close(arrays_from_params(opt.mu, tcfg), ref["mu"], 1e-4)
    assert_tree_close(arrays_from_params(opt.nu, tcfg), ref["nu"], 1e-4)
    got = arrays_from_params(dict(model.named_parameters()), tcfg)
    for (path, a), b, g in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree.leaves(ref["new_params"]),
                               jax.tree.leaves(ref["grads"])):
        dg = 1e-4 * np.abs(g).max()
        slack = lr * np.minimum(2.0, dg / (np.maximum(np.abs(g) - dg, 0.0)
                                           + 1e-8))
        bound = 1e-4 * np.abs(b).max() + slack
        assert (np.abs(a - b) <= bound).all(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch):
    ref = reference(arch)
    tcfg, model = port_model(arch, ref["params"])
    tc = TrainConfig(**TCFG)
    opt = adamw.init_state(dict(model.named_parameters()), tc)
    opt, metrics = TS.make_train_step(tcfg, tc)(model, opt,
                                                tbatch(ref["batch"]))
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    assert int(metrics["step"]) == ref["step"] == 1
    assert metrics["step"].dtype == torch.int32
    m = {k: float(v) for k, v in metrics.items()}
    assert rel_err(m["loss"], ref["metrics"]["loss"]) <= 1e-5
    assert rel_err(m["lr"], ref["metrics"]["lr"]) <= 1e-6
    assert rel_err(m["grad_norm"], ref["metrics"]["grad_norm"]) <= 1e-4
    assert_step_close(opt, model, tcfg, ref, m["lr"])


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_equal_reference(arch):
    """``microbatches=2`` against the reference's: the gradients of two
    half batches accumulated in f32 and halved."""
    ref = reference(arch, microbatches=2)
    tcfg, model = port_model(arch, ref["params"])
    tc = TrainConfig(microbatches=2, **TCFG)
    opt = adamw.init_state(dict(model.named_parameters()), tc)
    opt, metrics = TS.make_train_step(tcfg, tc)(model, opt,
                                                tbatch(ref["batch"]))
    m = {k: float(v) for k, v in metrics.items()}
    assert rel_err(m["loss"], ref["metrics"]["loss"]) <= 1e-5
    assert rel_err(m["grad_norm"], ref["metrics"]["grad_norm"]) <= 1e-4
    assert_step_close(opt, model, tcfg, ref, m["lr"])


#: 4 bf16 steps: the losses and grad norms within 1e-2 relative
BF16_STEPS, BF16_TOL = 4, 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_steps_equal_reference_at_default_lr(arch):
    """The smoke config in bf16 with remat, as the full-width configs run,
    for 4 steps of the ``TrainConfig`` that ``train`` builds for 4 steps
    (the reference's default learning rate, 3e-4 after one warmup step)
    on the train path's packed batches: the port's loss and grad norm at
    each step within 1e-2 relative of the reference's. bf16 keeps 8 bits
    (a step of 3.9e-3); the packages round other sums, a near-tied token
    may route to another expert, and each update, a few bf16 steps of its
    weight, rounds either way, so the two runs part by about a bf16 step
    over 4 steps (measured: 2.4e-3 on the loss, 4.1e-3 on the grad
    norm)."""
    tc = TT.train_config(BF16_STEPS)
    jtc = JTrainConfig(total_steps=BF16_STEPS, warmup_steps=1,
                       checkpoint_every=50)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jtc)
    cfg = dataclasses.replace(jax_smoke(arch), dtype="bfloat16", remat=True)
    params = JA.init_fn(jax.random.PRNGKey(tc.seed), cfg)
    tcfg, model = port_model(arch, params, dtype="bfloat16", remat=True)
    assert next(model.parameters()).dtype == torch.bfloat16
    jstep = jax.jit(JS.make_train_step(cfg, jtc))
    tstep = TS.make_train_step(tcfg, tc)
    state = JO.init_state(params, jtc)
    opt = adamw.init_state(dict(model.named_parameters()), tc)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      batch_per_host=2)
    runs = []
    for step in range(BF16_STEPS):
        tokens, mask = batch_for_step(step, dcfg, device="cpu")
        params, state, jm = jstep(params, state, {
            "tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)})
        opt, tm = tstep(model, opt, {"tokens": t(tokens), "mask": t(mask)})
        runs.append({k: (float(tm[k]), float(jm[k]))
                     for k in ("loss", "grad_norm", "lr")})
    print(arch, "bf16 (port, reference):", runs)
    for r in runs:
        assert rel_err(*r["lr"]) <= 1e-6, runs
        assert rel_err(*r["loss"]) <= BF16_TOL, runs
        assert rel_err(*r["grad_norm"]) <= BF16_TOL, runs
    assert runs[0]["lr"][1] == pytest.approx(jtc.learning_rate)


# ------------------------------------------------------------ end to end ----
@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's ``train`` on llama3.2-1b's smoke config for 6 steps,
    checkpointing at step 4."""
    a = tmp_path_factory.mktemp("reference")
    losses = JT.train("llama3.2-1b", smoke=True, steps=6, batch_size=2,
                      seq_len=64, ckpt_dir=str(a), checkpoint_every=4)
    return a, losses


def test_resumed_from_a_reference_checkpoint(reference_run, tmp_path):
    """The port's ``train`` resumed from the reference's step-4 checkpoint
    reproduces the reference's losses of steps 4 and 5."""
    a, losses = reference_run
    assert len(losses) == 6
    shutil.copytree(a / "step_00000004", tmp_path / "step_00000004")
    got = TT.train("llama3.2-1b", smoke=True, steps=6, batch_size=2,
                   seq_len=64, ckpt_dir=str(tmp_path), checkpoint_every=4,
                   device="cpu")
    assert len(got) == 2
    for g, w in zip(got, losses[4:6]):
        assert rel_err(g, w) <= 1e-4, (got, losses[4:6])
    assert (tmp_path / "step_00000006" / "opt_state.npz").exists()


def test_train_takes_the_learning_rate():
    """``train(learning_rate=)`` (the CLI's ``--lr``) reaches the step: the
    first loss is the same at every rate, the second differs; the default
    is the reference's."""
    kw = dict(smoke=True, steps=2, batch_size=2, seq_len=32, ckpt_dir=None,
              device="cpu")
    default = TT.train("llama3.2-1b", **kw)
    low = TT.train("llama3.2-1b", learning_rate=1e-4, **kw)
    frozen = TT.train("llama3.2-1b", learning_rate=0.0, **kw)
    assert default[0] == low[0] == frozen[0]
    assert len({default[1], low[1], frozen[1]}) == 3
    assert TT.train_config(2).learning_rate == JTrainConfig().learning_rate


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device: train"):
        TT.train("llama3.2-1b", smoke=True, steps=1, batch_size=2,
                 seq_len=32, ckpt_dir=None)


@pytest.mark.parametrize("entry", ["train_hidden", "prefill_fn",
                                   "build_batch"])
def test_unported_families_raise(entry):
    """An unknown family: ``train_hidden`` and ``prefill_fn`` raise the
    reference's ``ValueError(family)``; ``build_batch`` does not reject a
    family, as the reference's does not (tokens and mask only)."""
    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-1b"),
                              family="no-such-family")
    jcfg = dataclasses.replace(jax_smoke("llama3.2-1b"),
                               family="no-such-family")
    if entry == "build_batch":
        kw = dict(vocab_size=cfg.vocab_size, seq_len=32, batch_per_host=2)
        got = TT.build_batch(cfg, DataConfig(**kw), 0, "cpu")
        from repro.data import DataConfig as JDataConfig
        want = JT.build_batch(jcfg, JDataConfig(**kw), 0)
        assert set(got) == set(want) == {"tokens", "mask"}
        return
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "mask": torch.ones((1, 4), dtype=torch.bool)}
    with pytest.raises(ValueError, match="no-such-family"):
        getattr(TA, entry)(None, batch, cfg)
    with pytest.raises(ValueError, match="no-such-family"):
        getattr(JA, entry)(None, {k: jnp.asarray(v.numpy())
                                  for k, v in batch.items()}, jcfg)


# ------------------------------------ the reference's test_system.py ----
def test_train_loss_decreases():
    losses = TT.train("qwen1.5-0.5b", smoke=True, steps=20, batch_size=4,
                      seq_len=64, ckpt_dir=None, microbatches=1,
                      device="cpu")
    assert len(losses) == 20
    assert losses[-1] < losses[0], losses[:3] + losses[-3:]


def test_train_checkpoint_restart(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(smoke=True, batch_size=2, seq_len=64, ckpt_dir=ckpt,
              checkpoint_every=5, device="cpu")
    l1 = TT.train("llama3.2-1b", steps=10, **kw)
    assert len(l1) == 10
    # a restart resumes from step 10 and runs nothing more
    assert TT.train("llama3.2-1b", steps=10, **kw) == []
    # extended to 14 steps from the checkpoint
    assert len(TT.train("llama3.2-1b", steps=14, **kw)) == 4


def test_train_with_microbatches():
    losses = TT.train("granite-moe-3b-a800m", smoke=True, steps=4,
                      batch_size=4, seq_len=64, ckpt_dir=None,
                      microbatches=2, device="cpu")
    assert len(losses) == 4
    assert np.isfinite(losses).all()


def test_train_lm_example_runs_on_the_cpu():
    """``examples/train_lm_torch.py`` for 3 steps at a reduced size."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--device", "cpu", "--steps", "3", "--layers", "1", "--batch", "2",
         "--seq", "32"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[example] loss:" in proc.stdout
