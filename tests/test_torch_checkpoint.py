"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU, in the
JAX package's on-disk format: the reference's six ``test_checkpoint.py``
cases restated, and files passed between the two packages in both
directions (the parameters of a smoke model and its AdamW state), each
restored bit for bit. The optimizer's keys are read from a file the
reference writes, not guessed."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import adapters as JA
from repro.optim import adamw as J
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import TrainConfig
from repro_torch.interop import (
    BF16Bits,
    arrays_from_params,
    bf16_bits,
    bits_of,
    params_from_arrays,
    torch_from_bits,
)
from repro_torch.launch import adapters as TA
from repro_torch.launch import train as T
from repro_torch.optim import adamw


#: dense, MoE, and the hybrid's ``[n_apps, period]`` and unstacked leaves
ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m", "zamba2-2.7b"]


def tree():
    return {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "nested": {"b": bits_of(torch.ones((2, 2), dtype=torch.bfloat16))},
    }


def bits_equal(a, b):
    """Equal values, dtypes and bit patterns (bf16 as its bits)."""
    a = np.asarray(a.view(np.ndarray) if isinstance(a, BF16Bits) else a)
    if getattr(b, "dtype", None) is not None and b.dtype.name == "bfloat16":
        b = np.asarray(b).view(np.uint16)
    b = np.asarray(b.view(np.ndarray) if isinstance(b, BF16Bits) else b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        return all(trees_equal(a[k], b[k]) for k in a)
    return bits_equal(a, b)


# ----------------------------------- the reference's test_checkpoint.py ----
def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = tree()
    ck.save(5, t, metadata={"loss": 1.5})
    restored, _, meta = ck.restore(None, t)
    assert meta["step"] == 5 and meta["loss"] == 1.5
    np.testing.assert_array_equal(restored["a"], t["a"])
    assert isinstance(restored["nested"]["b"], BF16Bits)
    assert torch_from_bits(restored["nested"]["b"]).dtype == torch.bfloat16
    assert trees_equal(restored, t)


def test_resume_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    for s in (10, 20, 30):
        ck.save(s, tree())
    assert ck.latest_step() == 30


def test_gc_keeps_last_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, tree())
    assert ck.all_steps() == [3, 4]


def test_digest_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = tree()
    ck.save(1, t)
    d = os.path.join(str(tmp_path), "step_00000001")
    data = dict(np.load(os.path.join(d, "params.npz")))
    data["a"] = data["a"] + 1.0
    np.savez(os.path.join(d, "params.npz"), **data)
    with pytest.raises(IOError):
        ck.restore(1, t)


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, tree())
    bad = {"a": np.zeros((2, 2), np.float32),
           "nested": {"b": bf16_bits(np.zeros((2, 2)))}}
    with pytest.raises((ValueError, IOError)):
        ck.restore(1, bad)


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(7, tree())
    ck.wait()
    assert ck.latest_step() == 7


def test_failed_async_save_raises_at_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    shutil.rmtree(str(tmp_path))
    open(str(tmp_path), "w").close()      # the directory is now a file
    ck.save(1, tree())
    with pytest.raises(OSError):
        ck.wait()


# --------------------------------------------------- across the packages ----
def test_bf16_bits_round_trip():
    x = torch.tensor([1.0, -2.5, 3.140625, float("inf")]).to(torch.bfloat16)
    b = bits_of(x)
    assert isinstance(b, BF16Bits) and b.view(np.ndarray).dtype == np.uint16
    assert torch.equal(torch_from_bits(b).view(torch.int16),
                       x.view(torch.int16))


def reference_state(arch, seed=2):
    """The reference's parameters and an AdamW state after one update of
    seeded gradients, so the moments are not zero."""
    cfg = jax_smoke(arch)
    params = JA.init_fn(jax.random.PRNGKey(seed), cfg)
    jc = JTrainConfig(warmup_steps=1)
    state = J.init_state(params, jc)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state, _, _ = J.apply_updates(params, grads, state, jc)
    return cfg, params, state


def port_model(arch):
    tcfg = configs.get_smoke_config(arch)
    model = TA.init_fn(torch.Generator().manual_seed(5), tcfg)
    st = adamw.init_state(dict(model.named_parameters()), TrainConfig())
    return tcfg, model, st


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_file_restores_into_the_port(tmp_path, arch):
    cfg, params, state = reference_state(arch)
    JCheckpointer(str(tmp_path), async_save=False).save(3, params, state)
    with np.load(tmp_path / "step_00000003" / "opt_state.npz") as z:
        keys = sorted(z.files)
    # the optimizer's keys, as the reference writes them
    assert {k.split("/")[0] for k in keys} == set(T.OPT_KEYS)
    tcfg, model, st = port_model(arch)
    meta = T.restore(Checkpointer(str(tmp_path)), None, model, st, tcfg)
    assert meta["step"] == 3 and int(st.step) == int(state.step) == 1
    named = dict(model.named_parameters())
    assert trees_equal(arrays_from_params(named, tcfg),
                       jax.tree.map(np.asarray, params))
    for mine, ref in ((st.mu, state.mu), (st.nu, state.nu)):
        assert trees_equal(arrays_from_params(mine, tcfg),
                           jax.tree.map(np.asarray, ref))
    # the port writes the same keys
    Checkpointer(str(tmp_path / "port"), async_save=False).save(
        3, arrays_from_params(named, tcfg), T.opt_tree(st, tcfg))
    with np.load(tmp_path / "port" / "step_00000003" / "opt_state.npz") as z:
        assert sorted(z.files) == keys


@pytest.mark.parametrize("arch", ARCHS)
def test_port_file_restores_through_the_reference(tmp_path, arch):
    cfg, params, state = reference_state(arch)
    tcfg, model, st = port_model(arch)
    model.load_state_dict(params_from_arrays(
        jax.tree.map(np.asarray, params), tcfg))
    for mine, ref in ((st.mu, state.mu), (st.nu, state.nu)):
        for k, v in params_from_arrays(jax.tree.map(np.asarray, ref),
                                       tcfg).items():
            mine[k].copy_(v)
    st.step.fill_(int(state.step))
    T.save(Checkpointer(str(tmp_path)), 9, model, st, tcfg, block=True)
    like_p = jax.tree.map(jnp.zeros_like, params)
    like_o = jax.tree.map(jnp.zeros_like, state)
    got_p, got_o, meta = JCheckpointer(str(tmp_path)).restore(
        None, like_p, like_o)
    assert meta["step"] == 9
    assert trees_equal(jax.tree.map(np.asarray, got_p),
                       jax.tree.map(np.asarray, params))
    assert int(got_o.step) == int(state.step)
    for got, want in ((got_o.mu, state.mu), (got_o.nu, state.nu)):
        assert trees_equal(jax.tree.map(np.asarray, got),
                           jax.tree.map(np.asarray, want))


def test_bf16_model_round_trip(tmp_path):
    """A bf16 model's parameters go to disk as bits and come back bit for
    bit, into placeholders that hold no memory."""
    import dataclasses

    tcfg = dataclasses.replace(configs.get_smoke_config("llama3.2-1b"),
                               dtype="bfloat16")
    model = TA.init_fn(torch.Generator().manual_seed(1), tcfg)
    st = adamw.init_state(dict(model.named_parameters()), TrainConfig())
    ck = Checkpointer(str(tmp_path))
    T.save(ck, 4, model, st, tcfg)
    ck.wait()
    fresh = TA.init_fn(torch.Generator().manual_seed(2), tcfg)
    st2 = adamw.init_state(dict(fresh.named_parameters()), TrainConfig())
    T.restore(ck, 4, fresh, st2, tcfg)
    for (k, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
    like = arrays_from_params(dict(fresh.named_parameters()), tcfg,
                              placeholders=True)
    assert isinstance(like["embed"], BF16Bits)
    assert like["blocks"]["attn"]["wq"].shape[0] == tcfg.num_layers
