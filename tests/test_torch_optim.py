"""The port's AdamW (``repro_torch.optim.adamw``) and ``TrainConfig`` on
the CPU against the JAX package's, on numpy-seeded leaves.

Tolerances: f32 leaves within 1e-6 relative (the largest difference over
the leaf's largest magnitude: both compute the same f32 formula, element
by element, and may differ only in how a compiler fuses it); bf16 leaves
within one bf16 step of the reference's value (both round the same f32
value to bf16 once; a last-bit difference in f32 can land the two one
step apart). The schedule and the step counter are compared within 1e-6
and exactly. The reference's own five ``test_optim.py`` cases are restated
on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.optim import adamw as J
from repro_torch.configs import TrainConfig
from repro_torch.optim import adamw

DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                   jnp.bfloat16)}


def test_train_config_equals_reference():
    assert (dataclasses.asdict(TrainConfig())
            == dataclasses.asdict(JTrainConfig()))
    assert ([f.name for f in dataclasses.fields(TrainConfig)]
            == [f.name for f in dataclasses.fields(JTrainConfig)])


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 6), (0, 1),
                                          (100, 1000)])
def test_cosine_lr_equals_reference(warmup, total):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    tc, jc = TrainConfig(**kw), JTrainConfig(**kw)
    steps = np.arange(total + 5, dtype=np.int32)
    got = adamw.cosine_lr(torch.from_numpy(steps), tc).numpy()
    want = np.asarray(J.cosine_lr(jnp.asarray(steps), jc))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def leaves(seed, dtype):
    """Seeded leaves of ndim 1, 2 and 3 (a name each), as numpy f32 values
    rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    shapes = {"vec": (7,), "mat": (5, 6), "stack": (2, 3, 4)}
    tdt = DT[dtype][0]
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(tdt).float().numpy() for k, s in shapes.items()}


def to_torch(tree, dtype):
    return {k: torch.from_numpy(v.copy()).to(DT[dtype][0])
            for k, v in tree.items()}


def to_jax(tree, dtype):
    return {k: jnp.asarray(v, DT[dtype][1]) for k, v in tree.items()}


def close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.float().numpy()
    assert g.shape == want.shape
    if dtype == "f32":
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g - want).max()) <= 1e-6 * scale
    else:
        # one bf16 step of the reference's value: 2^-7 of its binade
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                   2.0 ** -126))) - 7)
        assert (np.abs(g - want) <= step).all()


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clip_by_global_norm_equals_reference(dtype, max_norm):
    g = leaves(3, dtype)
    got, gnorm = adamw.clip_by_global_norm(to_torch(g, dtype), max_norm)
    want, jnorm = J.clip_by_global_norm(to_jax(g, dtype), max_norm)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    for k in g:
        assert got[k].dtype == DT[dtype][0]
        close(got[k], want[k], dtype)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("steps", [1, 3])
def test_apply_updates_equals_reference(dtype, moments, steps):
    """``steps`` AdamW steps from the same leaves and gradients, decay on
    the leaves of ndim >= 2 only, gradients clipped (max norm 1)."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1)
    tc, jc = TrainConfig(**kw), JTrainConfig(**kw)
    p0 = leaves(0, dtype)
    tp = to_torch(p0, dtype)
    jp = to_jax(p0, dtype)
    ts = adamw.init_state(tp, tc, moment_dtype=DT[moments][0])
    js = J.init_state(jp, jc, moment_dtype=DT[moments][1])
    for i in range(steps):
        g = leaves(10 + i, dtype)
        tp, ts, lr, gn = adamw.apply_updates(tp, to_torch(g, dtype), ts, tc)
        jp, js, jlr, jgn = J.apply_updates(jp, to_jax(g, dtype), js, jc)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        # compare each step from the reference's values, so errors do not
        # compound over the steps
        for k in p0:
            close(tp[k], jp[k], dtype)
            close(ts.mu[k], js.mu[k], moments)
            close(ts.nu[k], js.nu[k], moments)
            for mine, ref in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
                mine[k].copy_(torch.tensor(np.array(
                    jnp.asarray(ref[k], jnp.float32))))
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
    assert all(ts.mu[k].dtype == DT[moments][0] for k in p0)
    assert all(tp[k].dtype == DT[dtype][0] for k in p0)


def test_apply_updates_works_in_place_without_host_reads():
    """The parameters and the moments given are the ones updated; the step
    counter stays a tensor."""
    p = {"w": torch.ones((2, 2))}
    st = adamw.init_state(p, TrainConfig())
    w, mu = p["w"], st.mu["w"]
    out, st2, lr, gn = adamw.apply_updates(p, {"w": torch.ones((2, 2))}, st,
                                           TrainConfig(warmup_steps=1))
    assert out is p and out["w"] is w and st2.mu["w"] is mu
    assert not torch.equal(w, torch.ones((2, 2)))
    assert isinstance(st2.step, torch.Tensor) and int(st2.step) == 1
    assert int(st.step) == 0


def test_decay_reads_the_reference_rank():
    """A leaf that is a vector here but a stacked matrix in the reference
    (a block's norm scale) decays when ``ndims`` says so."""
    tc = TrainConfig(learning_rate=1e-2, weight_decay=1.0, warmup_steps=1)
    zero = {"v": torch.zeros(3), "w": torch.zeros(3)}
    p = {"v": torch.ones(3), "w": torch.ones(3)}
    st = adamw.init_state(p, tc)
    adamw.apply_updates(p, zero, st, tc, ndims={"w": 2})
    assert torch.equal(p["v"], torch.ones(3))
    assert (p["w"] < 1).all()


# --------------------------------------- the reference's test_optim.py ----
def test_adamw_minimizes_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                       weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = adamw.init_state(params, tcfg)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, state, lr, gn = adamw.apply_updates(params, g, state, tcfg)
    assert float(torch.sum(torch.square(params["w"]))) < 1e-2


def test_grad_clip():
    g = {"w": torch.tensor([30.0, 40.0])}       # norm 50
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 50.0) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["w"])) - 1.0) < 1e-4


def test_cosine_schedule_shape():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.cosine_lr(torch.tensor(s, dtype=torch.int32), tcfg))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9          # warmup rises
    assert lrs[10] >= lrs[50] >= lrs[99]           # cosine decays
    assert lrs[99] >= 0.1 * 1e-3 * 0.99            # floor at 10%


def test_bf16_moments():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = adamw.init_state(params, tcfg, moment_dtype=torch.bfloat16)
    assert state.mu["w"].dtype == torch.bfloat16
    before = params["w"].clone()
    g = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}
    p2, s2, _, _ = adamw.apply_updates(params, g, state, tcfg)
    assert s2.mu["w"].dtype == torch.bfloat16
    assert float((p2["w"].float() - before.float()).abs().sum()) > 0


def test_weight_decay_only_on_matrices():
    tcfg = TrainConfig(learning_rate=1e-2, weight_decay=1.0, warmup_steps=1)
    params = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    state = adamw.init_state(params, tcfg)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _, _ = adamw.apply_updates(params, zero_g, state, tcfg)
    assert float((p2["mat"] - 1.0).abs().sum()) > 0     # decayed
    assert float((p2["vec"] - 1.0).abs().sum()) == 0    # not decayed
