"""The port's capacitated engine and ``bmatch_assign`` against the JAX
package, bit for bit, on numpy-seeded streams; against the sequential
greedy oracle; and, at unit capacity, against the port's unit engine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core.bipartite import bmatch_assign as jax_bmatch
from repro_torch.core import engine
from repro_torch.core.bipartite import BMATCH_VECTOR_ROUNDS, bmatch_assign
from repro_torch.core.statespec import StateSpec

METHODS = ["auto", "matrix", "sort", "scatter"]


def greedy_oracle(tok, exp, n_tok, n_exp, budget, cap):
    """Sequential greedy b-matching in stream order (the oracle of
    ``tests/test_bipartite.py``)."""
    used_t = np.zeros(n_tok, np.int64)
    used_e = np.zeros(n_exp, np.int64)
    out = np.zeros(len(tok), bool)
    for i, (t, e) in enumerate(zip(tok, exp)):
        if t < 0:
            continue
        if used_t[t] < budget and used_e[e] < cap:
            out[i] = True
            used_t[t] += 1
            used_e[e] += 1
    return out


def stream(seed):
    """A seeded stream with padding (-1 tokens), its sizes and budgets."""
    rng = np.random.default_rng(seed)
    n_tok = int(rng.integers(2, 90))
    n_exp = int(rng.integers(1, 20))
    budget = int(rng.integers(1, 5))
    cap = int(rng.integers(1, 40))
    m = int(rng.integers(1, 400))
    tok = rng.integers(-1, n_tok, m).astype(np.int32)
    exp = rng.integers(0, n_exp, m).astype(np.int32)
    return tok, exp, dict(num_tokens=n_tok, num_experts=n_exp,
                          token_budget=budget, expert_capacity=cap)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("vector_rounds", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_bmatch_bit_identical_to_reference(seed, vector_rounds, method):
    tok, exp, kw = stream(seed)
    kw.update(tile_size=64, vector_rounds=vector_rounds,
              conflict_method=method, with_stats=True)
    want, want_stats = jax_bmatch(jnp.asarray(tok), jnp.asarray(exp), **kw)
    got, stats = bmatch_assign(torch.from_numpy(tok), torch.from_numpy(exp),
                               **kw)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    for name in ("conflicts", "fallback_tiles"):
        assert stats[name].dtype == torch.int32
        assert int(stats[name]) == int(want_stats[name]), name
    oracle = greedy_oracle(tok, exp, kw["num_tokens"], kw["num_experts"],
                           kw["token_budget"], kw["expert_capacity"])
    assert np.array_equal(got.numpy(), oracle)


def test_bmatch_equals_sequential_greedy_seeded():
    rng = np.random.default_rng(0)
    for _ in range(20):
        tok = rng.integers(-1, 40, 256).astype(np.int32)
        exp = rng.integers(0, 8, 256).astype(np.int32)
        accept = bmatch_assign(
            torch.from_numpy(tok), torch.from_numpy(exp), num_tokens=40,
            num_experts=8, token_budget=2, expert_capacity=10, tile_size=64)
        assert np.array_equal(accept.numpy(),
                              greedy_oracle(tok, exp, 40, 8, 2, 10))
        ok = accept.numpy() & (tok >= 0)
        assert np.bincount(tok[ok], minlength=40).max(initial=0) <= 2
        assert np.bincount(exp[ok], minlength=8).max(initial=0) <= 10


@pytest.mark.parametrize("seed", [3, 4])
def test_moe_shaped_stream_bit_identical(seed):
    """A stream as the router builds it: kp candidates per token, sorted by
    score, at the router's tile size and capacity arithmetic."""
    rng = np.random.default_rng(seed)
    n, e, k = 300, 16, 4
    kp = k + 2
    scores = rng.standard_normal((n, e)).astype(np.float32)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :kp]
    vals = np.take_along_axis(scores, idx, 1).reshape(-1)
    order = np.argsort(-vals, kind="stable")
    tok = np.repeat(np.arange(n, dtype=np.int32), kp)[order]
    exp = idx.reshape(-1).astype(np.int32)[order]
    cap = max(8, (int(n * k / e * 1.25) + 7) // 8 * 8)
    kw = dict(num_tokens=n, num_experts=e, token_budget=k,
              expert_capacity=cap, tile_size=512)
    want = np.asarray(jax_bmatch(jnp.asarray(tok), jnp.asarray(exp), **kw))
    got = bmatch_assign(torch.from_numpy(tok), torch.from_numpy(exp), **kw)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, greedy_oracle(tok, exp, n, e, k, cap))


def _rank_inputs(seed):
    rng = np.random.default_rng(seed)
    m, n_tok, n_exp = 150, 50, 9
    valid = rng.random(m) > 0.1
    u = rng.integers(0, n_tok, m).astype(np.int32)
    v = rng.integers(0, n_exp, m).astype(np.int32)
    free = (rng.random(m) > 0.4) & valid
    return u, v, valid, free, n_tok, n_exp


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["ranks_from_matrix",
                                  "ranks_by_claim_sort",
                                  "ranks_by_claim_scatter",
                                  "capacitated_rank_fn"])
def test_rank_forms_bit_equal_to_reference(seed, form):
    u, v, valid, free, n_tok, n_exp = _rank_inputs(seed)
    extra = () if form == "ranks_from_matrix" else (n_tok, n_exp)
    jfn = getattr(jax_engine, form)(jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(valid), *extra)
    tfn = getattr(engine, form)(torch.from_numpy(u), torch.from_numpy(v),
                                torch.from_numpy(valid), *extra)
    for want, got in zip(jfn(jnp.asarray(free)), tfn(torch.from_numpy(free))):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_k_claim_commit_bit_equal_to_reference(seed):
    u, v, valid, _free, n_tok, n_exp = _rank_inputs(seed)
    rng = np.random.default_rng(seed + 10)
    cap_u, cap_v = 2, 5
    used_u = rng.integers(0, cap_u + 1, len(u)).astype(np.uint8)
    used_v = rng.integers(0, cap_v + 1, len(u)).astype(np.uint8)
    matched = rng.random(len(u)) < 0.2
    jrank = jax_engine.ranks_by_claim_sort(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(valid), n_tok, n_exp)
    trank = engine.ranks_by_claim_sort(
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(valid),
        n_tok, n_exp)
    want = jax_engine.first_k_claim_commit(
        jnp.asarray(used_u), jnp.asarray(used_v), jnp.asarray(valid),
        jnp.asarray(matched), jrank, cap_u, cap_v)
    got = engine.first_k_claim_commit(
        torch.from_numpy(used_u), torch.from_numpy(used_v),
        torch.from_numpy(valid), torch.from_numpy(matched), trank, cap_u,
        cap_v)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_unit_capacity_bit_identical_to_unit_engine(seed, vector_rounds):
    """caps (1, 1): the capacitated pass equals the port's unit engine on
    the experts-offset unipartite encoding: matched, conflicts, fallback
    and states."""
    rng = np.random.default_rng(seed)
    n_tok, n_exp, m = int(rng.integers(2, 60)), int(rng.integers(1, 30)), 200
    tok = rng.integers(-1, n_tok, m).astype(np.int32)
    exp = rng.integers(0, n_exp, m).astype(np.int32)
    valid = tok >= 0
    (uu, uv), matched_c, conf_c, fb_c = engine.tile_pass_capacitated(
        torch.zeros(n_tok, dtype=torch.int32),
        torch.zeros(n_exp, dtype=torch.int32),
        torch.from_numpy(tok), torch.from_numpy(exp), cap_u=1, cap_v=1,
        vector_rounds=vector_rounds)
    n = n_tok + n_exp
    u1 = torch.from_numpy(np.where(valid, tok, -1).astype(np.int32))
    v1 = torch.from_numpy(np.where(valid, exp + n_tok, 0).astype(np.int32))
    state, matched_1, conf_1, fb_1 = engine.tile_pass(
        torch.zeros(n, dtype=torch.uint8), u1, v1, n=n,
        vector_rounds=vector_rounds)
    assert torch.equal(matched_c, matched_1)
    assert torch.equal(conf_c, conf_1)
    assert bool(fb_c) == bool(fb_1)
    assert torch.equal(uu >= 1, state[:n_tok] == engine.MCHD)
    assert torch.equal(uv >= 1, state[n_tok:] == engine.MCHD)


def test_used_count_width_follows_the_spec():
    """The used counts keep their width (uint8 when the budgets fit the
    spec's at-rest dtype) and the conflicts narrow to the spec's counter."""
    tok = torch.tensor([0, 0, 1, 2, -1], dtype=torch.int32)
    exp = torch.tensor([0, 1, 1, 1, 0], dtype=torch.int32)
    (uu, uv), matched, conf, _ = engine.tile_pass_capacitated(
        torch.zeros(3, dtype=torch.uint8), torch.zeros(2, dtype=torch.uint8),
        tok, exp, cap_u=2, cap_v=2, vector_rounds=2, spec=StateSpec.u8())
    assert uu.dtype == uv.dtype == torch.uint8
    assert conf.dtype == torch.uint8
    assert matched.tolist() == [True, True, True, False, False]
    assert uu.tolist() == [2, 1, 0] and uv.tolist() == [1, 2]


def test_rounds_sensitivity():
    """The reference's chain instance: rounds never change the output; one
    round leaves the chain to the fallback, the default of two does not."""
    tok = torch.tensor([1, 1, 2], dtype=torch.int32)
    exp = torch.tensor([1, 2, 2], dtype=torch.int32)
    kw = dict(num_tokens=3, num_experts=3, token_budget=1,
              expert_capacity=1, tile_size=64, with_stats=True)
    for vr in (1, 2, 3):
        accept, stats = bmatch_assign(tok, exp, vector_rounds=vr, **kw)
        assert accept.tolist() == [True, False, True]
        assert int(stats["fallback_tiles"]) == (1 if vr == 1 else 0)
    assert BMATCH_VECTOR_ROUNDS == 2


def test_used_counts_cross_tiles_and_empty_stream():
    tok = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    exp = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    accept = bmatch_assign(tok, exp, num_tokens=4, num_experts=2,
                           token_budget=1, expert_capacity=2, tile_size=2)
    assert accept.tolist() == [True, True, False, True]
    empty = torch.zeros(0, dtype=torch.int32)
    accept, stats = bmatch_assign(empty, empty, num_tokens=1, num_experts=1,
                                  token_budget=1, expert_capacity=1,
                                  with_stats=True)
    assert accept.shape == (0,) and int(stats["conflicts"]) == 0
