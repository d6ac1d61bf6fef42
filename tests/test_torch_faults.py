"""The port's fault injection and recovery ladder (``repro_torch.core.faults``,
``engine.stream_pass`` and ``skipper_match(faults=, on_fault=, verify=)``)
on the CPU against the JAX package's (``backend="xla"``) on the same
numpy-seeded inputs. Tolerance: exact equality of the victim masks, the
match mask, the state and its dtype, the per-edge conflicts, the
``Counters`` and the ``RecoveryReport``.

The victim masks are drawn without JAX by the port's numpy Threefry-2x32;
they are held against ``jax.random.bernoulli`` itself.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import engine as j_engine
from repro.core import faults as j_faults
from repro.core.statespec import StateSpec as JSpec
from repro.graphs import generators as jgen
from repro.graphs.types import EdgeList as JEdgeList
from repro.graphs.windows import build_window_schedule as j_build
from repro.kernels.skipper_match import skipper_match as j_match

from repro_torch.core import assert_matching, engine
from repro_torch.core import faults
from repro_torch.core.faults import FaultPlan, RecoveryReport
from repro_torch.core.statespec import StateSpec
from repro_torch.graphs import build_window_schedule
from repro_torch.interop import edges_from_arrays
from repro_torch.kernels.skipper_match import kernel, skipper_match

COUNTERS = ("edge_reads", "state_loads", "state_stores", "rounds")
SPECS = {"u8": (StateSpec.u8(), JSpec.u8()),
         "legacy_i32": (StateSpec.legacy_i32(), JSpec.legacy_i32())}
# tests/test_faults.py's plans, and their combination
PLANS = {
    "drop": dict(seed=7, drop_proposals=0.3),
    "truncate": dict(seed=7, truncate_retry=0),
    "corrupt": dict(seed=7, corrupt_state=0.05),
    "lose_shard": dict(seed=7, lose_shard=0),
    "skip_drain": dict(seed=7, skip_drain=True),
    "combined": dict(seed=3, drop_proposals=0.25, corrupt_state=0.05,
                     lose_shard=1),
}


def _pair(g):
    u, v = np.asarray(g.u, np.int32), np.asarray(g.v, np.int32)
    return (JEdgeList(jnp.asarray(u), jnp.asarray(v), g.num_vertices),
            edges_from_arrays(u, v, g.num_vertices))


JG, TG = _pair(jgen.erdos_renyi_graph(300, 900, seed=0))
JS = j_build(JG, window=128, tile_size=64)
TS = build_window_schedule(TG, window=128, tile_size=64)


# ------------------------------------------------------------- the masks --
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("site", [1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.25, 1.0])
@pytest.mark.parametrize("n", [0, 1, 33, 4097, 1 << 20])
def test_threefry_bernoulli_equals_jax(seed, site, rate, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), site)
    want = np.asarray(jax.random.bernoulli(key, rate, (n,)))
    got = faults._bernoulli(seed, site, rate, n)
    assert got.dtype == np.bool_ and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, -1, 2**32 + 5])
def test_victim_masks_equal_reference(seed):
    """Both sites' masks as the plan draws them, on the caller's device;
    seeds outside 32 bits keep their low word, as ``PRNGKey`` does."""
    kw = dict(seed=seed, drop_proposals=0.25, corrupt_state=0.05)
    jp, tp = j_faults.FaultPlan(**kw), FaultPlan(**kw)
    for fn in ("proposal_drop_mask", "corruption_mask"):
        got = getattr(faults, fn)(tp, 5000, "cpu")
        want = np.asarray(getattr(j_faults, fn)(jp, 5000))
        assert got.dtype == torch.bool and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def test_plan_and_report_fields_equal_reference():
    fields = lambda cls: [(f.name, f.default)  # noqa: E731
                          for f in dataclasses.fields(cls)]
    assert fields(FaultPlan) == fields(j_faults.FaultPlan)
    assert fields(RecoveryReport) == fields(j_faults.RecoveryReport)
    assert faults.CORRUPT == j_faults.CORRUPT == 7
    for kw in PLANS.values():
        assert FaultPlan(**kw).active == j_faults.FaultPlan(**kw).active
    assert not FaultPlan(seed=99).active


# ------------------------------------------------------------- stream pass --
@pytest.mark.parametrize("tile", [8, 64])
@pytest.mark.parametrize("vr", [0, 1, 3])
@pytest.mark.parametrize("spec", [None, "u8", "legacy_i32"])
def test_stream_pass_equals_reference(tile, vr, spec):
    """The slab pass from a state with some MCHD cells, with padding,
    invalid slots and duplicates in the slab; the port's updates the state
    in place."""
    rng = np.random.default_rng(tile + vr)
    n, slab = 120, 4 * tile
    u = rng.integers(0, n, slab).astype(np.int32)
    v = rng.integers(0, n, slab).astype(np.int32)
    loops = rng.random(slab) < 0.05
    v[loops] = u[loops]
    pad = rng.random(slab) < 0.1
    u[pad], v[pad] = -1, -1
    st0 = np.where(rng.random(n) < 0.2, 2, 0).astype(np.uint8)
    js = None if spec is None else SPECS[spec][1]
    ts = None if spec is None else SPECS[spec][0]
    want = j_engine.stream_pass(jnp.asarray(st0), jnp.asarray(u),
                                jnp.asarray(v), n=n, vector_rounds=vr,
                                tile_size=tile, spec=js)
    state = torch.from_numpy(st0.copy())
    got = engine.stream_pass(state, torch.from_numpy(u), torch.from_numpy(v),
                             n=n, vector_rounds=vr, tile_size=tile, spec=ts)
    assert got[0] is state
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stream_pass_backend_checks():
    s = torch.zeros(4, dtype=torch.uint8)
    ids = torch.full((8,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.stream_pass(s, ids, ids, n=4, vector_rounds=1, tile_size=8,
                           backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        engine.stream_pass(s, ids, ids, n=4, vector_rounds=1, tile_size=8,
                           backend="tpu")


# ------------------------------------------------ detection and the replay --
def _damaged(site, spec):
    """A damaged run of the reference: (mask, state) as numpy arrays."""
    r, _ = j_match(JG, schedule=JS, backend="xla", spec=SPECS[spec][1],
                   faults=j_faults.FaultPlan(**PLANS[site]),
                   on_fault="report")
    return np.array(r.match_mask), np.array(r.state)


@pytest.mark.parametrize("site", ["drop", "corrupt", "lose_shard",
                                  "combined"])
@pytest.mark.parametrize("spec", ["u8", "legacy_i32"])
def test_detect_and_replay_equal_reference(site, spec):
    mask, state = _damaged(site, spec)
    jd = j_faults.detect_residual(JG, jnp.asarray(mask), jnp.asarray(state))
    td = faults.detect_residual(TG, torch.from_numpy(mask),
                                torch.from_numpy(state))
    assert [int(x) for x in td] == [int(x) for x in jd]
    assert all(x.dtype == torch.int32 for x in td)
    assert int(td[0]) + int(td[1]) > 0  # the fault bit
    for tile, vr in ((64, 1), (32, 0)):
        want = j_faults.residual_replay(
            JG, jnp.asarray(mask), jnp.asarray(state), tile_size=tile,
            vector_rounds=vr, spec=SPECS[spec][1])
        got = faults.residual_replay(
            TG, torch.from_numpy(mask), torch.from_numpy(state),
            tile_size=tile, vector_rounds=vr, spec=SPECS[spec][0])
        for a, b in zip(got, want):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_matching(TG, got[0], f"replay/{site}/{spec}")


def test_replay_of_a_clean_run_changes_nothing():
    r = skipper_match(TG, schedule=TS, device="cpu")
    mask, state, res, rec, cor = faults.residual_replay(
        TG, r.match_mask, r.state, tile_size=64)
    assert torch.equal(mask, r.match_mask)
    assert (int(res), int(rec), int(cor)) == (0, 0, 0)


# ---------------------------------------------------------- skipper_match --
def _match_both(plan, policy, spec="u8", vr=1, **kw):
    want = j_match(JG, schedule=JS, backend="xla", vector_rounds=vr,
                   spec=SPECS[spec][1], with_conflicts=True,
                   faults=None if plan is None
                   else j_faults.FaultPlan(**plan), on_fault=policy, **kw)
    got = skipper_match(TG, schedule=TS, device="cpu", vector_rounds=vr,
                        spec=SPECS[spec][0], with_conflicts=True,
                        faults=None if plan is None else FaultPlan(**plan),
                        on_fault=policy, **kw)
    return got, want


def _assert_match_equal(got, want):
    (r, c, rep), (jr, jc, jrep) = got, want
    for a, b in ((r.match_mask, jr.match_mask), (r.state, jr.state),
                 (c, jc)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in COUNTERS:
        assert int(getattr(r.counters, f)) == int(getattr(jr.counters, f))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)


@pytest.mark.parametrize("site", sorted(PLANS))
@pytest.mark.parametrize("policy", ["report", "recover"])
@pytest.mark.parametrize("spec", ["u8", "legacy_i32"])
def test_skipper_match_faults_equal_reference(site, policy, spec):
    got, want = _match_both(PLANS[site], policy, spec)
    _assert_match_equal(got, want)
    if policy == "recover":
        assert_matching(TG, got[0].match_mask, f"{site}/{spec}")
        rep = got[2]
        assert rep.recovery_attempts == int(
            rep.residual_edges > 0 or rep.corrupted_cells > 0)


@pytest.mark.parametrize("site", ["drop", "corrupt", "lose_shard"])
def test_faults_bite_under_report(site):
    """The sites live at D = 1 leave damage that ``"report"`` sees; the
    retry-buffer sites have nothing to act on in one pipeline."""
    (_, _, rep), _ = _match_both(PLANS[site], "report")
    assert rep.residual_edges + rep.corrupted_cells > 0
    for inert in ("truncate", "skip_drain"):
        (_, _, rep), _ = _match_both(PLANS[inert], "report")
        assert rep == RecoveryReport()


@pytest.mark.parametrize("vr", [0, 2])
def test_skipper_match_faults_other_rounds_and_reorder(vr):
    """Vector rounds and a reordered schedule (the corruption lands in the
    renumbered flat ids)."""
    got, want = _match_both(PLANS["combined"], "recover", vr=vr)
    _assert_match_equal(got, want)
    jsch = j_build(JG, window=128, tile_size=64, reorder="degree")
    tsch = build_window_schedule(TG, window=128, tile_size=64,
                                 reorder="degree")
    plan = PLANS["combined"]
    jr, jrep = j_match(JG, schedule=jsch, backend="xla", vector_rounds=vr,
                       faults=j_faults.FaultPlan(**plan), on_fault="report")
    tr, trep = skipper_match(TG, schedule=tsch, device="cpu",
                             vector_rounds=vr, faults=FaultPlan(**plan),
                             on_fault="report")
    np.testing.assert_array_equal(tr.match_mask.numpy(),
                                  np.asarray(jr.match_mask))
    np.testing.assert_array_equal(tr.state.numpy(), np.asarray(jr.state))
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)


def test_inactive_plan_and_clean_report_are_the_clean_path():
    base = skipper_match(TG, schedule=TS, device="cpu")
    same = skipper_match(TG, schedule=TS, device="cpu",
                         faults=FaultPlan(seed=99))
    assert torch.equal(base.match_mask, same.match_mask)
    assert torch.equal(base.state, same.state)
    r, rep = skipper_match(TG, schedule=TS, device="cpu", on_fault="report",
                           verify=True)
    assert rep == RecoveryReport() and torch.equal(r.match_mask,
                                                    base.match_mask)
    r, rep = skipper_match(TG, schedule=TS, device="cpu",
                           on_fault="recover", verify=True)
    assert rep == RecoveryReport() and torch.equal(r.match_mask,
                                                    base.match_mask)


def test_policy_errors_and_verify():
    with pytest.raises(ValueError, match="on_fault"):
        skipper_match(TG, schedule=TS, device="cpu", on_fault="retry")
    with pytest.raises(ValueError, match="edge list"):
        skipper_match(schedule=TS, device="cpu", on_fault="recover")
    with pytest.raises(ValueError, match="edge list"):
        skipper_match(schedule=TS, device="cpu", on_fault="report")
    plan = FaultPlan(**PLANS["corrupt"])
    # a faulted run under "raise" with verify names the damage
    with pytest.raises(RuntimeError, match="out_of_domain=23"):
        skipper_match(TG, schedule=TS, device="cpu", faults=plan,
                      verify=True)
    # ... and passes once recovered; "report" never raises
    skipper_match(TG, schedule=TS, device="cpu", faults=plan,
                  on_fault="recover", verify=True)
    skipper_match(TG, schedule=TS, device="cpu", faults=plan,
                  on_fault="report", verify=True)
    # corruption breaks maximality only, never validity
    r = skipper_match(TG, schedule=TS, device="cpu", faults=plan)
    from repro_torch.core import check_matching

    chk = check_matching(TG, r.match_mask)
    assert bool(chk["valid"]) and not bool(chk["maximal"])
    assert int((r.state == faults.CORRUPT).sum()) == 23


def test_faults_launch_nothing_on_cpu():
    kernel.reset_launch_counts()
    skipper_match(TG, schedule=TS, device="cpu",
                  faults=FaultPlan(**PLANS["combined"]), on_fault="recover")
    assert set(kernel.launch_counts().values()) == {0}
