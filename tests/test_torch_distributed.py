"""The port's distributed matcher (``repro_torch.core.distributed``) and its
deals (``repro_torch.graphs.partition``) on the CPU against the JAX
package's, on the same numpy-seeded inputs. Tolerance: exact equality of
the mask, the state and its dtype, the ``Counters`` and every
``DistStats`` field.

* D = 1 in this process (no process group: the collectives are the
  identity), both schedules, both state widths, ``vector_rounds`` 0/1/3;
  the locality-sharded run also against the port's ``skipper_match`` on
  the same schedule (the reference pins the same identity).
* D = 2 and D = 4 through gloo: one ``torch.multiprocessing.spawn`` of D
  ranks (a ``file://`` store under ``tmp_path``) runs every case of that
  D, and every rank writes what it got; one reference subprocess at 4
  forced host devices (``strategies.run_subprocess``) runs every case on
  a mesh of D of them. The cases: both schedules, both widths,
  ``vector_rounds`` 0/1, the chaos matrix of ``tests/test_faults.py``
  (``on_fault="recover"`` with ``verify``, and ``"report"``), and the
  retry-overflow fan of ``tests/test_distributed.py`` (the ladder's
  escalations, ``"raise"``, ``"report"``, no drain rounds).
"""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from strategies import run_subprocess

COUNTERS = ("edge_reads", "state_loads", "state_stores", "rounds")
STATS = ("proposals", "lost_proposals", "requeued", "retry_overflow",
         "undrained", "gathered_bytes", "recovery_attempts",
         "residual_edges", "recovered_matches", "corrupted_cells")
DISPERSED = dict(block_size=64, tile_size=64)
SHARDED = dict(block_size=64, window=128, tile_size=64)
KINDS = {"dispersed": DISPERSED, "sharded": SHARDED}
# the chaos matrix of tests/test_faults.py (lose_shard=1 as at D=4 there)
PLANS = {
    "drop": dict(seed=7, drop_proposals=0.3),
    "truncate": dict(seed=7, truncate_retry=0),
    "corrupt": dict(seed=7, corrupt_state=0.05),
    "lose_shard": dict(seed=7, lose_shard=1),
    "skip_drain": dict(seed=7, skip_drain=True),
}


# ------------------------------------------------------------------ graphs --
def _fan():
    """The retry-overflow fan of tests/test_distributed.py (D = 2, blocks
    of 8): 13 requeues into an 8-slot buffer."""
    a, b, h, x1, w, tt, c = 0, 1, 2, 3, 4, 5, 6
    x = [3, 7, 8, 9, 10, 11]
    y = list(range(12, 20))
    dum = iter(range(20, 60, 2))

    def d():
        p = next(dum)
        return (p, p + 1)

    blocks = [
        [(a, b), (h, x1), (x1, w)] + [d() for _ in range(5)],
        [(h, tt), (a, c)] + [(c, xi) for xi in x],
        [d() for _ in range(8)],
        [(c, yi) for yi in y],
    ]
    u = np.array([e[0] for blk in blocks for e in blk], np.int32)
    v = np.array([e[1] for blk in blocks for e in blk], np.int32)
    return u, v, 60


def _graph_arrays(name):
    """(u, v, n) numpy arrays of a named test graph, from the reference's
    generators."""
    from repro.graphs import generators as jgen

    if name == "fan":
        return _fan()
    g = {
        "er": lambda: jgen.erdos_renyi_graph(300, 900, seed=0),
        "rmat9": lambda: jgen.rmat_graph(9, 8, seed=6),
        "grid": lambda: jgen.grid_graph(20, 20),
        "star": lambda: jgen.star_graph(150),
    }[name]()
    return np.asarray(g.u), np.asarray(g.v), g.num_vertices


def _port_edges(name):
    from repro_torch.interop import edges_from_arrays

    return edges_from_arrays(*_graph_arrays(name))


def _ref_edges(name):
    import jax.numpy as jnp
    from repro.graphs.types import EdgeList as JEdgeList

    u, v, n = _graph_arrays(name)
    return JEdgeList(jnp.asarray(u), jnp.asarray(v), n)


# ------------------------------------------------------------------- cases --
def _cases():
    """Every multi-rank case: (name, D, graph, kwargs, plan, spec). Each
    new (D, schedule, width, rounds, plan, block) costs the reference one
    compilation, so the grid covers each axis rather than their product:
    both schedules at both D with both widths and rounds 0/1; the whole
    chaos matrix at D = 4 (as ``tests/test_faults.py`` runs it) under
    ``"recover"`` and ``"report"``; two of its sites at D = 2."""
    out = []
    for d in (2, 4):
        for kind, kw in KINDS.items():
            for spec, vr in (("u8", 1), ("legacy_i32", 0)):
                out.append((f"D{d}-{kind}-{spec}-vr{vr}", d, "er",
                            dict(kw, vector_rounds=vr), None, spec))
            # fault-free: every recovery field exactly zero
            out.append((f"D{d}-{kind}-clean-report", d, "er",
                        dict(kw, on_fault="report", verify=True), None,
                        "u8"))
            sites = PLANS if d == 4 else ("drop", "lose_shard")
            for site in sites:
                for pol in ("recover", "report"):
                    out.append((f"D{d}-{kind}-{site}-{pol}", d, "er",
                                dict(kw, on_fault=pol,
                                     verify=pol == "recover"),
                                PLANS[site], "u8"))
    out.append(("D4-dispersed-rmat9-legacy_i32-vr1", 4, "rmat9",
                dict(DISPERSED, vector_rounds=1), None, "legacy_i32"))
    fan = dict(block_size=8, tile_size=8)
    out += [
        ("D2-fan-raise", 2, "fan", fan, None, "u8"),
        ("D2-fan-report", 2, "fan", dict(fan, on_fault="report"), None,
         "u8"),
        ("D2-fan-no-drain", 2, "fan",
         dict(fan, drain_rounds=0, on_fault="report"), None, "u8"),
        ("D2-fan-recover", 2, "fan",
         dict(fan, on_fault="recover", verify=True), None, "u8"),
    ]
    return out


CASES = _cases()
CASE_NAMES = [c[0] for c in CASES]


def _record(result, stats):
    rec = {"mask": np.asarray(result.match_mask),
           "state": np.asarray(result.state)}
    for f in COUNTERS:
        rec[f] = int(np.asarray(getattr(result.counters, f)))
    for f in STATS:
        rec[f] = int(np.asarray(getattr(stats, f)))
    return rec


def _port_record(result, stats):
    rec = {"mask": result.match_mask.cpu().numpy(),
           "state": result.state.cpu().numpy()}
    for f in COUNTERS:
        rec[f] = int(getattr(result.counters, f))
    for f in STATS:
        rec[f] = int(torch.as_tensor(getattr(stats, f)))
    return rec


def _worker(rank, world, store, cases_path, graphs_path, out_dir):
    """One gloo rank: every case of its D, each rank's results saved."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.statespec import StateSpec
    from repro_torch.interop import edges_from_arrays

    arrays = np.load(graphs_path)

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    with open(cases_path) as f:
        cases = json.load(f)
    out = {}
    for name, d, graph, kw, plan, spec in cases:
        if d != world:
            continue
        try:
            edges = edges_from_arrays(arrays[f"{graph}_u"],
                                      arrays[f"{graph}_v"],
                                      int(arrays[f"{graph}_n"]))
            res, st = distributed_skipper(
                edges, device="cpu",
                faults=None if plan is None else FaultPlan(**plan),
                spec=getattr(StateSpec, spec)(), **kw)
            out[name] = _port_record(res, st)
        except RuntimeError as e:
            out[name] = {"error": str(e)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


_REF_SCRIPT = r"""
import json, pickle, sys
import numpy as np
import jax
sys.path.insert(0, {tests!r})
import test_torch_distributed as t
from jax.sharding import Mesh
from repro.core.distributed import distributed_skipper
from repro.core.faults import FaultPlan
from repro.core.statespec import StateSpec

assert jax.device_count() == 4
out = {{}}
for name, d, graph, kw, plan, spec in json.load(open({cases!r})):
    mesh = Mesh(np.array(jax.devices()[:d]), ("data",))
    try:
        res, st = distributed_skipper(
            t._ref_edges(graph), mesh=mesh,
            faults=None if plan is None else FaultPlan(**plan),
            spec=getattr(StateSpec, spec)(), **kw)
        out[name] = t._record(res, st)
    except RuntimeError as e:
        out[name] = {{"error": str(e)}}
pickle.dump(out, open({out!r}, "wb"))
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """{case: (reference record, [each rank's record])}: every multi-rank
    case run once by the reference (4 host devices) and by the port (one
    gloo spawn for each D)."""
    import pickle

    import torch.multiprocessing as mp

    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("ranks")
    cases_path = str(tmp / "cases.json")
    with open(cases_path, "w") as f:
        json.dump(CASES, f)
    graphs_path = str(tmp / "graphs.npz")
    arrays = {}
    for graph in sorted({c[2] for c in CASES}):
        u, v, n = _graph_arrays(graph)
        arrays.update({f"{graph}_u": u, f"{graph}_v": v, f"{graph}_n": n})
    np.savez(graphs_path, **arrays)
    ref_out = str(tmp / "ref.pkl")
    # the reference's subprocess runs beside the port's spawns
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_subprocess, _REF_SCRIPT.format(
            tests=os.path.dirname(__file__), cases=cases_path, out=ref_out),
            4)
        port = {}
        for d in (2, 4):
            out_dir = tmp / f"D{d}"
            out_dir.mkdir()
            mp.spawn(_worker, args=(d, str(tmp / f"store{d}"), cases_path,
                                    graphs_path, str(out_dir)),
                     nprocs=d, join=True)
            ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                     for r in range(d)]
            for name in ranks[0]:
                port[name] = [r[name] for r in ranks]
        ref_run.result()
    with open(ref_out, "rb") as f:
        ref = pickle.load(f)
    return {name: (ref[name], port[name]) for name in CASE_NAMES}


def _assert_records_equal(got, want, label):
    if "error" in want or "error" in got:
        assert got.keys() == want.keys() == {"error"}, (label, got, want)
        for key in ("retry_overflow=", "undrained="):
            assert (want["error"].split(key)[1].split()[0]
                    == got["error"].split(key)[1].split()[0]), label
        return
    assert got["state"].dtype == want["state"].dtype, label
    np.testing.assert_array_equal(got["mask"], want["mask"], err_msg=label)
    np.testing.assert_array_equal(got["state"], want["state"], err_msg=label)
    for f in COUNTERS + STATS:
        assert got[f] == want[f], (label, f, got[f], want[f])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_multi_rank_equals_reference(multi_rank, name):
    """Every rank's result equals the reference's at the same D."""
    want, ranks = multi_rank[name]
    for r, got in enumerate(ranks):
        _assert_records_equal(got, want, f"{name} rank {r}")


def test_multi_rank_faults_bite_and_recover(multi_rank):
    """What the reference's chaos tests pin, seen in the port's records:
    every recovered run is a complete matching (``verify`` raised nothing),
    within the ladder's bound, and ``"report"`` sees damage for the sites
    that are live at D > 1."""
    for d in (2, 4):
        for kind in KINDS:
            for site in (PLANS if d == 4 else ("drop", "lose_shard")):
                rec = multi_rank[f"D{d}-{kind}-{site}-recover"][1][0]
                assert "error" not in rec and rec["recovery_attempts"] <= 3
                if site in ("drop", "corrupt", "lose_shard"):
                    rec = multi_rank[f"D{d}-{kind}-{site}-report"][1][0]
                    assert rec["residual_edges"] + rec["corrupted_cells"] > 0
            clean = multi_rank[f"D{d}-{kind}-clean-report"][1][0]
            assert all(clean[f] == 0 for f in STATS[6:])
    assert "retry_overflow=5" in multi_rank["D2-fan-raise"][1][0]["error"]
    rec = multi_rank["D2-fan-recover"][1][0]
    assert rec["recovery_attempts"] >= 1 and rec["residual_edges"] == 0
    rec = multi_rank["D2-fan-no-drain"][1][0]
    assert rec["retry_overflow"] == 5 and rec["undrained"] == 8


# ------------------------------------------------------------------- D = 1 --
def _run_both(graph, *, spec="u8", plan=None, **kw):
    from repro.core.distributed import distributed_skipper as j_dist
    from repro.core.faults import FaultPlan as JPlan
    from repro.core.statespec import StateSpec as JSpec

    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.statespec import StateSpec

    want = j_dist(_ref_edges(graph), spec=getattr(JSpec, spec)(),
                  faults=None if plan is None else JPlan(**plan), **kw)
    got = distributed_skipper(
        _port_edges(graph), spec=getattr(StateSpec, spec)(), device="cpu",
        faults=None if plan is None else FaultPlan(**plan), **kw)
    return _port_record(*got), _record(*want), got


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("spec,vr", [("u8", 1), ("legacy_i32", 0),
                                     ("u8", 3)])
def test_single_rank_equals_reference(kind, spec, vr):
    got, want, _ = _run_both("er", spec=spec, vector_rounds=vr,
                             **KINDS[kind])
    _assert_records_equal(got, want, f"{kind}/{spec}/vr{vr}")


@pytest.mark.parametrize("graph", ["grid", "star", "rmat9"])
def test_single_rank_default_knobs_equal_reference(graph):
    """The reference's defaults (block 512, tile 256, four drain rounds)
    on the dispersed schedule; at D = 1 it is the sequential greedy."""
    from repro_torch.core import sgmm

    got, want, (res, stats) = _run_both(graph)
    _assert_records_equal(got, want, graph)
    assert stats.ok and int(stats.lost_proposals) == 0
    np.testing.assert_array_equal(
        res.match_mask.numpy(), sgmm(_port_edges(graph)).match_mask.numpy())


@pytest.mark.parametrize("site", sorted(PLANS))
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("policy", ["recover", "report"])
def test_single_rank_chaos_equals_reference(site, kind, policy):
    plan = dict(PLANS[site], lose_shard=0) if site == "lose_shard" \
        else PLANS[site]
    got, want, _ = _run_both("er", plan=plan, on_fault=policy,
                             verify=policy == "recover", **KINDS[kind])
    _assert_records_equal(got, want, f"{site}/{kind}/{policy}")


@pytest.mark.parametrize("policy", ["degree", "bfs", "greedy"])
def test_sharded_single_rank_equals_skipper_match(policy):
    """D = 1 locality-sharded equals ``skipper_match`` on the same
    schedule (mask and state, original ids), and the reference's run."""
    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.kernels.skipper_match import skipper_match

    for graph in ("rmat9", "star"):
        kw = dict(block_size=512, tile_size=256, window=1024, reorder=policy)
        got, want, (rd, stats) = _run_both(graph, **kw)
        _assert_records_equal(got, want, f"{policy}/{graph}")
        rk = skipper_match(_port_edges(graph), window=1024, tile_size=256,
                           reorder=policy, device="cpu")
        assert torch.equal(rd.match_mask, rk.match_mask), (policy, graph)
        assert torch.equal(rd.state, rk.state), (policy, graph)
        assert stats.ok
    # a prebuilt schedule gives the same run
    from repro_torch.graphs import build_window_schedule

    s = build_window_schedule(_port_edges("grid"), 1024, 256,
                              reorder=policy)
    rs, _ = distributed_skipper(_port_edges("grid"), schedule=s,
                                block_size=512, device="cpu")
    rk = skipper_match(_port_edges("grid"), schedule=s, device="cpu")
    assert torch.equal(rs.match_mask, rk.match_mask)


@pytest.mark.parametrize("sharded", [False, True])
def test_counters_count_only_real_edge_work(sharded):
    """Drain rounds scan empty slabs and count nothing: the counters are
    the same at 2 and 8 drain rounds, and edge reads are the valid edges
    plus the requeued re-scans (the reference's test)."""
    from repro_torch.core.distributed import distributed_skipper

    g = _port_edges("er")
    u, v = g.u.numpy(), g.v.numpy()
    m_valid = int(((u >= 0) & (u != v)).sum())
    kw = dict(reorder="degree") if sharded else dict(block_size=256)
    ra, sa = distributed_skipper(g, drain_rounds=2, device="cpu", **kw)
    rb, _ = distributed_skipper(g, drain_rounds=8, device="cpu", **kw)
    for f in COUNTERS[:3]:
        assert int(getattr(ra.counters, f)) == int(getattr(rb.counters, f))
    assert int(ra.counters.edge_reads) == m_valid + int(sa.requeued)
    assert int(ra.counters.state_stores) == 2 * int(ra.num_matches)


def test_policy_validation_and_stats():
    from repro_torch.core.distributed import DistStats, distributed_skipper

    g = _port_edges("er")
    with pytest.raises(ValueError, match="on_fault"):
        distributed_skipper(g, block_size=64, on_fault="panic",
                            device="cpu")
    with pytest.raises(ValueError, match="edge"):
        distributed_skipper(None, window=128, block_size=64,
                            on_fault="recover", device="cpu")
    with pytest.raises(ValueError, match="edge list"):
        distributed_skipper(None, device="cpu")
    with pytest.raises(ValueError, match="multiple of tile_size"):
        distributed_skipper(g, window=128, tile_size=64, block_size=96,
                            device="cpu")
    res, stats = distributed_skipper(g, block_size=64, tile_size=64,
                                     device="cpu")
    assert isinstance(stats, DistStats) and stats.ok
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert int(stats.gathered_ints) == int(stats.gathered_bytes) // 4
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    bad = dataclasses.replace(stats, retry_overflow=torch.tensor(3))
    assert not bad.ok
    with pytest.raises(RuntimeError, match="retry_overflow=3"):
        bad.raise_if_bad()


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core.distributed import distributed_skipper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device: "
                       "distributed_skipper"):
        distributed_skipper(_port_edges("er"))


@pytest.mark.parametrize("spec", ["u8", "legacy_i32"])
def test_combine_rows_is_the_identity_on_one_rank(spec):
    """No process group: the combine returns its rows, at their width."""
    from repro_torch.core.statespec import StateSpec

    sp = getattr(StateSpec, spec)()
    rows = torch.arange(12, dtype=sp.wire_dtype).reshape(3, 4)
    out = sp.combine_rows(rows.clone())
    assert out.dtype == sp.wire_dtype and torch.equal(out, rows)


# --------------------------------------------------------------- partition --
@pytest.mark.parametrize("d,block", [(1, 64), (2, 64), (3, 32), (4, 128)])
def test_dispersed_blocks_equal_reference(d, block):
    from repro.graphs.partition import dispersed_blocks as j_blocks
    from repro_torch.graphs import dispersed_blocks

    jb = j_blocks(_ref_edges("er"), d, block)
    tb = dispersed_blocks(_port_edges("er"), d, block)
    for a, b in zip(tb, jb):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("d,block,reorder", [
    (1, 64, "none"), (2, 64, "degree"), (3, 128, "bfs"), (4, 64, "greedy"),
    (2, 256, "none")])
def test_partition_schedule_equals_reference(d, block, reorder):
    """Every array of the deal, the schedule's own included, and the
    properties."""
    from repro.graphs.partition import dispersed_blocks as j_blocks
    from repro_torch.graphs import dispersed_blocks

    kw = dict(reorder=reorder, window=128, tile_size=64)
    jd = j_blocks(_ref_edges("rmat9"), d, block, **kw)
    td = dispersed_blocks(_port_edges("rmat9"), d, block, **kw)
    for f in ("u_rows", "v_rows", "row_slot", "boundary_ub", "boundary_vb",
              "boundary_ib"):
        a, b = getattr(td, f), getattr(jd, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("num_devices", "block_size", "rows_per_device", "num_rounds",
              "intra_fraction", "windowed_fraction", "window_balance"):
        assert getattr(td, f) == getattr(jd, f), f
    for f in ("stream_src", "boundary_u", "window_ids", "u_tiles"):
        np.testing.assert_array_equal(getattr(td.schedule, f),
                                      np.asarray(getattr(jd.schedule, f)))


def test_partition_schedule_checks_the_block():
    from repro_torch.graphs import build_window_schedule, partition_schedule

    s = build_window_schedule(_port_edges("er"), 128, 64)
    with pytest.raises(ValueError, match="multiple of tile_size 64"):
        partition_schedule(s, 2, 96)


@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_contiguous_chunks_equal_reference(chunks):
    from repro.graphs.partition import contiguous_chunks as j_chunks
    from repro_torch.graphs import contiguous_chunks

    for a, b in zip(contiguous_chunks(_port_edges("er"), chunks),
                    j_chunks(_ref_edges("er"), chunks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quickstart_torch_runs_on_the_cpu():
    """``examples/quickstart_torch.py`` at a small size on the CPU: every
    matching it checks is valid and maximal (exit code 0), and the chaos
    run's damage is seen and recovered."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--scale", "9", "--window", "128"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "distributed (locality-sharded)" in out and "recovered:" in out
    assert "maximal=False" not in out.split("faulted (report)")[0]
