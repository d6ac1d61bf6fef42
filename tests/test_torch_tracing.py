"""The port's spans and counters (``repro_torch/tracing.py``) on the CPU:
off a profiler a span only keeps its count and seconds; under
``torch.profiler`` each entry point's steps nest in its top span and hold
every operation of the call; the fallback counters equal the count of
edges blocked in every vector round, in the port's per-edge conflicts and
in the JAX package's on the same graph and schedule."""
import dataclasses
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core.skipper import skipper as j_skipper
from repro.graphs import generators as jgen
from repro.graphs.types import EdgeList as JEdgeList
from repro.graphs.windows import build_window_schedule as j_build
from repro.kernels.skipper_match import skipper_match as j_match

from repro_torch import tracing
from repro_torch.core import engine, skipper
from repro_torch.graphs import build_window_schedule
from repro_torch.interop import edges_from_arrays, schedule_from_arrays
from repro_torch.kernels import _build
from repro_torch.kernels.skipper_match import kernel, skipper_match

#: the steps of each entry point, beside the spans they share
STEPS = {"skipper_match": ("skipper_match.copy", "skipper_match.window_tier",
                           "skipper_match.global_tier", "skipper_match.gather",
                           "skipper_match.counters"),
         "skipper": ("skipper.stream_tiles", "skipper.global_tier",
                     "skipper.gather")}
SCHEDULE = ("schedule", "schedule.reorder", "schedule.split",
            "schedule.window_rows", "schedule.pairs", "schedule.gather_map")


@pytest.fixture(autouse=True)
def fresh_registry():
    tracing.reset()
    yield
    tracing.reset()


def _graph():
    g = jgen.rmat_graph(10, 6, seed=3)
    u, v = np.asarray(g.u, np.int32), np.asarray(g.v, np.int32)
    return (JEdgeList(jnp.asarray(u), jnp.asarray(v), g.num_vertices),
            edges_from_arrays(u, v, g.num_vertices))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()]


def test_off_a_profiler_spans_only_keep_time(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not tracing.recording()
    for _ in range(3):
        with tracing.span("a.b"):
            pass
    got = tracing.spans()["a.b"]
    assert got["count"] == 3 and got["total_s"] >= got["last_s"] > 0
    tracing.count_device("a.fallback", torch.ones((), dtype=torch.int64))
    engine.count_fallback("a", torch.ones(4, dtype=torch.uint8), 1, 4)
    assert opened == [] and tracing.counters() == {}
    assert tracing._DEVICE == {}


def test_under_a_profiler_a_span_is_an_event():
    def work():
        with tracing.span("a.b"):
            tracing.count_device("a.n", torch.tensor(2))
            tracing.count_device("a.n", 3)
            return torch.ones(3).sum()

    _, events = _traced(work)
    assert [e[0] for e in events].count("a.b") == 1
    assert tracing.counters() == {"a.n": 5}
    assert tracing.spans()["a.b"]["count"] == 1


def _assert_steps_cover(events, top, steps):
    """Every step lies inside a top span and every aten operation inside a
    top span lies inside one of its steps."""
    tops = [(s, e) for n, s, e in events if n == top]
    assert tops
    inner = [(n, s, e) for n, s, e in events if n in steps]
    for n, s, e in inner:
        assert any(t0 <= s and e <= t1 for t0, t1 in tops), n
    ops = [(n, s, e) for n, s, e in events if n.startswith("aten::")
           and any(t0 <= s and e <= t1 for t0, t1 in tops)]
    assert ops
    for n, s, e in ops:
        assert any(s0 <= s and e <= e0 for _, s0, e0 in inner), n


@pytest.mark.parametrize("prebuilt", [True, False])
def test_skipper_match_steps_nest_in_its_span(prebuilt):
    _, g = _graph()
    kw = dict(window=128, tile_size=64, reorder="degree", device="cpu")
    if prebuilt:
        sched = build_window_schedule(g, 128, 64, reorder="degree")
        kw = dict(schedule=sched, device="cpu")
    _, events = _traced(lambda: skipper_match(g, **kw))
    names = {n for n, _, _ in events}
    assert set(STEPS["skipper_match"]) <= names
    assert set(SCHEDULE) <= names or prebuilt
    _assert_steps_cover(events, "skipper_match",
                        STEPS["skipper_match"] + SCHEDULE)
    assert tracing.spans()["skipper_match"]["count"] == 1
    assert tracing.counters().get("h2d_bytes", 0) == 0  # nothing to a card


def test_skipper_match_on_the_cpu_stages_nothing(monkeypatch):
    """On the CPU a schedule array is the caller's own memory: nothing is
    staged or moved, and the steps still nest in the call's span."""
    from repro_torch.kernels.skipper_match import ops

    def no_staging(*args):
        raise AssertionError("staged on the CPU")

    monkeypatch.setattr(ops, "_stage", no_staging)
    _, g = _graph()
    sched = build_window_schedule(g, 128, 64, reorder="degree")
    for backend in (None, "torch"):
        _, events = _traced(lambda: skipper_match(
            g, schedule=sched, backend=backend, device="cpu"))
        _assert_steps_cover(events, "skipper_match", STEPS["skipper_match"])
    counts = tracing.counters()
    assert counts.get("h2d_staged_bytes", 0) == 0
    assert counts.get("h2d_bytes", 0) == 0
    assert tracing.spans()["skipper_match.copy"]["count"] == 2 * 9


def test_skipper_steps_nest_in_its_span():
    _, g = _graph()
    _, events = _traced(lambda: skipper(g, tile_size=64, device="cpu"))
    assert set(STEPS["skipper"]) <= {n for n, _, _ in events}
    _assert_steps_cover(events, "skipper", STEPS["skipper"])
    assert tracing.counters().get("h2d_bytes", 0) == 0


def test_schedule_phases_nest_in_its_span():
    _, g = _graph()
    _, events = _traced(lambda: build_window_schedule(g, 128, 64,
                                                      reorder="degree"))
    (s, e), = [(s, e) for n, s, e in events if n == "schedule"]
    for name in SCHEDULE[1:]:
        (s1, e1), = [(a, b) for n, a, b in events if n == name]
        assert s <= s1 and e1 <= e, name
    assert tracing.spans()["schedule.reorder"]["last_s"] > 0


def _blocked_every_round(conf, idx, vector_rounds):
    idx = np.asarray(idx)
    return int((np.asarray(conf)[idx[idx >= 0]] == vector_rounds).sum())


@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_match_fallback_counters(vector_rounds):
    jg, g = _graph()
    jsched = j_build(jg, 128, 256, reorder="degree")
    sched = schedule_from_arrays({
        f.name: getattr(jsched, f.name)
        for f in dataclasses.fields(jsched)})
    with profile(activities=[ProfilerActivity.CPU]):
        _, conf = skipper_match(g, schedule=sched, device="cpu",
                                vector_rounds=vector_rounds,
                                with_conflicts=True)
    _, jconf = j_match(jg, schedule=jsched, backend="xla",
                       vector_rounds=vector_rounds, with_conflicts=True)
    got = tracing.counters()
    for tier, idx in (("window_tier", sched.edge_index),
                      ("global_tier", sched.boundary_index)):
        want = _blocked_every_round(conf.numpy(), idx, vector_rounds)
        assert want == _blocked_every_round(jconf, idx, vector_rounds)
        assert got[f"skipper_match.{tier}.fallback_edges"] == want, tier
        assert want > 0, tier  # the graph exercises the fallback
    assert got["skipper_match.window_tier.edges"] == sched.num_windowed
    assert got["skipper_match.global_tier.edges"] == (sched.num_valid
                                                      - sched.num_windowed)


def test_a_match_without_a_global_tier_counts_no_edge_there():
    """A schedule whose one window holds every edge has no global tier:
    its counters read 0 edges, not nothing."""
    _, g = _graph()
    sched = build_window_schedule(g, 1024, 64)
    assert sched.num_boundary_tiles == 0
    with profile(activities=[ProfilerActivity.CPU]):
        skipper_match(g, schedule=sched, device="cpu")
    got = tracing.counters()
    assert got["skipper_match.global_tier.edges"] == 0
    assert got["skipper_match.global_tier.fallback_edges"] == 0
    assert got["skipper_match.window_tier.edges"] == sched.num_valid


@pytest.mark.parametrize("vector_rounds", [1, 2])
def test_raw_fallback_counters(vector_rounds):
    jg, g = _graph()
    with profile(activities=[ProfilerActivity.CPU]):
        _, conf = skipper(g, tile_size=256, vector_rounds=vector_rounds,
                          with_conflicts=True, device="cpu")
    _, jconf = j_skipper(jg, tile_size=256, vector_rounds=vector_rounds,
                         with_conflicts=True)
    want = int((conf == vector_rounds).sum())
    assert want == int((np.asarray(jconf) == vector_rounds).sum()) > 0
    got = tracing.counters()
    assert got["skipper.fallback_edges"] == want
    u, v = g.u, g.v
    assert got["skipper.edges"] == int(((u != v) & (u >= 0)).sum())


@pytest.mark.parametrize("m,tile_size", [(1000, 256), (1024, 256), (5, 64)])
def test_raw_tiles_counter(m, tile_size):
    """``skipper.tiles`` grows by ceil(m / tile_size) a call, the tile the
    padding completes among them, with or without a profiler."""
    rng = np.random.default_rng(m)
    u = rng.integers(0, 50, m, dtype=np.int32)
    v = rng.integers(0, 50, m, dtype=np.int32)
    g = edges_from_arrays(u, v, 50)
    want = -(-m // tile_size)
    skipper(g, tile_size=tile_size, device="cpu")
    assert tracing.counters()["skipper.tiles"] == want
    with profile(activities=[ProfilerActivity.CPU]):
        skipper(g, tile_size=tile_size, device="cpu")
    assert tracing.counters()["skipper.tiles"] == 2 * want
    assert tracing.spans()["skipper"]["count"] == 2


def test_launches_are_registry_counters():
    kernel.reset_launch_counts()
    tracing.launched(kernel.BOUNDARY_ASYNC)
    assert tracing.counters()[f"launches.{kernel.BOUNDARY_ASYNC}"] == 1
    assert kernel.launch_counts()[kernel.BOUNDARY_ASYNC] == 1
    kernel.reset_launch_counts()
    assert set(kernel.launch_counts().values()) == {0}


def test_a_build_is_a_span(monkeypatch, tmp_path):
    """``kernels.build`` spans each wait for nvcc; a source already built
    adds none."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_command", lambda source, out: [
        sys.executable, "-c",
        "import sys; open(sys.argv[1], 'w').write('built')", str(out)])
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    _build.build(source)
    _build.build(source)
    assert tracing.spans()["kernels.build"]["count"] == 1
