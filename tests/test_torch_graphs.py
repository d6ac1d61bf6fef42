"""The port's host precompute against the JAX package: generators, the four
reorder policies and every ``WindowSchedule`` field, exact equality."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.graphs import generators as jgen
from repro.graphs import reorder as jreorder
from repro.graphs.types import EdgeList as JEdgeList
from repro.graphs.windows import build_window_schedule as j_build

from repro_torch.graphs import generators as tgen
from repro_torch.graphs import reorder as treorder
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.windows import WindowSchedule, build_window_schedule
from repro_torch.interop import edges_from_arrays, schedule_from_arrays


def _pair(u, v, n):
    """The same numpy edges as a reference and a port EdgeList."""
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    return (JEdgeList(jnp.asarray(u), jnp.asarray(v), n),
            edges_from_arrays(u, v, n))


def _graph(name):
    if name == "rmat":
        g = jgen.rmat_graph(10, 4, seed=3)
    elif name == "er":
        g = jgen.erdos_renyi_graph(600, 2400, seed=4)
    elif name == "grid":
        g = jgen.grid_graph(20, 24)
    else:
        g = jgen.star_graph(400)
    return _pair(np.asarray(g.u), np.asarray(g.v), g.num_vertices)


def assert_schedules_equal(ref, port):
    for f in dataclasses.fields(WindowSchedule):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for prop in ("num_rows", "num_boundary_padded", "num_boundary_tiles",
                 "num_boundary_pairs", "intra_fraction", "windowed_fraction",
                 "padding_waste"):
        assert getattr(ref, prop) == getattr(port, prop), prop
    np.testing.assert_array_equal(port.stream_to_slot(), ref.stream_to_slot())
    np.testing.assert_array_equal(port.slot_to_stream(), ref.slot_to_stream())
    assert port.vmem_state_bytes() == ref.vmem_state_bytes()


@pytest.mark.parametrize("make", [
    lambda g: g.rmat_graph(9, 8, seed=3),
    lambda g: g.rmat_graph(8, 4, seed=0, a=0.45, b=0.15, c=0.15,
                           permute=False),
    lambda g: g.erdos_renyi_graph(300, 1000, seed=7),
    lambda g: g.grid_graph(7, 9),
    lambda g: g.ring_graph(11),
    lambda g: g.path_graph(12),
    lambda g: g.star_graph(13),
], ids=["rmat", "rmat_noperm", "er", "grid", "ring", "path", "star"])
def test_generators_bit_identical(make):
    ref, port = make(jgen), make(tgen)
    assert isinstance(port, EdgeList)
    assert port.u.dtype == torch.int32 and port.v.dtype == torch.int32
    assert port.num_vertices == ref.num_vertices
    assert port.num_edges == ref.num_edges
    np.testing.assert_array_equal(port.u.numpy(), np.asarray(ref.u))
    np.testing.assert_array_equal(port.v.numpy(), np.asarray(ref.v))


@pytest.mark.parametrize("graph", ["rmat", "er", "grid", "star"])
@pytest.mark.parametrize("policy", ["none", "degree", "bfs", "greedy"])
def test_reorder_perms_equal(graph, policy):
    jg, tg = _graph(graph)
    ref = jreorder.reorder_vertices(jg, policy, window=128)
    port = treorder.reorder_vertices(tg, policy, window=128)
    assert port.policy == ref.policy
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_array_equal(port.inv, ref.inv)
    assert treorder.intra_window_fraction(tg, 128, port) == \
        jreorder.intra_window_fraction(jg, 128, ref)


def test_greedy_argmax_oracle_equal():
    jg, tg = _graph("rmat")
    ref = jreorder._reorder_greedy_argmax(jg, 128)
    port = treorder._reorder_greedy_argmax(tg, 128)
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_array_equal(
        port.perm, treorder._reorder_greedy(tg, 128).perm)


@pytest.mark.parametrize("window,tile", [(128, 64), (256, 32)])
@pytest.mark.parametrize("policy", ["none", "degree", "bfs", "greedy"])
@pytest.mark.parametrize("graph", ["rmat", "er", "grid", "star"])
def test_window_schedule_fields_equal(graph, policy, window, tile):
    jg, tg = _graph(graph)
    ref = j_build(jg, window, tile, reorder=policy)
    port = build_window_schedule(tg, window, tile, reorder=policy)
    assert_schedules_equal(ref, port)


def test_window_schedule_options_equal():
    """Undispersed, uncoalesced, and a precomputed reordering."""
    jg, tg = _graph("rmat")
    ref = j_build(jg, 128, 64, dispersed=False, coalesce_sparse=False)
    port = build_window_schedule(tg, 128, 64, dispersed=False,
                                 coalesce_sparse=False)
    assert_schedules_equal(ref, port)
    jr = jreorder.reorder_vertices(jg, "bfs")
    tr = treorder.reorder_vertices(tg, "bfs")
    assert_schedules_equal(j_build(jg, 128, 64, reordering=jr),
                           build_window_schedule(tg, 128, 64, reordering=tr))


def test_schedule_from_arrays_round_trip():
    jg, _ = _graph("er")
    ref = j_build(jg, 128, 64, reorder="degree")
    port = schedule_from_arrays(dataclasses.asdict(ref))
    assert isinstance(port, WindowSchedule)
    assert_schedules_equal(ref, port)
    with pytest.raises(ValueError, match="unknown WindowSchedule fields"):
        schedule_from_arrays({"not_a_field": 1})
