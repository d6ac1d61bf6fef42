"""The port's dry-run (``repro_torch.launch.dryrun``), its counts and the
roofline pieces it reads, against the JAX package's on the CPU; the
dry-run's CLI and table; the port's two new examples.

The reference compiles each cell with XLA and the port reckons it, so
only what both compute from the config and the specs is held equal, and
exactly: ``runnable_cells``, ``count_params``, ``active_params``,
``pick_microbatches``, ``model_flops`` for every cell, the per-device
parameter bytes that the reference's specs imply (integers), and
``state_traffic_bytes``.
"""
import importlib
import io
import json
import math
import os
import runpy
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _ref_dryrun():
    """The reference's dry-run module, imported without keeping the
    device count it sets in ``XLA_FLAGS`` for later subprocesses."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _cells():
    from repro_torch.configs import runnable_cells

    return [(a, s) for a, shapes in runnable_cells().items() for s in shapes]


def test_runnable_cells_equal_reference():
    from repro.configs import ARCH_IDS as JIDS, runnable_cells as jcells

    from repro_torch.configs import ARCH_IDS, runnable_cells

    assert runnable_cells() == jcells()
    assert ARCH_IDS == JIDS


@pytest.mark.parametrize("arch,shape", _cells())
def test_counts_and_flops_equal_reference(arch, shape):
    """``count_params`` (the port's model on ``meta``, the reference's
    ``eval_shape``), ``active_params``, ``pick_microbatches`` on both
    production meshes and ``model_flops``."""
    import jax

    from repro.configs import get_config as jget, get_shape as jshape
    from repro.launch import adapters as JA
    from repro.roofline import analysis as jroof

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import adapters, dryrun
    from repro_torch.roofline import analysis

    J = _ref_dryrun()
    cfg, jcfg = get_config(arch), jget(arch)
    sh, jsh = get_shape(shape), jshape(shape)
    tree = jax.eval_shape(lambda: JA.init_fn(jax.random.PRNGKey(0), jcfg))
    n = dryrun.count_params(adapters.abstract_model(cfg))
    assert n == J.count_params(tree)
    assert dryrun.active_params(cfg, n) == J.active_params(jcfg, n)
    for n_fsdp in (16, 32):
        assert (dryrun.pick_microbatches(cfg, sh, n_fsdp)
                == J.pick_microbatches(jcfg, jsh, n_fsdp))
    act = dryrun.active_params(cfg, n)
    assert analysis.model_flops(cfg, sh, act, n) == jroof.model_flops(
        jcfg, jsh, act, n)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted({a for a, _ in _cells()}))
def test_param_bytes_are_the_reference_specs_share(arch, multi_pod):
    """A cell's per-device parameter, gradient and moment bytes are the
    share of every leaf that the reference's specs imply, as integers."""
    import jax

    from repro import compat
    from repro.configs import get_config as jget
    from repro.launch import adapters as JA
    from repro.parallel.sharding import param_specs as jspecs

    from repro_torch.launch import dryrun

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    tree = jax.eval_shape(lambda: JA.init_fn(jax.random.PRNGKey(0),
                                             jget(arch)))
    mom = 2 if jget(arch).opt_state_dtype == "bfloat16" else 4

    def shares(shape, names):
        sizes = dict(zip(names, shape))
        specs = jspecs(tree, compat.abstract_mesh(shape, names))
        want = moments = 0
        for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
            split = 1
            for entry in spec:
                for a in (() if entry is None else
                          (entry,) if isinstance(entry, str) else entry):
                    split *= sizes[a]
            assert math.prod(leaf.shape) % split == 0
            want += math.prod(leaf.shape) * leaf.dtype.itemsize // split
            moments += 2 * math.prod(leaf.shape) * mom // split
        return want, moments

    want, moments = shares(shape, names)
    rec = dryrun.reckon_cell(arch, "train_4k", multi_pod)
    b = rec["bytes_per_device"]
    assert b["params"] == want and b["grads"] == want
    assert b["moments"] == moments
    assert rec["method"] == "reckoned" and rec["chips"] == math.prod(shape)
    # the port's own step: the reference's specs on its run mesh, every
    # chip a data rank; 256 rows do not split over 512 ranks
    port = rec["port"]
    assert port["runs"] == (not multi_pod)
    if port["runs"]:
        want, moments = shares((math.prod(shape), 1), ("data", "model"))
        b = port["bytes_per_device"]
        assert b["params"] == want and b["grads"] == want
        assert b["moments"] == moments


def test_state_traffic_bytes_equal_reference():
    import jax.numpy as jnp
    import torch

    from repro.core.statespec import StateSpec as JS
    from repro.core.types import Counters as JC
    from repro.roofline.analysis import state_traffic_bytes as jstb

    from repro_torch.core.statespec import StateSpec
    from repro_torch.core.types import Counters
    from repro_torch.roofline import analysis, h100

    vals = dict(edge_reads=1234, state_loads=4567, state_stores=890,
                rounds=3)
    for spec, jspec in ((StateSpec.u8(), JS.u8()),
                        (StateSpec.legacy_i32(), JS.legacy_i32())):
        got = analysis.state_traffic_bytes(Counters(**{
            k: torch.tensor(v, dtype=torch.int32) for k, v in vals.items()}),
            spec)
        want = jstb(JC(**{k: jnp.int32(v) for k, v in vals.items()}), jspec)
        for k in ("state_bytes", "edge_bytes", "total_bytes"):
            assert got[k] == want[k]
        assert got["memory_s"] == got["total_bytes"] / h100.HBM_BYTES_PER_S


def test_every_cell_reckons_and_fits(tmp_path, monkeypatch):
    """The whole dry-run through its CLI: every runnable cell on both
    meshes is reckoned (none fails) with the stated keys, into the output
    directory; the table renders them. No tensor is allocated: every
    parameter and cache is on ``meta``."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dryrun.main([]) == 0
    out = buf.getvalue()
    n = 2 * len(_cells())
    assert f"{n} ok, 0 failed" in out and "reckoned, not compiled" in out
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == n
    keys = {"arch", "shape", "mesh", "method", "chips", "microbatches",
            "params_total", "params_active", "model_flops_total",
            "model_flops_per_device", "executed_flops_per_device",
            "useful_flops_ratio", "bytes_per_device", "hbm_bytes_per_device",
            "hbm_capacity_bytes", "fits_hbm", "compute_s", "memory_s",
            "collective_s", "collective_bytes", "dominant", "ok",
            "reckon_s", "port"}
    port_keys = {"ranks", "runs", "bytes_per_device", "hbm_gib", "fits",
                 "collective_bytes", "collective_s"}
    for p in files:
        rec = json.loads(p.read_text())
        assert keys <= set(rec) and rec["ok"] and rec["method"] == "reckoned"
        assert rec["dominant"] in ("compute", "memory", "collective")
        port = rec["port"]
        assert port["ranks"] == rec["chips"]
        assert port_keys <= set(port) if port["runs"] else port["reason"]
    rec = json.loads((tmp_path / "llama3-405b__train_4k__16x16.json")
                     .read_text())
    assert rec["params_total"] > 4e11 and rec["fits_hbm"]
    # the port's step holds its slices, one block and the leaves of no
    # block whole; its serving holds the whole model on every rank
    assert rec["port"]["fits"]
    assert rec["port"]["bytes_per_device"]["gathered"] > 0
    rec = json.loads((tmp_path / "llama3-405b__decode_32k__16x16.json")
                     .read_text())
    assert rec["fits_hbm"] and not rec["port"]["fits"]
    assert rec["port"]["bytes_per_device"]["params"] == 2 * rec[
        "params_total"]
    # a rerun reads the records back
    again = dryrun.run_cell("mamba2-130m", "train_4k", False)
    assert again["reckon_s"] == json.loads(
        (tmp_path / "mamba2-130m__train_4k__16x16.json").read_text())[
            "reckon_s"]
    table = runpy.run_path(os.path.join(ROOT, "experiments",
                                        "print_table_torch.py"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert table["main"](str(tmp_path)) == 0
    assert f"cells: {n} reckoned, 0 failed" in buf.getvalue()


def test_dryrun_cli_writes_one_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch ... --shape ...`` in a
    fresh interpreter writes that cell's record."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import sys; from repro_torch.launch import dryrun; "
            f"dryrun.OUT_DIR = {str(tmp_path)!r}; "
            "sys.exit(dryrun.main(sys.argv[1:]))")
    proc = subprocess.run([sys.executable, "-c", code, "--arch",
                           "qwen1.5-110b", "--shape", "decode_32k",
                           "--single-pod-only"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "1 ok, 0 failed" in proc.stdout
    rec = json.loads((tmp_path / "qwen1_5-110b__decode_32k__16x16.json")
                     .read_text())
    assert rec["arch"] == "qwen1.5-110b" and rec["mesh"] == "16x16"
    assert rec["bytes_per_device"]["cache"] > 0


# ---------------------------------------------------------------- examples --
def test_moe_matching_router_example_equals_jax_example():
    """Assignments, drops, utilisation and largest load of each case:
    the port's example prints what the JAX example prints."""
    port = runpy.run_path(os.path.join(ROOT, "examples",
                                       "moe_matching_router_torch.py"))
    ref = runpy.run_path(os.path.join(ROOT, "examples",
                                      "moe_matching_router.py"))
    got, want = io.StringIO(), io.StringIO()
    with redirect_stdout(got):
        assert port["main"](["--device", "cpu"]) == 0
    with redirect_stdout(want):
        ref["main"]()
    assert got.getvalue() == want.getvalue()
    stats = port["route_stats"](n_exp=8, k=2, skew=5.0, device="cpu")
    assert stats["topk"]["dropped"] > 0
    assert stats["skipper"]["max_load"] <= stats["capacity"]


def test_serve_lm_example_runs_on_the_cpu():
    port = runpy.run_path(os.path.join(ROOT, "examples",
                                       "serve_lm_torch.py"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port["main"](["--device", "cpu"]) == 0
    lines = [x for x in buf.getvalue().splitlines()
             if x.startswith("request ")]
    assert len(lines) == 8 and lines[0].startswith("request 0: 12 tokens")
