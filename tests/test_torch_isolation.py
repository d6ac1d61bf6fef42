"""The port stands alone and never falls back: it imports neither jax nor
the JAX package, its entry points default to the CUDA device and raise
without one, ``backend="cuda"`` refuses CPU tensors, and its kernels are
built for sm_90a from sources the package ships."""
import ast
import fnmatch
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import engine
from repro_torch.core.statespec import StateSpec
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.graphs import path_graph
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.skipper_match import (
    kernel,
    skipper_match,
    skipper_match_window,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_loads_no_jax_and_no_reference():
    script = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 15


def test_analysis_and_roofline_load_no_jax_and_no_reference():
    """The analyzer and the roofline models stand alone too: importing all
    of ``repro_torch.analysis`` (rules, targets, mutations, the CLI) and
    ``repro_torch.roofline`` loads neither jax nor the JAX package."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.analysis, repro_torch.roofline\n"
        "names = ['repro_torch.analysis.__main__']\n"
        "for pkg in (repro_torch.analysis, repro_torch.roofline):\n"
        "    names += [m.name for m in pkgutil.walk_packages(\n"
        "        pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 15


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "examples" / "moe_matching_router_torch.py",
    ROOT / "experiments" / "print_table_torch.py",
    ROOT / "experiments" / "sharded_step_torch.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skipper_match(path_graph(10))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skipper_match(path_graph(10), device="cuda")


def test_match_window_default_device_raises_without_cuda(monkeypatch):
    """``skipper_match_window`` runs on the card unless given the CPU, as
    the other entry points do: without a card it raises, naming itself,
    even for CPU tensors; with ``device="cpu"`` it runs the plain version
    and launches nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u = torch.arange(8, dtype=torch.int32)
    st0 = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device: "
                       "skipper_match_window"):
        skipper_match_window(u, u + 1, st0, tile_size=8)
    kernel.reset_launch_counts()
    state, matched, _ = skipper_match_window(u, u + 1, st0, tile_size=8,
                                             device="cpu")
    assert state.device.type == "cpu" and int(matched.sum()) == 4
    assert set(kernel.launch_counts().values()) == {0}


@pytest.mark.parametrize("entry", ["skipper", "ems_israeli_itai",
                                   "ems_idmm", "sidmm"])
def test_raw_stream_and_baselines_default_to_the_card(monkeypatch, entry):
    """``skipper`` and the three EMS baselines run on the card unless given
    the CPU: without a card they raise, naming themselves, even for CPU
    edges; with ``device="cpu"`` they run there and launch nothing."""
    from repro_torch import core

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(core, entry)
    g = path_graph(40)
    with pytest.raises(RuntimeError, match=f"no CUDA device: {entry} runs"):
        fn(g)
    with pytest.raises(RuntimeError, match=f"no CUDA device: {entry}"):
        fn(g, device="cuda")
    kernel.reset_launch_counts()
    out = fn(g, device="cpu")
    res = out[0] if entry == "skipper" else out
    assert res.match_mask.device.type == "cpu"
    assert int(res.match_mask.sum()) > 0
    assert set(kernel.launch_counts().values()) == {0}


@pytest.mark.parametrize("default", ["cpu", "cuda"])
def test_resolve_device_default_and_refusal(monkeypatch, default):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu", default, "f") == torch.device("cpu")
    if default == "cpu":
        assert resolve_device(None, default, "f") == torch.device("cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device: f runs"):
            resolve_device(None, default, "f")


def test_load_declares_each_library_once(monkeypatch, tmp_path):
    """``_build.load`` is the one cache of loaded libraries: a second load
    of a source returns the same library without declaring it again."""
    import ctypes.util

    libc = ctypes.util.find_library("c")
    monkeypatch.setattr(_build, "build", lambda source: {
        str(source): {"path": libc}})
    source = tmp_path / "k.cu"
    declared = []
    first = _build.load(source, declared.append)
    assert _build.load(source, declared.append) is first
    assert declared == [first]
    _build.load.cache_clear()


def test_cuda_backend_refuses_cpu_tensors():
    g = path_graph(40)
    with pytest.raises(ValueError, match="backend='cuda'"):
        skipper_match(g, device="cpu", backend="cuda")
    u = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="backend='cuda'"):
        skipper_match_window(u, u + 1, torch.zeros(16, dtype=torch.uint8),
                             tile_size=8, backend="cuda", device="cpu")
    rows = u.reshape(1, 8)
    with pytest.raises(ValueError, match="backend='cuda'"):
        engine.window_tier_pass(rows, rows, window=16, tiles_per_window=1,
                                tile_size=8, vector_rounds=1, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        skipper_match(g, device="cpu", backend="xla")


@pytest.mark.parametrize("backend, device, want", [
    (None, "cpu", "torch"), (None, "cuda", "cuda"), ("torch", "cuda", "torch"),
    ("cuda", "cpu", "backend='cuda' launches CUDA kernels"),
    ("xla", "cpu", "unknown backend 'xla'"),
    ("xla", "cuda", "unknown backend 'xla'")])
def test_resolve_backend_is_every_entry_points_rule(backend, device, want):
    """``device.resolve_backend`` is the one rule: ``None`` by the device,
    ``"cuda"`` refused off the card, an unknown name refused; and every
    entry point and engine pass given CPU tensors refuses with its words,
    ``engine.stream_pass`` included."""
    from repro_torch.core.distributed import distributed_skipper

    if not want.startswith(("backend", "unknown")):
        assert resolve_backend(backend, torch.device(device)) == want
        return
    with pytest.raises(ValueError, match=re.escape(want)) as err:
        resolve_backend(backend, torch.device(device))
    if device != "cpu":
        return
    g, ids = path_graph(40), torch.full((8,), -1, dtype=torch.int32)
    rows, said = ids.reshape(1, 8), re.escape(str(err.value))
    for call in (
            lambda: skipper_match(g, device="cpu", backend=backend),
            lambda: skipper_match_window(
                ids, ids, torch.zeros(16, dtype=torch.uint8), tile_size=8,
                backend=backend, device="cpu"),
            lambda: distributed_skipper(g, device="cpu", backend=backend),
            lambda: engine.stream_pass(
                torch.zeros(4, dtype=torch.uint8), ids, ids, n=4,
                vector_rounds=1, tile_size=8, backend=backend),
            lambda: engine.window_tier_pass(
                rows, rows, window=16, tiles_per_window=1, tile_size=8,
                vector_rounds=1, backend=backend)):
        with pytest.raises(ValueError, match=said):
            call()


def _imported(path: Path):
    """Every module a source file imports, at any depth of its code, each
    ``from M import n`` as ``M.n``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _under(name: str, module: str) -> bool:
    return name == module or name.startswith(module + ".")


#: the matchers' seam points one way: entry points -> engine passes ->
#: ``kernel.py`` -> the CUDA library; (importer, module it must not import,
#: the one part of that module it may)
ARROWS = [
    ("core/engine.py", "repro_torch.core.skipper", None),
    ("core/engine.py", "repro_torch.kernels.skipper_match.ops", None),
    ("core/distributed.py", "repro_torch.kernels.skipper_match.ops", None),
    ("kernels/skipper_match/kernel.py", "repro_torch.core",
     "repro_torch.core.statespec"),
]


@pytest.mark.parametrize("importer, banned, allowed", ARROWS)
def test_import_arrows_point_one_way(importer, banned, allowed):
    bad = sorted(name for name in _imported(PKG / importer)
                 if _under(name, banned)
                 and not (allowed and _under(name, allowed)))
    assert not bad, f"{importer} imports {bad}"


@pytest.mark.parametrize("name, home", [
    ("tiles_on_card", "kernels/skipper_match/kernel.py"),
    ("resolve_backend", "device.py")])
def test_seam_is_defined_once(name, home):
    homes = sorted(
        str(path.relative_to(PKG)) for path in PKG.rglob("*.py")
        for node in ast.walk(ast.parse(path.read_text()))
        if isinstance(node, ast.FunctionDef) and node.name == name)
    assert homes == [home]


def test_cpu_default_backend_is_plain():
    kernel.reset_launch_counts()
    r = skipper_match(path_graph(40), window=16, tile_size=8, device="cpu")
    assert int(r.match_mask.sum()) == 20
    assert kernel.launch_counts() == {kernel.WINDOW_TIER: 0,
                                      kernel.WINDOW_ASYNC: 0,
                                      kernel.BOUNDARY: 0,
                                      kernel.BOUNDARY_ASYNC: 0}


def _check_nvcc_command(source):
    out = _build.library_path(source)
    cmd = _build.nvcc_command(source, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert out.parent == ROOT / "build" / "repro_torch"
    assert out.name.startswith(f"lib{source.stem}_")
    assert "-shared" in cmd and str(source) == cmd[-1]
    assert source.exists()


def _check_package_data(source):
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["repro_torch"]
    rel = source.relative_to(PKG).as_posix()
    assert any(fnmatch.fnmatch(rel, p) for p in patterns), (rel, patterns)


def test_nvcc_command_targets_sm90a_under_build():
    _check_nvcc_command(kernel.SOURCE)


def test_flash_nvcc_command_targets_sm90a_under_build():
    _check_nvcc_command(flash_kernel.SOURCE)


def test_cuda_source_is_package_data():
    _check_package_data(kernel.SOURCE)


def test_mutant_source_is_package_data_and_builds_like_the_rest():
    from repro_torch.analysis import mutations

    _check_package_data(mutations.SOURCE)
    _check_nvcc_command(mutations.SOURCE)


def test_ptx_command_keeps_the_target_and_flags():
    """The PTX build is the library build's target and flags, stopped at
    PTX, into build/repro_torch/."""
    out = _build.ptx_path(kernel.SOURCE)
    cmd = _build.ptx_command(kernel.SOURCE, out)
    lib = _build.nvcc_command(kernel.SOURCE, out)
    assert "arch=compute_90a,code=compute_90a" in cmd and "-ptx" in cmd
    assert out.parent == ROOT / "build" / "repro_torch"
    assert out.name.startswith("skipper_match_") and out.suffix == ".ptx"
    assert [a for a in cmd if a.startswith("-std") or a == "-O3"] == \
        [a for a in lib if a.startswith("-std") or a == "-O3"]


def test_flash_cuda_source_is_package_data():
    _check_package_data(flash_kernel.SOURCE)


def test_tensor_core_flash_source_builds_like_the_rest():
    """The wgmma kernel's source is package data and is built by the same
    nvcc command (sm_90a, plain C interface, no -lcuda: the tensor map
    encoder comes through the runtime's driver entry point)."""
    _check_package_data(flash_kernel.WGMMA_SOURCE)
    _check_nvcc_command(flash_kernel.WGMMA_SOURCE)
    cmd = _build.nvcc_command(flash_kernel.WGMMA_SOURCE,
                              _build.library_path(flash_kernel.WGMMA_SOURCE))
    assert not any(c.startswith("-lcuda") for c in cmd)
    text = flash_kernel.WGMMA_SOURCE.read_text()
    assert "cudaGetDriverEntryPoint" in text and "__grid_constant__" in text


def test_cuda_marker_registered():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    markers = cfg["tool"]["pytest"]["ini_options"]["markers"]
    assert any(m.startswith("cuda:") for m in markers)


def test_shared_memory_budget():
    """u8 state at the full-scale window fits one block; int32 does not,
    and the wrapper must raise for it rather than fall back."""
    u8 = kernel.window_tier_smem_bytes(65536, 256, StateSpec.u8())
    i32 = kernel.window_tier_smem_bytes(65536, 256, StateSpec.legacy_i32())
    assert u8 == 65536 + 9 * 256 <= kernel.MAX_SMEM_BYTES < i32
    assert kernel.window_tier_smem_bytes(3, 4) == 4 + 36


def test_window_async_shared_memory_and_instance():
    """The asynchronous window tier's shared memory and the shape rule that
    picks its ring depth and its kernel. At the full-scale configuration
    (u8, window 65536, tile 256) the row, a 4-stage ring of 16 tiles and
    the static arrays fit; legacy_i32 at tile 256 keeps a 1-stage ring up
    to window 47,532 and takes the first kernel from 47,536 (the next
    16-byte row); a row that is not whole 16-byte units takes the first
    kernel too."""
    u8, i32 = StateSpec.u8(), StateSpec.legacy_i32()
    assert kernel.WINDOW_ASYNC_STATIC_SMEM == 9_544
    stage = kernel.window_stage_bytes(256)
    assert stage == 8 * kernel.WINDOW_STAGE_TILES * 256 == 32_768
    assert kernel.window_ring_stages(65536, 256, u8) == 4
    full = kernel.window_async_smem_bytes(65536, 256, u8)
    assert full == 65536 + 4 * stage
    assert full + kernel.WINDOW_ASYNC_STATIC_SMEM == 206_152
    assert full + kernel.WINDOW_ASYNC_STATIC_SMEM <= kernel.MAX_SMEM_BYTES
    assert kernel.window_instance(65536, 256, u8) == "async"
    # a wider tile, a narrower window: the deepest ring that fits
    assert kernel.window_ring_stages(65536, 1024, u8) == 1
    assert kernel.window_ring_stages(2048, 256, u8) == 6
    assert kernel.window_ring_stages(256, 64, u8) == kernel.WINDOW_RING_STAGES
    # the edge where the ring stops fitting beside an int32 row
    edge = kernel.window_async_smem_bytes(47_532, 256, i32, 1)
    assert edge + kernel.WINDOW_ASYNC_STATIC_SMEM <= kernel.MAX_SMEM_BYTES
    assert kernel.window_ring_stages(47_532, 256, i32) == 1
    assert kernel.window_instance(47_532, 256, i32) == "async"
    over = kernel.window_async_smem_bytes(47_536, 256, i32, 1)
    assert over + kernel.WINDOW_ASYNC_STATIC_SMEM > kernel.MAX_SMEM_BYTES
    assert kernel.window_ring_stages(47_536, 256, i32) == 0
    assert kernel.window_instance(47_536, 256, i32) == "sync"
    # ... where the first kernel still fits
    assert (kernel.window_tier_smem_bytes(47_536, 256, i32)
            <= kernel.MAX_SMEM_BYTES)
    assert kernel.window_instance(65536, 256, i32) == "sync"
    # rows padded to 16 bytes; a row of 100 u8 cells is not whole units
    assert kernel.window_async_smem_bytes(100, 128, u8, 0) == 112
    assert kernel.window_instance(100, 128, u8) == "sync"
    assert kernel.window_instance(96, 128, u8) == "async"
    assert kernel.window_instance(100, 128, i32) == "async"


def test_window_wrappers_on_cpu():
    """On CPU tensors ``window_tier`` runs the plain version and refuses a
    cycle profile; ``window_tier_sync`` launches a CUDA kernel only."""
    u = torch.full((1, 64), -1, dtype=torch.int32)
    st0 = torch.zeros((1, 32), dtype=torch.uint8)
    prof = torch.zeros(len(kernel.WINDOW_PROFILE_FIELDS), dtype=torch.int64)
    with pytest.raises(ValueError, match="profile"):
        kernel.window_tier(u, u, st0, tile_size=64, profile=prof)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel.window_tier_sync(u, u, st0, tile_size=64)


def test_launch_counts_reset():
    for _ in range(3):
        tracing.launched(kernel.WINDOW_TIER)
    assert kernel.launch_counts()[kernel.WINDOW_TIER] >= 3
    kernel.reset_launch_counts()
    assert set(kernel.launch_counts().values()) == {0}


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a card, or copied away from the repository, chip_smoke.py
    exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=300,
                              cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_statespec_dtype_table_matches_reference_names():
    from repro_torch.core import statespec

    assert statespec._DTYPES == {"uint8": torch.uint8, "int32": torch.int32}
    assert StateSpec.legacy_i32().vmem_dtype == torch.int32
    with pytest.raises(ValueError, match="overflows"):
        StateSpec.u8().validate_rounds(256)
    assert StateSpec.u8().validate_capacity(255)
    assert not StateSpec.u8().validate_capacity(256)
    with pytest.raises(ValueError):
        StateSpec(vmem="int8")
    assert np.dtype(str(StateSpec.u8().counter_dtype).split(".")[1]) == np.uint8


def test_kernel_id_range_check():
    """The check the wrappers run before a launch: padding is (-1, -1),
    other ids lie in range."""
    from repro_torch.kernels.skipper_match.kernel import _ids_ok

    u = torch.tensor([[0, -1, 3]], dtype=torch.int32)
    v = torch.tensor([[1, -1, 3]], dtype=torch.int32)
    assert bool(_ids_ok(u, v, 4, 4))
    assert not bool(_ids_ok(u, v, 3, 4))
    assert not bool(_ids_ok(u, v, 4, 3))
    assert not bool(_ids_ok(torch.tensor([0]), torch.tensor([-1]), 4, 4))
    assert not bool(_ids_ok(torch.tensor([-2]), torch.tensor([-2]), 4, 4))
    assert bool(_ids_ok(u[:, :0], v[:, :0], 1, 1))
