"""Build and load the port's hand-written CUDA kernels.

Each kernel's source (``<kernel>/csrc/*.cu``) has a plain C interface. At
first use ``nvcc`` compiles it for ``sm_90a`` into ``build/repro_torch/`` at
the repository root, and the library is loaded with ``ctypes``. A built
file's name carries the hash of its source and of the sources that one
includes with ``#include "..."``, so an unchanged source is built once and
reused; each process loads a library at most once. Beside each built file
lies nvcc's log (for a library, the ptxas report of ``-Xptxas=-v``).

:func:`build` takes several sources and runs one ``nvcc`` for each, all
started together; with ``ptx=True`` it writes each source's PTX instead
(the analyzer reads both). Each call that starts nvcc waits for it inside
the span ``kernels.build`` (``repro_torch/tracing.py``), so a kernel built
again inside a traced run shows by name.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch import tracing

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: shared memory one block may use on Hopper (H100 / H200)
MAX_SMEM_BYTES = 232_448


def nvcc_command(source: Path, output: Path) -> List[str]:
    """The nvcc command line that builds ``source`` into ``output``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(output), str(source),
    ]


def ptx_command(source: Path, output: Path) -> List[str]:
    """The nvcc command line that writes the PTX of ``source`` to
    ``output``: :func:`nvcc_command`'s target and flags, stopped at PTX."""
    cmd = nvcc_command(source, output)
    cmd[cmd.index("arch=compute_90a,code=sm_90a")] = (
        "arch=compute_90a,code=compute_90a")
    for flag in ("-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"):
        cmd.remove(flag)
    cmd.insert(cmd.index("-o"), "-ptx")
    return cmd


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_digest(source: Path) -> str:
    """sha256 of ``source`` and, recursively, of the files it includes
    with ``#include "..."`` (resolved beside the including file)."""
    h, seen, todo = hashlib.sha256(), set(), [Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(text)
        todo.extend(path.parent / inc for inc in
                    _LOCAL_INCLUDE.findall(text.decode(errors="replace")))
    return h.hexdigest()[:12]


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}_{_source_digest(source)}.so"


def ptx_path(source: Path) -> Path:
    return BUILD_DIR / f"{Path(source).stem}_{_source_digest(source)}.ptx"


def _log_path(out: Path) -> Path:
    return out.with_name(out.name + ".log")


def build(*sources: Path, ptx: bool = False) -> Dict[str, Dict[str, object]]:
    """Compile every source whose library (with ``ptx=True``, whose PTX)
    does not exist yet, one nvcc process per source, all running at once.
    Returns, per source path, ``{"path", "seconds", "log"}``: ``seconds``
    is 0.0 when the file was already there, and ``log`` is nvcc's log of
    the build that made it. Raises ``RuntimeError`` naming every source
    nvcc failed on."""
    target, command = (ptx_path, ptx_command) if ptx else (library_path,
                                                           nvcc_command)
    results: Dict[str, Dict[str, object]] = {}
    running = []
    for source in sources:
        out = target(source)
        if out.exists():
            log = _log_path(out)
            results[str(source)] = {
                "path": str(out), "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(command(Path(source), tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, out, tmp, proc, time.perf_counter()))
    failed = []
    with tracing.span("kernels.build") if running else nullcontext():
        for source, out, tmp, proc, t0 in running:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{source}: nvcc exit {proc.returncode}\n{log}")
                continue
            _log_path(out).write_text(log)
            os.replace(tmp, out)
            results[str(source)] = {"path": str(out), "seconds": seconds,
                                    "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load(source: Path,
         declare: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed. ``declare``
    sets its functions' ``argtypes`` and ``restype``, once, when the
    library is loaded."""
    lib = ctypes.CDLL(build(source)[str(source)]["path"])
    if declare is not None:
        declare(lib)
    return lib
