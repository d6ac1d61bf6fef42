"""Build and load the port's hand-written CUDA kernels.

Each kernel's source (``<kernel>/csrc/*.cu``) has a plain C interface. At
first use ``nvcc`` compiles it for ``sm_90a`` into ``build/repro_torch/`` at
the repository root, and the library is loaded with ``ctypes``. A library's
file name carries its source's hash, so an unchanged source is built once
and reused; each process loads a library at most once.

:func:`build` takes several sources and runs one ``nvcc`` for each, all
started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

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


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(*sources: Path) -> Dict[str, Dict[str, object]]:
    """Compile every source whose library does not exist yet, one nvcc
    process per source, all running at once. Returns, per source path,
    ``{"path", "seconds", "log"}`` (``seconds`` 0.0 and ``log`` empty when
    the library was already there). Raises ``RuntimeError`` naming every
    source nvcc failed on."""
    results: Dict[str, Dict[str, object]] = {}
    running = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            results[str(source)] = {"path": str(out), "seconds": 0.0,
                                    "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(Path(source), tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, out, tmp, proc, time.perf_counter()))
    failed = []
    for source, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source}: nvcc exit {proc.returncode}\n{log}")
            continue
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
