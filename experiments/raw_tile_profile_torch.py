"""The raw stream's global-tier kernel at the benchmark's raw shapes: its
time a tile and its cycle profile, on the card.

    python3 experiments/raw_tile_profile_torch.py \\
        --out build/raw_tile_profile.json [--seed 7] [--repeats 2] \\
        [--configs graph500-kron-s22 gapbs-urand-s22 graph500-kron-s26] \\
        [--scales 22 23 24 25 26]

For each configuration of ``bench/configs`` (and, with ``--scales``, for
``graph500-kron-s22``'s generator at each scale) the graph comes from the
bench's generator on the card for ``--seed``, and is laid out as
``skipper()`` lays out the ``raw-resident`` mix (tiles of 512, dispersed).
The tiles then run through ``kernel.boundary_tier`` on one state row, in
the instance ``skipper()`` takes there (``kernel.tiles_on_card``: the
filtered one where ``kernel.takes_filtered`` says so, with the share of
lanes its filter passed on): timed with CUDA events (one warm launch, then
``--repeats``), then once with the cycle profile of the single-block
instance the shape picks (``kernel.boundary_instance``; the filtered one
has none). Every launch's state, matched and conflicts are held bit for bit
against the first, and their SHA-256 is printed, so that two versions of
the kernel run in one call can be compared at full scale. One JSON line a
shape on stdout; all of them, with the card's name and power limit, in
``--out``. It reads ``kernel.PROFILE_FIELDS`` (and the filter's names where
the kernel has them), so it runs against any version of ``src/`` on
``PYTHONPATH``. It needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TILE = 512


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def shape_profile(name: str, config: dict, seed: int, repeats: int) -> dict:
    from bench.generators import generate
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.graphs.types import EdgeList
    from repro_torch.kernels.skipper_match import kernel

    dev = torch.device("cuda")
    g = generate(config, seed, dev)
    ut, vt = stream_tiles(EdgeList(g.u, g.v, g.n), TILE)
    n, tiles = g.n, ut.shape[0]
    del g
    pairs = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    profiled = kernel.boundary_instance(n, TILE)
    takes_filtered = getattr(kernel, "takes_filtered", None)
    instance = (kernel.FILTERED if takes_filtered is not None
                and takes_filtered(tiles, TILE, dev) else profiled)
    survivors = (torch.zeros((), dtype=torch.int64, device=dev)
                 if instance != profiled else None)

    def launch(profile=None):
        row = torch.zeros((1, n), dtype=torch.uint8, device=dev)
        kw = ({} if survivors is None or profile is not None
              else {"survivors": survivors})
        out = kernel.boundary_tier(
            row, pairs, pairs, ut, vt, profile=profile,
            instance=profiled if profile is not None else instance, **kw)
        return (row, *out)

    first = launch()
    torch.cuda.synchronize()
    times = []
    same = True
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        got = launch()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        same &= all(torch.equal(a, b) for a, b in zip(got, first))
        del got
    passed = None if survivors is None else int(survivors) / (repeats + 1)
    prof = torch.zeros(len(kernel.PROFILE_FIELDS), dtype=torch.int64,
                       device=dev)
    got = launch(prof)
    torch.cuda.synchronize()
    same &= all(torch.equal(a, b) for a, b in zip(got, first))
    cyc = dict(zip(kernel.PROFILE_FIELDS, prof.tolist()))
    per_tile = {f"{k}_per_tile": v / tiles for k, v in cyc.items()}
    return {
        "shape": name, "scale": int(config["scale"]), "n": n,
        "tiles": tiles, "instance": instance, "profiled": profiled,
        "survivor_pct": None if passed is None
        else 100.0 * passed / int(((ut >= 0) & (ut != vt)).sum()),
        "ms": times,
        "us_a_tile": 1e3 * min(times) / tiles, "same_every_launch": same,
        "sha256": digest(*first), "cycles": cyc, **per_tile,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--configs", nargs="*", default=[
        "graph500-kron-s22", "gapbs-urand-s22", "graph500-kron-s26"])
    ap.add_argument("--scales", nargs="*", type=int, default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    shapes = []
    for name in args.configs:
        cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                         .read_text())
        shapes.append((name, cfg))
    if args.scales:
        base = json.loads((ROOT / "bench" / "configs"
                           / "graph500-kron-s22.json").read_text())
        shapes += [(f"kron-scale{s}", {**base, "scale": s})
                   for s in args.scales]
    lines = []
    t0 = time.perf_counter()
    for name, cfg in shapes:
        line = shape_profile(name, cfg, args.seed, args.repeats)
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    out = {"card": card(), "torch": torch.__version__, "seed": args.seed,
           "seconds": time.perf_counter() - t0, "shapes": lines}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(x["same_every_launch"] for x in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
