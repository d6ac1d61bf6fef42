"""Where the global tier's filtered instance starts to pay on short
streams: both instances over one state row, timed on the card.

    python3 experiments/filtered_threshold_torch.py \\
        --out build/filtered_threshold.json [--seed 7] [--scale 18] \\
        [--widths 32 256 512] [--tiles 1 2 4 8 16 32 66 132 264 528 1056] \\
        [--repeats 15]

The stream is the raw layout (``stream_tiles``, dispersed) of the graph
that ``bench/configs/graph500-kron-s22.json``'s generator makes at
``--scale`` on the card for ``--seed``. For each tile width and tile count
a call of ``kernel.boundary_tier`` over one row (every tile the pair
(0, 0), ids unchecked) runs in the single-block instance the row's shape
picks (``kernel.boundary_instance``) and in the filtered one, each timed
with CUDA events around the call (the median of ``--repeats`` after one
warm call). Two starting states: ``fresh`` (all ACC, the stream's first
tiles: nearly every lane survives the filter) and ``warm`` (the state
after the first half of the stream, tiles from the second half). The two
instances' state, matched and conflicts are held bit for bit. One JSON
line a (width, state, tiles) on stdout; all of them, with the card's name,
its SM count and its power limit, in ``--out``. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def time_calls(instance, row0, ut, vt, repeats):
    """The median milliseconds of ``repeats`` calls after a warm one, and
    the first call's outputs."""
    from repro_torch.kernels.skipper_match import kernel

    pairs = torch.zeros((ut.shape[0],), dtype=torch.int32, device=ut.device)
    times, first = [], None
    for r in range(repeats + 1):
        row = row0.clone()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        m, c = kernel.boundary_tier(row, pairs, pairs, ut, vt,
                                    instance=instance, check_ids=False)
        stop.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(stop))
        else:
            first = (row, m, c)
    return statistics.median(times), first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--widths", nargs="*", type=int, default=[32, 256, 512])
    ap.add_argument("--tiles", nargs="*", type=int,
                    default=[1, 2, 4, 8, 16, 32, 66, 132, 264, 528, 1056])
    ap.add_argument("--repeats", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bench.generators import generate
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.graphs.types import EdgeList
    from repro_torch.kernels.skipper_match import kernel

    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "bench" / "configs"
                      / "graph500-kron-s22.json").read_text())
    g = generate({**cfg, "scale": args.scale}, args.seed, dev)
    lines, ok = [], True
    for width in args.widths:
        ut, vt = stream_tiles(EdgeList(g.u, g.v, g.n), width)
        n, half = g.n, ut.shape[0] // 2
        single = kernel.boundary_instance(n, width)
        fresh = torch.zeros((1, n), dtype=torch.uint8, device=dev)
        warm = fresh.clone()
        pairs = torch.zeros((half,), dtype=torch.int32, device=dev)
        kernel.boundary_tier(warm, pairs, pairs, ut[:half], vt[:half],
                             instance=single, check_ids=False)
        for state, row0, start in (("fresh", fresh, 0), ("warm", warm, half)):
            for tiles in args.tiles:
                if start + tiles > ut.shape[0]:
                    continue
                u = ut[start:start + tiles].contiguous()
                v = vt[start:start + tiles].contiguous()
                ms_single, want = time_calls(single, row0, u, v,
                                             args.repeats)
                ms_filtered, got = time_calls(kernel.FILTERED, row0, u, v,
                                              args.repeats)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                ok &= same
                line = {"width": width, "state": state, "tiles": tiles,
                        "single": single, "single_ms": ms_single,
                        "filtered_ms": ms_filtered,
                        "filtered_over_single": ms_filtered / ms_single,
                        "same": same}
                print(json.dumps(line), flush=True)
                lines.append(line)
    props = torch.cuda.get_device_properties(dev)
    out = {"card": card(), "sms": props.multi_processor_count,
           "torch": torch.__version__, "seed": args.seed,
           "scale": args.scale, "lines": lines}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
