"""Replay of the raw stream's survivors: how many lanes are still free when
their tile begins, and how many a filter whose snapshot of the state lags
D tiles passes on to the in-order pass of the global tier's filtered
instance.

    python3 experiments/raw_survivors_replay_torch.py \\
        --out build/raw_survivors.json [--seed 7] [--scales 18 20] \\
        [--configs graph500-kron-s22 gapbs-urand-s22] \\
        [--lags 0 132 264 511] [--batches 132 264 528] [--greedy plain]

For each configuration of ``bench/configs``, with only ``scale`` changed,
the graph comes from the bench's generator for ``--seed`` (on the card
where there is one), laid out as ``skipper()`` lays out the
``raw-resident`` mix: tiles of 512, dispersed. The matching is the
sequential greedy over the lanes in (tile, lane) order, which is what every
tile of the matcher computes given the tiles before it: ``--greedy plain``
walks the edges one at a time on the host (about a minute at scale 20),
``--greedy card`` takes the raw-stream kernel's mask (``tiles_on_card``),
which the tests hold bit for bit to the plain version. From the mask, the
tile that matched each vertex, and then:

* free: a valid lane neither of whose vertices an earlier tile matched;
* survivors at lag D: a valid lane neither of whose vertices a tile before
  t - D matched, the filter's reading once every tile before t - D is
  resolved (the filtered instance's lag lies below its ring's 1,024
  slots, ``kLag``, and starts at 64, ``kRampLag``);
* survivors in batches of B: the snapshot after each whole batch of B
  tiles (tile t reads the state after the tiles before B * (t // B)).

Shares are of the valid lanes (the edges that are no self-loop). One JSON
line a shape on stdout; all of them in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TILE = 512
#: tiles a chunk of the counts (bounds the card's memory at scale 26)
CHUNK = 1 << 14


def greedy_plain(ut: torch.Tensor, vt: torch.Tensor, n: int) -> np.ndarray:
    """The sequential greedy in (tile, lane) order: the tile each vertex
    was matched in, -1 for none."""
    u = ut.cpu().numpy().ravel().tolist()
    v = vt.cpu().numpy().ravel().tolist()
    taken = [-1] * n
    tile = ut.shape[1]
    for k, (a, b) in enumerate(zip(u, v)):
        if a >= 0 and a != b and taken[a] < 0 and taken[b] < 0:
            taken[a] = taken[b] = k // tile
    return np.asarray(taken, dtype=np.int64)


def greedy_card(ut: torch.Tensor, vt: torch.Tensor, n: int) -> torch.Tensor:
    from repro_torch.kernels.skipper_match import kernel

    row = torch.zeros((n,), dtype=torch.uint8, device=ut.device)
    matched, _ = kernel.tiles_on_card(row, ut, vt)
    tiles = torch.arange(ut.shape[0], device=ut.device)[:, None].expand(
        ut.shape)
    taken = torch.full((n,), -1, dtype=torch.int64, device=ut.device)
    for ids in (ut, vt):
        taken[ids[matched].long()] = tiles[matched]
    return taken


def replay(name: str, config: dict, seed: int, lags, batches,
           how: str) -> dict:
    from bench.generators import generate
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.graphs.types import EdgeList

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    g = generate(config, seed, dev)
    ut, vt = stream_tiles(EdgeList(g.u, g.v, g.n), TILE)
    n, tiles = g.n, ut.shape[0]
    del g
    if how == "card":
        taken = greedy_card(ut, vt, n)
    else:
        taken = torch.from_numpy(greedy_plain(ut, vt, n)).to(dev)
    # a vertex never matched reads ACC at every snapshot
    taken = torch.where(taken < 0, tiles, taken)
    valid = free = 0
    per_tile = []
    at_lag = {d: 0 for d in lags}
    in_batch = {b: 0 for b in batches}
    for t0_ in range(0, tiles, CHUNK):
        u, v = ut[t0_:t0_ + CHUNK].long(), vt[t0_:t0_ + CHUNK].long()
        ok = u >= 0
        tu = torch.where(ok, taken[u.clamp(min=0)], -1)
        tv = torch.where(ok, taken[v.clamp(min=0)], -1)
        first = torch.minimum(tu, tv)  # the first tile that took a vertex
        t = torch.arange(t0_, t0_ + u.shape[0], device=dev)[:, None]
        valid += int(ok.sum())
        f = ok & (first >= t)
        free += int(f.sum())
        per_tile.append(f.sum(1).cpu())
        for d in lags:
            at_lag[d] += int((ok & (first >= t - d)).sum())
        for b in batches:
            at_lag_b = ok & (first >= (t // b) * b)
            in_batch[b] += int(at_lag_b.sum())
    counts = torch.cat(per_tile).double()
    out = {
        "shape": name, "scale": int(config["scale"]), "seed": seed,
        "n": n, "tiles": tiles, "valid_lanes": valid, "greedy": how,
        "matched_edges": int((taken < tiles).sum()) // 2,
        "free_pct": 100.0 * free / valid,
        "tiles_with_a_free_lane_pct": 100.0 * float((counts > 0).double()
                                                    .mean()),
        "free_a_tile_median": float(counts.median()),
        "free_a_tile_p99": float(torch.quantile(counts, 0.99)),
        "survivors_pct_at_lag": {str(d): 100.0 * s / valid
                                 for d, s in at_lag.items()},
        "survivors_pct_in_batches": {str(b): 100.0 * s / valid
                                     for b, s in in_batch.items()},
        "seconds": time.perf_counter() - t0,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scales", type=int, nargs="+", default=[18, 20])
    ap.add_argument("--configs", nargs="+",
                    default=["graph500-kron-s22", "gapbs-urand-s22"])
    ap.add_argument("--lags", type=int, nargs="+",
                    default=[0, 132, 264, 511])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[132, 264, 528])
    ap.add_argument("--greedy", choices=("plain", "card"), default="plain")
    args = ap.parse_args(argv)
    lines = []
    for name in args.configs:
        config = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                            .read_text())
        for scale in args.scales:
            line = replay(name, dict(config, scale=scale), args.seed,
                          args.lags, args.batches, args.greedy)
            print(json.dumps(line), flush=True)
            lines.append(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"lines": lines}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
