"""Quickstart for the PyTorch + CUDA port: Skipper maximal matching on a
graph, validated, on one device and across ranks, and under injected
faults.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        --scale 10 --window 128

On a CUDA device the matchers run through the hand-written kernels
(``kernels/skipper_match/csrc``); on the CPU through their plain PyTorch
versions. Exits 0 when every matching checked is valid and maximal.
"""
import argparse
import sys

from repro_torch.core import FaultPlan, check_matching, sgmm, skipper
from repro_torch.core.distributed import distributed_skipper
from repro_torch.graphs import rmat_graph
from repro_torch.kernels.skipper_match import skipper_match


def _checked(label, g, mask):
    """Print and return the check of ``mask`` as Python values."""
    chk = {k: v.item() for k, v in check_matching(g, mask).items()}
    print(f"{label}: {chk['num_matches']:,} matches | valid={chk['valid']} "
          f"maximal={chk['maximal']}")
    return chk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    ap.add_argument("--scale", type=int, default=14,
                    help="RMAT scale of the graph (2^scale vertices)")
    ap.add_argument("--window", type=int, default=2048,
                    help="vertex window of the windowed matchers")
    args = ap.parse_args(argv)
    dev, window = args.device, args.window

    # a Graph500-style RMAT graph (the paper's g500 family)
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=0).to(dev)
    print(f"graph: |V|={g.num_vertices:,} |E|={g.num_edges:,} on {dev}")
    ok = True

    # 1. the single-pass matcher on the raw stream, and the windowed one
    result, _ = skipper(g, tile_size=512, device=dev)
    ok &= _checked("skipper", g, result.match_mask)["maximal"]
    print(f"  accesses/edge = "
          f"{float(result.counters.total_accesses) / g.num_edges:.2f} "
          "(paper band: 1.2-3.4), single pass")
    result = skipper_match(g, window=window, tile_size=256,
                           reorder="degree", device=dev)
    ok &= _checked(f"skipper_match (window {window}, degree)", g,
                   result.match_mask)["maximal"]
    print(f"sgmm (sequential greedy): {int(sgmm(g.to('cpu')).num_matches):,} "
          "matches")

    # 2. across ranks (one rank unless a process group is initialised):
    # the paper's dispersed deal, then the locality-sharded schedule,
    # where each rank's window rows need no communication and only the
    # global tier runs propose / gather / replay
    result, stats = distributed_skipper(g, block_size=512, device=dev)
    ok &= _checked("distributed (dispersed)", g, result.match_mask)["maximal"]
    print(f"  proposals={int(stats.proposals):,} "
          f"lost={int(stats.lost_proposals)} requeued={int(stats.requeued)}")
    result, stats = distributed_skipper(g, reorder="degree", window=window,
                                        block_size=512, device=dev)
    ok &= _checked("distributed (locality-sharded)", g,
                   result.match_mask)["maximal"]
    print(f"  proposals={int(stats.proposals):,} (global tier only) "
          f"gathered_bytes={int(stats.gathered_bytes):,}")

    # 3. graceful degradation (DESIGN.md §11): drop global-tier slots and
    # corrupt state cells, see the damage, then recover it
    chaos = FaultPlan(seed=7, drop_proposals=0.25, corrupt_state=0.05)
    kw = dict(window=window, tile_size=256, reorder="degree", faults=chaos,
              device=dev)
    result, report = skipper_match(g, on_fault="report", **kw)
    _checked("faulted (report)", g, result.match_mask)
    print(f"  residual_edges={report.residual_edges} "
          f"corrupted_cells={report.corrupted_cells}")
    result, report = skipper_match(g, on_fault="recover", verify=True, **kw)
    ok &= _checked("recovered", g, result.match_mask)["maximal"]
    print(f"  attempts={report.recovery_attempts} replayed "
          f"{report.residual_edges} edges -> "
          f"+{report.recovered_matches} matches")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
