"""Rule: smem-barrier — shared-memory happens-before on each entry's PTX
(the counterpart of ``rules/dma_order.py``'s DMA happens-before: there a
VMEM read had to follow its copy's ``wait()``; here a shared-memory read
has to follow a CTA barrier after every other lane's write).

On the entry's control-flow graph, every path from a shared store to a
shared load of the same region (read after write), and from a shared load
to a shared store of the same region (write after read), must pass
through a block-wide barrier: ``bar.sync``/``barrier.sync`` or
``bar.red``/``barrier.red`` (``__syncthreads_or`` compiles to
``bar.red.or.pred``). Paths run through loop back-edges, so a write at
the end of one tile meets a read at the start of the next. Regions are
``build.py``'s: the lane-invariant part of the address. An atomic is both
a load and a store.

A path whose only barrier is ``bar.warp.sync`` (``__syncwarp``) orders the
lanes of one warp, not the block. It is accepted only for a kernel named
in :data:`WARP_ORDERED`, with the reason the data it orders never leaves
one warp; everywhere else it is an ERROR like a path with no barrier.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from repro_torch.analysis.build import demangle
from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import KernelRule

#: kernels whose shared data ordered only by ``__syncwarp`` stays inside
#: one warp, by name, with the reason
WARP_ORDERED: Dict[str, str] = {
    "flash_attention_kernel": (
        "a query row's scores (sc) are written and read only by the row's "
        "four lanes, which are consecutive lanes of one warp (blockDim is "
        "block_q * 4, a multiple of 32)"),
}

#: pending access: (line, kind, region, ordered by a warp barrier since)
_Pending = Tuple[int, str, object, bool]


def _conflicts(a_kind: str, b_kind: str) -> str:
    """"RAW"/"WAR" when an access of kind ``a_kind`` followed by one of
    ``b_kind`` needs a barrier between them, else ""."""
    if a_kind in ("st", "rmw") and b_kind in ("ld", "rmw"):
        return "RAW"
    if a_kind in ("ld", "rmw") and b_kind in ("st", "rmw"):
        return "WAR"
    return ""


def hazards(entry) -> List[Tuple[int, int, str, bool]]:
    """``(first line, second line, "RAW"/"WAR", warp-ordered)`` for every
    pair of same-region shared accesses that some path joins without a
    CTA barrier between them."""
    acc = entry.accesses()
    n = len(entry.blocks)
    preds: List[List[int]] = [[] for _ in range(n)]
    for k, b in enumerate(entry.blocks):
        for s in b.succs:
            preds[s].append(k)
    out_sets: List[Set[_Pending]] = [set() for _ in range(n)]
    found: Set[Tuple[int, int, str, bool]] = set()
    changed = True
    while changed:
        changed = False
        for k, b in enumerate(entry.blocks):
            cur: Set[_Pending] = set()
            for p in preds[k]:
                cur |= out_sets[p]
            for ins in b.instrs:
                bar = entry.barrier(ins)
                if bar == "cta":
                    cur = set()
                    continue
                if bar == "warp":
                    cur = {(ln, kd, rg, True) for ln, kd, rg, _ in cur}
                    continue
                a = acc.get(ins.line)
                if a is None:
                    continue
                for ln, kd, rg, warp in cur:
                    kind = _conflicts(kd, a.kind)
                    if kind and (rg is None or a.region is None
                                 or rg == a.region):
                        found.add((ln, ins.line, kind, warp))
                cur = cur | {(ins.line, a.kind, a.region, False)}
            if cur != out_sets[k]:
                out_sets[k] = cur
                changed = True
    return sorted(found)


class SmemBarrier(KernelRule):
    name = "smem-barrier"

    def check_kernel(self, artifact) -> List[Finding]:
        entry = artifact.ptx
        kernel = demangle(artifact.mangled).name
        acc = entry.accesses()
        findings: List[Finding] = []
        waived = 0
        racing: Dict[Tuple[str, bool], List[Tuple[int, int]]] = {}
        for first, second, kind, warp in hazards(entry):
            if warp and kernel in WARP_ORDERED:
                waived += 1
            else:
                racing.setdefault((kind, warp), []).append((first, second))
        for (kind, warp), pairs in sorted(racing.items()):
            first, second = pairs[0]
            order = ("only a __syncwarp (bar.warp.sync) orders them"
                     if warp else "no barrier lies between them")
            findings.append(self.finding(
                Severity.ERROR, artifact.name,
                f"{kind}: {len(pairs)} path(s) run from a shared "
                f"{acc[first].kind} to a shared {acc[second].kind} of the "
                f"same region and {order}; the first from PTX line {first} "
                f"(`{acc[first].instr.text}`) to line {second} "
                f"(`{acc[second].instr.text}`)",
                data={"kind": kind, "warp_ordered": warp,
                      "pairs": [list(pr) for pr in pairs]},
            ))
        findings.append(self.finding(
            Severity.INFO, artifact.name,
            f"{len(acc)} shared accesses in "
            f"{len({a.region for a in acc.values()})} region(s), "
            f"{len(entry.blocks)} blocks; {waived} pair(s) ordered by "
            f"__syncwarp accepted"
            + (f" ({WARP_ORDERED[kernel]})" if waived else ""),
            data={"accesses": len(acc), "blocks": len(entry.blocks),
                  "warp_ordered_pairs": waived},
        ))
        return findings
