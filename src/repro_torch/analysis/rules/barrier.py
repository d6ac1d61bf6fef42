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

Two atomics (``atom``/``red`` on shared memory) with no barrier between
them never tear, but the order in which lanes' atomics land is the
hardware's. A pair of them is accepted only for a kernel named in
:data:`ATOMIC_ORDERED`, with the reason its result does not depend on
that order; every pair in which either access is a plain load or store is
checked as above, there too.

Asynchronous copies (``build.py``: TMA, bulk copies, ``cp.async``) are
ordered by mbarriers, not by CTA barriers, and a CTA barrier does not
order them:

* an async write into a region (a ring stage the copy engine fills) is
  ordered before a later generic access only by a wait on the mbarrier it
  completes on (``mbarrier.try_wait`` on a barrier of the same region; a
  ``cp.async`` attached to none completes at ``cp.async.wait_group``, and
  other lanes then need a CTA barrier). A stage read with no wait on its
  barrier on the path is a RAW ERROR, whatever CTA barriers lie between.
* a generic read of a region is ordered before a later async write into
  it (the stage's reuse) by a CTA barrier, or by this thread's
  ``mbarrier.arrive`` (the consumer's release, which the producer waits
  on before it refills the stage). With neither, it is a WAR ERROR.
* an async read (a bulk store out of shared memory) is ordered before a
  later write of its region only by ``cp.async.bulk.wait_group``; a
  ``wgmma.mma_async``'s read of its operands (``build.py``: the regions
  its descriptors point into) only by ``wgmma.wait_group 0``.

Generic stores followed by an async write or read of the region need a CTA
barrier as any other pair does. They also need the generic-to-async proxy
fence: a generic store (or atomic) to a shared region followed, on some
path, by an async-proxy read of that region (a bulk store out of shared
memory, or a ``wgmma.mma_async`` whose descriptor points into it) with no
``fence.proxy.async`` on shared memory between them is a PROXY ERROR. A CTA
barrier does not stand in for the fence: the writer fences its own writes
(``fence.proxy.async``, then the barrier, then the bulk store or the
product).
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

#: kernels whose shared atomics may land in any order between two barriers,
#: by name, with the reason the result does not depend on it
ATOMIC_ORDERED: Dict[str, str] = {
    "skipper_boundary_async_kernel": (
        "the filtered instance's in-order block inserts cells into open-"
        "addressed tables with atomicCAS (a key lands in one slot, whichever "
        "lane inserts it first), marks shared cells with atomicOr, claims "
        "with atomicMin (commutative) and commits with atomicExch to 0, "
        "which no claim undoes; the other instances take no shared atomic"),
}

#: pending generic access: (line, kind, region, ordered by a warp barrier
#: since, released by this thread's mbarrier arrive since)
_Pending = Tuple[int, str, object, bool, bool]
#: pending asynchronous copy: (line, "st" write / "ld" read, region, tag)
_Async = Tuple[int, str, object, object]
#: generic store not yet fenced for the async proxy: (line, region)
_Unfenced = Tuple[int, object]


def _conflicts(a_kind: str, b_kind: str) -> str:
    """"RAW"/"WAR" when an access of kind ``a_kind`` followed by one of
    ``b_kind`` needs a barrier between them, else ""."""
    if a_kind in ("st", "rmw") and b_kind in ("ld", "rmw"):
        return "RAW"
    if a_kind in ("ld", "rmw") and b_kind in ("st", "rmw"):
        return "WAR"
    return ""


def _same(a, b) -> bool:
    """Two regions may alias: equal, either unreadable, or one of a
    ``selp``'s regions (a tuple) equal to one of the other's."""
    if a is None or b is None:
        return True
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return any(x == y for x in a for y in b)


def _after_async(x: _Async, a) -> str:
    """The hazard of access ``a`` after pending async copy ``x``."""
    _, kind, _, _ = x
    if kind == "st":                       # async write pending
        if a.proxy == "generic":
            return "RAW" if a.kind in ("ld", "rmw") else "WAW"
        return "RAW" if a.kind == "ld" else ""
    if a.kind in ("st", "rmw"):            # async read pending
        return "WAR"
    return ""


def _after_generic(p: _Pending, a) -> str:
    """The hazard of access ``a`` after pending generic access ``p``."""
    _, kind, _, _, released = p
    if a.proxy == "generic":
        return _conflicts(kind, a.kind)
    if a.kind == "ld":                     # async read of generic data
        return "RAW" if kind in ("st", "rmw") else ""
    if kind == "ld":                       # the stage's reuse
        return "" if released else "WAR"
    return "WAW"


def _sync(entry, ins, cur: Set[_Pending], asy: Set[_Async],
          unf: Set[_Unfenced]):
    """``(cur, asy, unf)`` after an mbarrier, copy-group, wgmma-group or
    proxy-fence event, or None when ``ins`` is none."""
    ev = entry.sync_event(ins)
    if ev is None:
        return None
    name, reg = ev
    if name == "wait":
        asy = {x for x in asy if not (x[1] == "st" and x[3] != "group"
                                      and _same(x[3], reg))}
    elif name == "arrive":
        cur = {(ln, kd, rg, w, rel or kd == "ld")
               for ln, kd, rg, w, rel in cur}
    elif name == "attach":
        asy = {(ln, kd, rg, reg if tag == "group" else tag)
               for ln, kd, rg, tag in asy}
    elif name == "group_wait":
        done = {x for x in asy if x[3] == "group"}
        asy = asy - done
        cur = cur | {(ln, "st", rg, False, False) for ln, _, rg, _ in done}
    elif name == "bulk_wait":
        asy = {x for x in asy if x[1] != "ld" or x[3] == "wgmma"}
    elif name == "wgmma_wait":
        asy = {x for x in asy if x[3] != "wgmma"}
    elif name == "proxy_fence":
        unf = set()
    return cur, asy, unf


def hazards(entry) -> List[Tuple[int, int, str, bool]]:
    """``(first line, second line, "RAW"/"WAR"/"WAW"/"PROXY",
    warp-ordered)`` for every pair of same-region shared accesses that some
    path joins without what orders them (module docstring)."""
    acc = entry.accesses()
    n = len(entry.blocks)
    preds: List[List[int]] = [[] for _ in range(n)]
    for k, b in enumerate(entry.blocks):
        for s in b.succs:
            preds[s].append(k)
    out_sets: List[Tuple[Set[_Pending], Set[_Async], Set[_Unfenced]]] = [
        (set(), set(), set()) for _ in range(n)]
    found: Set[Tuple[int, int, str, bool]] = set()
    changed = True
    while changed:
        changed = False
        for k, b in enumerate(entry.blocks):
            cur: Set[_Pending] = set()
            asy: Set[_Async] = set()
            unf: Set[_Unfenced] = set()
            for p in preds[k]:
                cur |= out_sets[p][0]
                asy |= out_sets[p][1]
                unf |= out_sets[p][2]
            for ins in b.instrs:
                bar = entry.barrier(ins)
                if bar == "cta":
                    cur = set()
                    continue
                if bar == "warp":
                    cur = {(ln, kd, rg, True, rel)
                           for ln, kd, rg, _, rel in cur}
                    continue
                synced = _sync(entry, ins, cur, asy, unf)
                if synced is not None:
                    cur, asy, unf = synced
                    continue
                a = acc.get(ins.line)
                if a is None:
                    continue
                for p in cur:
                    kind = _after_generic(p, a)
                    if kind and _same(p[2], a.region):
                        found.add((p[0], ins.line, kind, p[3]))
                for x in asy:
                    kind = _after_async(x, a)
                    if kind and _same(x[2], a.region):
                        found.add((x[0], ins.line, kind, False))
                if a.proxy == "async" and a.kind == "ld":
                    for line, region in unf:
                        if _same(region, a.region):
                            found.add((line, ins.line, "PROXY", False))
                if a.proxy == "generic":
                    cur = cur | {(ins.line, a.kind, a.region, False, False)}
                    if a.kind in ("st", "rmw"):
                        unf = unf | {(ins.line, a.region)}
                else:
                    asy = asy | {(ins.line, a.kind, a.region, a.tag)}
            if (cur, asy, unf) != out_sets[k]:
                out_sets[k] = (cur, asy, unf)
                changed = True
    return sorted(found)


class SmemBarrier(KernelRule):
    name = "smem-barrier"

    def check_kernel(self, artifact) -> List[Finding]:
        entry = artifact.ptx
        kernel = demangle(artifact.mangled).name
        acc = entry.accesses()
        findings: List[Finding] = []
        waived = atomic = 0
        racing: Dict[Tuple[str, bool], List[Tuple[int, int]]] = {}
        for first, second, kind, warp in hazards(entry):
            if warp and kernel in WARP_ORDERED:
                waived += 1
            elif (kernel in ATOMIC_ORDERED and kind in ("RAW", "WAR")
                  and acc[first].kind == acc[second].kind == "rmw"):
                atomic += 1
            else:
                racing.setdefault((kind, warp), []).append((first, second))
        for (kind, warp), pairs in sorted(racing.items()):
            first, second = pairs[0]
            order = ("only a __syncwarp (bar.warp.sync) orders them"
                     if warp else "no barrier lies between them")
            second_kind = acc[second].kind
            if kind == "PROXY":
                order = "no fence.proxy.async lies between them"
                second_kind = "async-proxy read"
            findings.append(self.finding(
                Severity.ERROR, artifact.name,
                f"{kind}: {len(pairs)} path(s) run from a shared "
                f"{acc[first].kind} to a shared {second_kind} of the "
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
            + (f" ({WARP_ORDERED[kernel]})" if waived else "")
            + f"; {atomic} pair(s) of atomics accepted"
            + (f" ({ATOMIC_ORDERED[kernel]})" if atomic else ""),
            data={"accesses": len(acc), "blocks": len(entry.blocks),
                  "warp_ordered_pairs": waived, "atomic_pairs": atomic},
        ))
        return findings
