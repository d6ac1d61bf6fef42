"""Rule: tier-order — each tier walks its tiles in schedule order (the
counterpart of ``rules/dma_order.py``'s write-back order and
``vmem_budget.py``'s ``block-race``: on the TPU the grid's order and the
v-then-u write-back made a later tile see an earlier one's commits; on
Hopper the loop over tiles inside one block must).

The kernel instance runs on a pinned fixture in which consecutive tiles
share a vertex — and, in the global tier, a block pair; over one state row
(role "row") every tile is the pair (0, 0) — so any other order matches a
different edge; its outputs (matched, conflicts, state)
must equal the plain version's in ``kernels/skipper_match/ref.py`` on the
same CUDA tensors, bit for bit. Any difference is an ERROR. The fixture is
numpy-seeded at the canonical geometry; :func:`fixture` builds it on any
device so the CPU tests can show that its two orders differ.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.analysis import targets
from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import KernelRule

#: (blk_u, blk_v) of the global-tier fixture's tiles: tiles 0 and 1 share
#: the pair (0, 1) and vertex 5; a same-block pair last
PAIRS = ((0, 1), (0, 1), (2, 3), (2, 2))
#: the slot-0 edges every row (window tier) or tiles 0 and 1 (global
#: tier) start with: both hold vertex 5, so only one can match
SHARED_VERTEX, FIRST, SECOND = 5, 7, 9


def fixture(role: str, spec, device) -> Dict[str, torch.Tensor]:
    """The pinned inputs of one tier at the canonical geometry, seeded
    with numpy: ``u``, ``v`` (int32 ``[rows, 2 * T]`` for role "window",
    ``[tiles, T]`` for "boundary" and "row"), ``state`` (all ACC,
    ``spec.vmem``; one row for "row") and, for the global tier,
    ``blk_u``/``blk_v``."""
    rng = np.random.default_rng(targets.SEED)
    t, w = targets.TILE, targets.WINDOW
    if role == "window":
        shape = (targets.NUM_WINDOWS, targets.TILES_PER_WINDOW, t)
        u = rng.integers(0, w, shape)
        v = rng.integers(0, w, shape)
        u[:, :, 0] = SHARED_VERTEX
        v[:, 0, 0], v[:, 1, 0] = FIRST, SECOND
        shape2 = (targets.NUM_WINDOWS, targets.TILES_PER_WINDOW * t)
        pad = rng.random(shape2) < 0.25
        pad[:, 0] = pad[:, t] = False
        u, v = u.reshape(shape2), v.reshape(shape2)
        out = {"state": torch.zeros((targets.NUM_WINDOWS, w),
                                    dtype=spec.vmem_dtype, device=device)}
    else:
        row = role == "row"
        bu = np.array([0 if row else p[0] for p in PAIRS])
        bv = np.array([0 if row else p[1] for p in PAIRS])
        shape = (len(PAIRS), t)
        u = rng.integers(0, w, shape)
        # cross-block pairs address the v row as id - W
        cross = (bu != bv)[:, None]
        v = rng.integers(0, w, shape) + np.where(cross, w, 0)
        u[0, 0] = u[1, 0] = SHARED_VERTEX
        v[0, 0], v[1, 0] = (FIRST, SECOND) if row else (w + FIRST,
                                                        w + SECOND)
        pad = rng.random(shape) < 0.25
        pad[:2, 0] = False
        rows = 1 if row else targets.NUM_WINDOWS
        out = {"state": torch.zeros((rows, w), dtype=spec.vmem_dtype,
                                    device=device),
               "blk_u": torch.tensor(bu, dtype=torch.int32, device=device),
               "blk_v": torch.tensor(bv, dtype=torch.int32, device=device)}
    out["u"] = torch.tensor(np.where(pad, -1, u), dtype=torch.int32,
                            device=device)
    out["v"] = torch.tensor(np.where(pad, -1, v), dtype=torch.int32,
                            device=device)
    return out


def run_plain(role: str, x: Dict[str, torch.Tensor], spec,
              reverse: bool = False):
    """The plain version on fixture ``x`` (copied), in schedule order or,
    with ``reverse``, from the last tile to the first; outputs
    ``(state, matched, conflicts)`` in the fixture's tile order."""
    from repro_torch.kernels.skipper_match import ref

    t = targets.TILE
    if role == "window":
        rows = x["u"].shape[0]

        def order(a):
            return a.reshape(rows, -1, t).flip(1).reshape(rows, -1) \
                if reverse else a
        state, matched, conflicts = ref.ref_window_tier(
            order(x["u"]).contiguous(), order(x["v"]).contiguous(),
            x["state"].clone(), tile_size=t, spec=spec)
        return state, order(matched), order(conflicts)
    state = x["state"].clone()

    def order(a):
        return a.flip(0) if reverse else a
    matched, conflicts = ref.ref_boundary_pass(
        state, *(order(x[k]).contiguous()
                 for k in ("blk_u", "blk_v", "u", "v")), spec=spec)
    return state, order(matched), order(conflicts)


def run_kernel(target, x: Dict[str, torch.Tensor]):
    """``target.launch`` on fixture ``x`` (copied); outputs as
    :func:`run_plain`'s."""
    if target.role == "window":
        return target.launch(x["u"], x["v"], x["state"],
                             tile_size=targets.TILE)
    state = x["state"].clone()
    matched, conflicts = target.launch(state, x["blk_u"], x["blk_v"],
                                       x["u"], x["v"])
    return state, matched, conflicts


class TierOrder(KernelRule):
    name = "tier-order"

    def check_kernel(self, artifact) -> List[Finding]:
        t = artifact.target
        if t.role not in ("window", "boundary", "row") or t.launch is None:
            return []
        x = fixture(t.role, t.spec, torch.device("cuda"))
        got = run_kernel(t, x)
        want = run_plain(t.role, x, t.spec)
        names = ("state", "matched", "conflicts")
        counts = torch.stack([(a.to(torch.int64) != b.to(torch.int64)).sum()
                              for a, b in zip(got, want)])
        # the verdict is read on the host, once
        diff = dict(zip(names, counts.tolist()))  # host-sync: ok
        if any(diff.values()):
            return [self.finding(
                Severity.ERROR, t.name,
                f"on the pinned fixture (consecutive tiles share a vertex) "
                f"the kernel differs from the plain version in schedule "
                f"order: " + ", ".join(f"{n} {d} element(s)"
                                       for n, d in diff.items() if d),
                data={"differing": diff})]
        return [self.finding(
            Severity.INFO, t.name,
            "equals the plain version in schedule order on the pinned "
            "fixture", data={"differing": diff})]
