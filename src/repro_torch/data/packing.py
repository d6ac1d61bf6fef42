"""Matching-based sequence packing: the paper's technique in the data path
(port of ``repro.data.packing``).

Packing documents into fixed-length rows is a maximal-matching problem on
the compatibility graph: vertices are documents, edge (i, j) iff ``len_i +
len_j <= seq_len``. A matched pair shares a row; an unmatched document gets
its own (truncated) row. One pass of the Skipper matcher
(``core.skipper.skipper``) over the candidate stream replaces the usual
first-fit loop, and its output is maximal: no two leftover rows could have
been merged. On the card that pass is the global-tier kernel
``skipper_boundary_async_kernel``; ``device="cpu"`` runs its plain version.

Candidate edges are sorted by combined fill (big + small first), so the
greedy pass approximates best-fit packing.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.skipper import skipper
from repro_torch.device import resolve_device
from repro_torch.graphs.types import EdgeList


def _candidate_edges(lengths: np.ndarray, seq_len: int,
                     max_degree: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Pair candidates: sort by length and pair each document with the
    largest ones that still fit beside it (up to ``max_degree``)."""
    order = np.argsort(lengths)
    n = len(lengths)
    us, vs = [], []
    for rank_i in range(n):
        i = order[rank_i]
        remaining = seq_len - lengths[i]
        hi = np.searchsorted(lengths[order], remaining, side="right")
        for rank_j in range(max(0, hi - max_degree), hi):
            j = order[rank_j]
            if i < j and lengths[i] + lengths[j] <= seq_len:
                us.append(i)
                vs.append(j)
    if not us:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    u = np.asarray(us, np.int32)
    v = np.asarray(vs, np.int32)
    fill = lengths[u] + lengths[v]
    best_first = np.argsort(-fill, kind="stable")
    return u[best_first], v[best_first]


def pack_documents(docs: List[np.ndarray], num_rows: int, seq_len: int,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pack documents into ``[num_rows, seq_len]`` ``(tokens, loss_mask)``
    numpy arrays. The matching runs on ``device`` (``None``: the card,
    which raises without one; there is no fallback to the CPU)."""
    dev = resolve_device(device, "cuda", "pack_documents")
    lengths = np.asarray([len(d) for d in docs])
    u, v = map(np.asarray, _candidate_edges(lengths, seq_len))
    pairs: List[Tuple[int, ...]] = []
    used = np.zeros(len(docs), bool)
    if len(u):
        edges = EdgeList(torch.from_numpy(u).to(dev),
                         torch.from_numpy(v).to(dev), len(docs))
        result, _ = skipper(edges, tile_size=256, device=dev)
        # the rows are assembled on the host from the matched pairs
        mask = result.match_mask.cpu().numpy()  # host-sync: ok — packer
        for k in np.nonzero(mask)[0]:
            pairs.append((int(u[k]), int(v[k])))
            used[u[k]] = used[v[k]] = True
    singles = [i for i in range(len(docs)) if not used[i]]
    rows = np.zeros((num_rows, seq_len), np.int32)
    loss_mask = np.zeros((num_rows, seq_len), bool)
    slots = pairs + [(i,) for i in singles]
    for r in range(min(num_rows, len(slots))):
        cursor = 0
        for doc_id in slots[r]:
            d = docs[doc_id][: seq_len - cursor]
            rows[r, cursor: cursor + len(d)] = d
            loss_mask[r, cursor: cursor + len(d)] = True
            cursor += len(d)
    return rows, loss_mask


def packing_efficiency(loss_mask: np.ndarray) -> float:
    return float(np.mean(loss_mask))
