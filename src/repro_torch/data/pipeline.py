"""Deterministic, shardable synthetic data pipeline (port of
``repro.data.pipeline``, a numpy copy: its batches are the reference's bit
for bit).

Every (step, host) pair maps to its own slice of an endless deterministic
token stream, so a restart resumes exactly (a checkpoint stores only the
step), adding or removing hosts re-shards the stream without replay, and
no host reads another's slice. The corpus is Zipf-distributed tokens in
documents of power-law lengths, which gives the matching packer
(``data/packing.py``) real work.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_per_host: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    mean_doc_len: int = 512
    pack: bool = True


def _doc(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    length = int(np.clip(rng.pareto(1.5) * cfg.mean_doc_len * 0.5 + 16, 16,
                         cfg.seq_len))
    toks = rng.zipf(1.3, size=length)      # Zipf tokens, clipped to vocab
    return np.clip(toks, 1, cfg.vocab_size - 1).astype(np.int32)


def documents_for_step(step: int, cfg: DataConfig, count: int) -> list:
    """Deterministic document batch for (step, host)."""
    seed = (cfg.seed * 1_000_003 + step) * 4099 + cfg.host_id
    rng = np.random.default_rng(seed)
    return [_doc(rng, cfg) for _ in range(count)]


def batch_for_step(step: int, cfg: DataConfig, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``(tokens [B, S] int32, loss_mask [B, S] bool)`` of this host at
    ``step``, as numpy arrays.

    With ``cfg.pack`` the documents are packed by the maximal-matching
    packer, which matches on ``device`` (``None``: the card); otherwise
    each row is one truncated or padded document."""
    from repro_torch.data.packing import pack_documents  # lazy: torch

    docs = documents_for_step(step, cfg, cfg.batch_per_host * 2)
    if cfg.pack:
        return pack_documents(docs, cfg.batch_per_host, cfg.seq_len,
                              device=device)
    rows = np.zeros((cfg.batch_per_host, cfg.seq_len), np.int32)
    mask = np.zeros((cfg.batch_per_host, cfg.seq_len), bool)
    for i in range(cfg.batch_per_host):
        d = docs[i][: cfg.seq_len]
        rows[i, : len(d)] = d
        mask[i, : len(d)] = True
    return rows, mask


def stream(cfg: DataConfig, start_step: int = 0, device=None
           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield batch_for_step(step, cfg, device=device)
        step += 1
