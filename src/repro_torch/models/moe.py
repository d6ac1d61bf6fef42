"""Mixture-of-Experts FFN with two routers (port of ``repro.models.moe``):

* ``topk``    — token-choice top-k; an expert over capacity drops the token.
* ``skipper`` — the paper's technique: the token-expert assignment is a
  capacity-constrained maximal b-matching over the score-sorted candidate
  stream (``core.bipartite.bmatch_assign``), exactly the sequential greedy
  over the score order; capacity is respected by construction.

Tokens are routed in groups of ``GROUP_TOKENS`` (the reference vmaps the
router over groups; here a loop). Expert compute is batched GEMMs over an
``[E, C, D]`` capacity buffer filled by a scatter (``index_add_`` into a
buffer with a drop row) and combined back with the router weights by a
gather; the reference's ``shard_map`` dispatch and combine are local on one
card.

Tie order is the reference's: ``lax.top_k`` puts the lower index first on
equal scores and ``argsort`` is stable, so the port sorts stably
(``torch.sort(..., stable=True)``) and never calls ``torch.topk``, whose
order on ties is unspecified. Integer routing outputs are bit-identical
to the reference's given the same scores.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bipartite import bmatch_assign
from repro_torch.models import layers as L

GROUP_TOKENS = 4096      # routing group size (per-shard capacity domain)
MATCH_TILE = 512         # first-claim tile inside the matcher


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_moe_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The MoE FFN's weights, drawn from ``gen`` on its device."""
    dt = dtype_of(cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": L.dense_init(gen, (d, e), d, torch.float32),
        "experts_gate": L.dense_init(gen, (e, d, f), d, dt),
        "experts_up": L.dense_init(gen, (e, d, f), d, dt),
        "experts_down": L.dense_init(gen, (e, f, d), f, dt),
    }


def _top(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest per row, descending, lower index first
    among equal scores."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_group_topk(scores: torch.Tensor, k: int):
    """scores [N, E] -> (expert_ids [N*k], weights [N*k], accept [N*k]) in
    per-token top-k order; weights are the softmax over the chosen k."""
    n = scores.shape[0]
    vals, idx = _top(scores, k)
    w = torch.softmax(vals, dim=-1)
    accept = torch.ones((n * k,), dtype=torch.bool, device=scores.device)
    return idx.reshape(-1).to(torch.int32), w.reshape(-1).float(), accept


def route_group_skipper(scores: torch.Tensor, k: int, capacity: int,
                        num_candidates: int):
    """Skipper b-matching routing for one token group.

    scores [N, E] (f32). Returns (expert_ids [M], weights [M], accept [M]),
    M = N * num_candidates, in per-token candidate order."""
    n, e = scores.shape
    kp = num_candidates
    vals, idx = _top(scores, kp)
    flat_tok = torch.arange(n, dtype=torch.int32,
                            device=scores.device).repeat_interleave(kp)
    flat_exp = idx.reshape(-1).to(torch.int32)
    flat_val = vals.reshape(-1)
    order = torch.argsort(-flat_val, stable=True)     # best edges first
    acc_sorted = bmatch_assign(
        flat_tok[order], flat_exp[order],
        num_tokens=n, num_experts=e, token_budget=k,
        expert_capacity=capacity, tile_size=MATCH_TILE,
    )
    accept = torch.zeros((n * kp,), dtype=torch.bool, device=scores.device)
    accept[order] = acc_sorted
    # softmax over each token's accepted candidates
    gated = torch.where(accept, flat_val, -torch.inf).reshape(n, kp)
    w = torch.softmax(gated, dim=-1)
    w = torch.where(torch.isfinite(gated), w, 0.0)
    return flat_exp, w.reshape(-1).float(), accept


def capacity_of(g_tokens: int, cfg: ModelConfig) -> int:
    """Per-group expert capacity: ``max(8, roundup8(int(g*k/e*factor)))``."""
    cap = int(g_tokens * cfg.num_experts_per_tok / cfg.num_experts
              * cfg.moe_capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def slots_of(exp_ids: torch.Tensor, accept: torch.Tensor,
             num_experts: int) -> torch.Tensor:
    """Slot of each accepted edge within its (group, expert): its rank among
    the accepted edges of that segment in stream order. [G, M_g] int32."""
    g, m_g = exp_ids.shape
    e = num_experts
    dev = exp_ids.device
    gid = torch.arange(g, dtype=torch.int32, device=dev).repeat_interleave(m_g)
    key = torch.where(accept.reshape(-1), gid * (e + 1) + exp_ids.reshape(-1),
                      g * (e + 1))
    order = torch.argsort(key, stable=True)
    sorted_key = key[order].contiguous()
    bounds = torch.arange(g * (e + 1) + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    slot_sorted = (torch.arange(g * m_g, dtype=torch.int32, device=dev)
                   - starts[sorted_key.long()])
    slot_of = torch.zeros((g * m_g,), dtype=torch.int32, device=dev)
    slot_of[order] = slot_sorted
    return slot_of.reshape(g, m_g)


def moe_mlp(x: torch.Tensor, p: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n_total = b * s
    xf = x.reshape(n_total, d)
    dev = x.device

    g_tokens = min(GROUP_TOKENS, n_total)
    if n_total % g_tokens:
        raise ValueError(f"{n_total} tokens do not split into groups of "
                         f"{g_tokens}")
    g = n_total // g_tokens
    cap = capacity_of(g_tokens, cfg)

    scores = xf.float() @ p["router"].float()
    scores = torch.log_softmax(scores, dim=-1).reshape(g, g_tokens, e)
    if cfg.moe_router == "skipper":
        kp = min(e, k + 2)
        routed = [route_group_skipper(scores[i], k, cap, kp)
                  for i in range(g)]
    else:
        kp = k
        routed = [route_group_topk(scores[i], k) for i in range(g)]
    exp_ids, weights, accept = (torch.stack(t) for t in zip(*routed))

    m_g = g_tokens * kp
    slots = slots_of(exp_ids, accept, e)                 # [G, M_g]
    ok = accept & (slots < cap) & (weights > 0)

    g_ids = torch.arange(g, dtype=torch.int32, device=dev)[:, None]
    tok_local = torch.arange(m_g, dtype=torch.int32, device=dev)[None] // kp
    tok_global = (g_ids * g_tokens + tok_local).reshape(-1).long()
    col = (g_ids * cap + slots).reshape(-1).long()       # [G*M_g] in [0, G*cap)
    exp_flat = exp_ids.reshape(-1).long()
    w_flat = weights.reshape(-1)
    ok_flat = ok.reshape(-1)
    c_total = g * cap

    # dispatch: buf[e, c] = x[token] for the accepted edges. Every accepted
    # edge owns its (expert, slot); the others land in a drop row.
    cell = torch.where(ok_flat, exp_flat * c_total + col, e * c_total)
    gathered = torch.where(ok_flat[:, None], xf[tok_global], 0)
    buf = torch.zeros((e * c_total + 1, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, cell, gathered)
    buf = buf[:-1].reshape(e, c_total, d)

    h_gate = torch.bmm(buf, p["experts_gate"].to(x.dtype))
    h_up = torch.bmm(buf, p["experts_up"].to(x.dtype))
    h = torch.nn.functional.silu(h_gate.float()).to(x.dtype) * h_up
    y_buf = torch.bmm(h, p["experts_down"].to(x.dtype))

    # combine: out[token] += w * y_buf[e, c]. The edges are token-major
    # (kp candidates a token), so the reference's scatter-add over tokens
    # is a sum over the kp candidates, taken in stream order.
    contrib = y_buf[torch.where(ok_flat, exp_flat, 0),
                    torch.where(ok_flat, col, 0)]
    contrib = contrib * torch.where(ok_flat, w_flat, 0.0)[:, None].to(x.dtype)
    contrib = contrib.reshape(n_total, kp, d)
    out = torch.zeros((n_total, d), dtype=x.dtype, device=dev)
    for j in range(kp):
        out = out + contrib[:, j]
    return out.reshape(b, s, d)
