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
gather; under a mesh of several data shards the dispatch and combine are
shard-local, as the reference's ``shard_map`` makes them (``moe_mlp``).

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
from repro_torch.parallel import sharding

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


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest per row, descending, lower index first
    among equal scores."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_group_topk(scores: torch.Tensor, k: int):
    """scores [N, E] -> (expert_ids [N*k], weights [N*k], accept [N*k]) in
    per-token top-k order; weights are the softmax over the chosen k."""
    n = scores.shape[0]
    vals, idx = top_k(scores, k)
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
    vals, idx = top_k(scores, kp)
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


def gate_weights(vals: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """The router weights of ``[N, kp]`` candidate scores: the softmax over
    each token's accepted candidates, 0 where not accepted."""
    gated = torch.where(accept, vals, -torch.inf)
    w = torch.softmax(gated, dim=-1)
    return torch.where(torch.isfinite(gated), w, 0.0).reshape(-1).float()


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``t`` from every rank of ``group``, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _experts(xf, p, exp, col, ok, w, num_experts: int, cols: int,
             kp: int) -> torch.Tensor:
    """Dispatch, the expert GEMMs and the combine over a ``[E, cols, D]``
    buffer, for token-major edges (``kp`` a token: edge ``i`` is token
    ``i // kp`` of ``xf``) at column ``col`` of expert ``exp``; only the
    ``ok`` edges move. -> ``[N, D]``."""
    n, d = xf.shape
    e = num_experts
    tok = torch.arange(n * kp, device=xf.device) // kp
    # dispatch: buf[e, c] = x[token] for the ok edges. Every ok edge owns
    # its (expert, slot); the others land in a drop row.
    cell = torch.where(ok, exp * cols + col, e * cols)
    gathered = torch.where(ok[:, None], xf[tok], 0)
    buf = torch.zeros((e * cols + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, cell, gathered)
    buf = buf[:-1].reshape(e, cols, d)

    h_gate = torch.bmm(buf, p["experts_gate"].to(xf.dtype))
    h_up = torch.bmm(buf, p["experts_up"].to(xf.dtype))
    h = torch.nn.functional.silu(h_gate.float()).to(xf.dtype) * h_up
    y_buf = torch.bmm(h, p["experts_down"].to(xf.dtype))

    # combine: out[token] += w * y_buf[e, c]. The edges are token-major,
    # so the reference's scatter-add over tokens is a sum over the kp
    # candidates, taken in stream order.
    contrib = y_buf[torch.where(ok, exp, 0), torch.where(ok, col, 0)]
    contrib = contrib * torch.where(ok, w, 0.0)[:, None].to(xf.dtype)
    contrib = contrib.reshape(n, kp, d)
    out = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
    for j in range(kp):
        out = out + contrib[:, j]
    return out


def moe_mlp(x: torch.Tensor, p: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D].

    Under a mesh of D > 1 data shards (``parallel.sharding.data_shards``)
    the dispatch and combine are shard-local, as the reference's
    ``shard_map`` is, whenever the global token count, the edge count and
    the buffer's column count divide by D: shard ``r`` keeps only the
    edges whose token lies in its token block and whose slot column lies
    in its column block. Routing stays global: groups, capacity and slots
    come from the global token set. Where routing groups do not fall
    whole into shards, an edge whose slot lands in another shard's
    columns is dropped, as the reference drops it (ROADMAP, reference
    caveat 5). With ``local_batch`` each rank holds its own rows: the f32
    scores are gathered for the routing (on the global path, the rows
    themselves) and the output is the rank's rows; otherwise every rank
    holds the whole input and the shards' outputs are gathered back."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(b * s, d)
    dev = x.device
    shards = sharding.data_shards()
    local = shards is not None and shards.local_batch
    n_total = b * s * (shards.count if local else 1)

    g_tokens = min(GROUP_TOKENS, n_total)
    if n_total % g_tokens:
        raise ValueError(f"{n_total} tokens do not split into groups of "
                         f"{g_tokens}")
    g = n_total // g_tokens
    cap = capacity_of(g_tokens, cfg)
    kp = min(e, k + 2) if cfg.moe_router == "skipper" else k
    m, c_total = n_total * kp, g * cap
    shard_local = shards is not None and not (
        n_total % shards.count or m % shards.count or c_total % shards.count)
    if local and not shard_local:
        # the global path, as the reference takes it here, over every
        # rank's rows; only the rank's own rows carry its gradient
        parts = list(_gather(xf.detach(), shards.group).chunk(shards.count))
        parts[shards.index] = xf
        xf = torch.cat(parts)

    scores = xf.float() @ p["router"].float()
    scores = torch.log_softmax(scores, dim=-1)
    # the rank's own rows on the shard-local path: route on every rank's
    gathered = local and shard_local
    routed_on = _gather(scores.detach(), shards.group) if gathered else scores
    routed_on = routed_on.reshape(g, g_tokens, e)
    if cfg.moe_router == "skipper":
        routed = [route_group_skipper(routed_on[i], k, cap, kp)
                  for i in range(g)]
    else:
        routed = [route_group_topk(routed_on[i], k) for i in range(g)]
    exp_ids, weights, accept = (torch.stack(t) for t in zip(*routed))

    slots = slots_of(exp_ids, accept, e)                 # [G, M_g]
    ok = accept & (slots < cap) & (weights > 0)
    g_ids = torch.arange(g, dtype=torch.int32, device=dev)[:, None]
    col = (g_ids * cap + slots).reshape(-1).long()       # [G*M_g] in [0, G*cap)
    exp_flat = exp_ids.reshape(-1).long()
    w_flat = weights.reshape(-1)
    ok_flat = ok.reshape(-1)
    if not shard_local:
        out = _experts(xf, p, exp_flat, col, ok_flat, w_flat, e, c_total, kp)
        if local:                                        # the rank's rows
            out = out.reshape(shards.count, b * s, d)[shards.index]
        return out.reshape(b, s, d)

    sid = shards.index
    n_loc, c_loc, m_loc = (n_total // shards.count, c_total // shards.count,
                           m // shards.count)
    mine = slice(sid * m_loc, (sid + 1) * m_loc)     # the block's edges
    col_rel = col[mine] - sid * c_loc
    keep = ok_flat[mine] & (col_rel >= 0) & (col_rel < c_loc)
    if local:
        # the weights again from the rank's own scores, so the router's
        # gradient reaches them (the gathered scores carry none)
        idx = exp_flat[mine].reshape(n_loc, kp)
        w_mine = gate_weights(torch.gather(scores, 1, idx),
                              accept.reshape(-1)[mine].reshape(n_loc, kp))
        x_mine = xf
    else:
        w_mine = w_flat[mine]
        x_mine = xf[sid * n_loc:(sid + 1) * n_loc]
    out = _experts(x_mine, p, exp_flat[mine], col_rel, keep, w_mine, e,
                   c_loc, kp)
    if not local:
        out = _gather(out, shards.group)
    return out.reshape(b, s, d)
