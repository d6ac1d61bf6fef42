"""The paper's technique as an MoE router, with the PyTorch + CUDA port:
Skipper b-matching against top-k.

Under a skewed router distribution top-k overflows the hot experts
(dropped tokens), while the matching router fills capacity exactly and
spills tokens to their next-best expert: the single-pass,
conflict-resolving assignment of the paper, applied to token-expert
edges.

    PYTHONPATH=src python examples/moe_matching_router_torch.py      # the card
    PYTHONPATH=src python examples/moe_matching_router_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.bipartite import bmatch_assign
from repro_torch.device import resolve_device
from repro_torch.models.moe import top_k


def route_stats(n_tok=2048, n_exp=8, k=2, cap_factor=1.25, skew=2.0,
                seed=0, device="cuda") -> dict:
    """Route ``n_tok`` tokens with skewed scores both ways; print and
    return the assignments, drops, utilisation and largest load of
    each."""
    dev = resolve_device(device, "cuda", "moe_matching_router")
    rng = np.random.default_rng(seed)
    # skewed router logits: a few hot experts
    bias = np.sort(rng.normal(size=n_exp))[::-1] * skew
    scores = rng.normal(size=(n_tok, n_exp)) + bias
    scores = torch.from_numpy(scores.astype(np.float32)).to(dev)
    cap = int(n_tok * k / n_exp * cap_factor)

    # ---- top-k with capacity truncation (the baseline failure mode)
    _, idx = top_k(scores, k)
    exp = idx.reshape(-1).cpu().numpy()  # host-sync: ok — the tally below
    counts = np.zeros(n_exp, int)
    dropped = 0
    for e in exp:          # arrival order, as capacity buffers fill
        if counts[e] < cap:
            counts[e] += 1
        else:
            dropped += 1
    topk_util = counts.sum() / (n_tok * k)

    # ---- skipper matching router
    kp = min(n_exp, k + 2)
    v2, i2 = top_k(scores, kp)
    tok = torch.arange(n_tok, dtype=torch.int32, device=dev).repeat_interleave(
        kp)
    expc = i2.reshape(-1).to(torch.int32)
    order = torch.argsort(-v2.reshape(-1), stable=True)
    accept = bmatch_assign(tok[order], expc[order], num_tokens=n_tok,
                           num_experts=n_exp, token_budget=k,
                           expert_capacity=cap)
    acc = accept.cpu().numpy()  # host-sync: ok — the printed stats
    exp_sorted = expc[order].cpu().numpy()  # host-sync: ok — the stats
    counts_m = np.bincount(exp_sorted[acc], minlength=n_exp)
    match_util = acc.sum() / (n_tok * k)

    print(f"experts={n_exp} k={k} capacity={cap} skew={skew}")
    print(f"  top-k   : assignments={counts.sum():5d} dropped={dropped:5d} "
          f"utilization={topk_util:.3f} max_load={counts.max()}")
    print(f"  skipper : assignments={acc.sum():5d} dropped={0:5d} "
          f"utilization={match_util:.3f} max_load={counts_m.max()} "
          f"(capacity respected by construction)")
    assert counts_m.max() <= cap
    return {"capacity": cap,
            "topk": {"assignments": int(counts.sum()), "dropped": dropped,
                     "utilization": float(topk_util),
                     "max_load": int(counts.max())},
            "skipper": {"assignments": int(acc.sum()), "dropped": 0,
                        "utilization": float(match_util),
                        "max_load": int(counts_m.max())}}


#: the three cases of the JAX package's example
CASES = (("Mixtral-style: 8 experts, top-2", dict(n_exp=8, k=2, skew=2.0)),
         ("Granite-style: 40 experts, top-8", dict(n_exp=40, k=8, skew=2.0)),
         ("pathological skew", dict(n_exp=8, k=2, skew=5.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    for title, kw in CASES:
        print(f"== {title} ==")
        route_stats(device=args.device, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
