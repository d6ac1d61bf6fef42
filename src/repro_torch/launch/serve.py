"""Batched serving loop with continuous slot refill (port of
``repro.launch.serve``).

A request queue feeds fixed decode slots; a sequence that finishes (EOS or
its token budget) frees its slot, which is refilled by prefilling the next
request. Each slot holds its own cache and decodes one token a step.

Serves the decoder-only families ``dense``, ``moe``, ``ssm`` and
``hybrid``, as the reference does. Runs on the card unless ``--device
cpu`` is given; without a card the default raises. Weights are drawn on
the device itself from a ``torch.Generator`` seeded with ``seed`` (0 from
the command line); ``layers`` cuts the depth.

The loop runs under ``launch.mesh.make_host_mesh()``, as the reference's
does. Every rank holds the whole model and every request (the
reference's arrays are replicated); over several data ranks an MoE
layer's dispatch and combine are shard-local, each rank's block gathered
back (``models.moe.moe_mlp``), so the tokens are the reference's at that
mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --requests 8 --slots 4 --prompt-len 512 \\
      --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --requests 4 --slots 2 --prompt-len 512 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --smoke --device cpu --requests 4 --slots 2 --prompt-len 16 --max-new 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import adapters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_serve_step
from repro_torch.parallel import sharding

EOS = 2
#: the families served, as in the reference (the vlm and audio families
#: need an image or audio input a request carries none of)
SERVED = ("dense", "moe", "ssm", "hybrid")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # host-sync: ok — timing boundary


def serve(arch: str, smoke: bool, num_requests: int, slots: int,
          prompt_len: int, max_new: int, seed: int = 0,
          device=None, layers: Optional[int] = None
          ) -> Tuple[Dict[int, List[int]], Dict[str, object]]:
    """Serve ``num_requests`` seeded random prompts; returns
    ``(outputs, stats)``: the decoded tokens of each request (the
    reference's return value) and the host-clock times, each ending in a
    device sync: ``prefill_s`` (one a request), ``decode_s`` (the loop's
    time outside prefills), ``decoded`` tokens and ``total_s``. The
    weights are drawn from a generator seeded with ``seed`` on
    ``device``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family not in SERVED:
        raise ValueError(f"{arch}: serving drives the decoder-only families "
                         f"{SERVED}, not {cfg.family!r}")
    device = resolve_device(device, "cuda", "serve")
    rng = np.random.default_rng(seed)
    requests: List[np.ndarray] = [
        rng.integers(3, cfg.vocab_size, size=prompt_len).astype(np.int32)
        for _ in range(num_requests)
    ]
    max_len = prompt_len + max_new
    mesh = make_host_mesh()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = adapters.init_fn(gen, cfg)
    serve_step = make_serve_step(cfg)
    prefill_s: List[float] = []

    @torch.no_grad()
    def prefill_one(prompt: np.ndarray):
        t0 = time.perf_counter()
        batch = {"tokens": torch.from_numpy(prompt)[None].to(device)}
        logits, cache = adapters.prefill_fn(model, batch, cfg,
                                            max_len=max_len)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(device)
        prefill_s.append(time.perf_counter() - t0)
        return nxt, cache

    queue = list(range(num_requests))
    outputs: Dict[int, List[int]] = {i: [] for i in range(num_requests)}
    t0 = time.perf_counter()
    decoded = 0

    def refill() -> Optional[dict]:
        if not queue:
            return None
        rid = queue.pop(0)
        nxt, cache = prefill_one(requests[rid])
        return {"rid": rid, "tokens": nxt, "cache": cache, "n": 0}

    with sharding.set_mesh(mesh):
        slot_state = {s: refill() for s in range(slots)}
        while any(v is not None for v in slot_state.values()):
            for s, st in list(slot_state.items()):
                if st is None:
                    continue
                tok, cache = serve_step(model, st["cache"], st["tokens"])
                nxt = int(tok[0, 0])  # host-sync: ok — EOS and output
                outputs[st["rid"]].append(nxt)
                decoded += 1
                st["tokens"], st["cache"], st["n"] = tok, cache, st["n"] + 1
                if nxt == EOS or st["n"] >= max_new:
                    slot_state[s] = refill()
    _sync(device)
    total = time.perf_counter() - t0
    decode_s = total - sum(prefill_s)
    print(f"[serve] {num_requests} requests, {decoded} tokens decoded in "
          f"{total:.1f}s ({decoded / total:.1f} tok/s, {slots} slots; "
          f"decode {decoded / decode_s:.1f} tok/s outside prefills) on "
          f"{device}")
    stats = {"prefill_s": prefill_s, "decode_s": decode_s,
             "decoded": decoded, "total_s": total}
    return outputs, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this depth")
    args = ap.parse_args()
    serve(args.arch, args.smoke, args.requests, args.slots,
          args.prompt_len, args.max_new, device=args.device,
          layers=args.layers)


if __name__ == "__main__":
    main()
