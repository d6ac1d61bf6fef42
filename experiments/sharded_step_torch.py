"""Training steps of a model sharded over D ranks against the same steps
in one process: losses, the updated parameters' distance (the largest,
against the learning rate, and the elements more than a bf16 step apart),
step times and each rank's peak device bytes, beside the dry-run's
reckoning of the port's step (``launch.dryrun.port_step``).

The step is the port's (``launch.steps.make_train_step`` with
``parallel.fsdp.ShardedParams``, each rank its rows of the batch, the
packer's global-tier kernel on the card), set up as ``launch.train``
sets it up; the peak counts from just after the set-up (the model is
drawn whole on each rank before it is sliced). On the cards the ranks
are one NCCL process a card (``--ranks`` cards); with ``--device cpu``
gloo processes (a rehearsal at ``--smoke`` size).

    python experiments/sharded_step_torch.py                  # 4 cards
    python experiments/sharded_step_torch.py --device cpu --smoke --seq 64

Writes the record to ``--out`` (``experiments/sharded_step_torch.json``,
ignored by git) and prints it.
"""
import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def _config(args):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_step(args, dev, sharded_run: bool):
    """Set up as ``launch.train.train`` does, then time ``args.steps``
    steps; returns the losses, the last step's seconds, the peak bytes
    after set-up and the parameters after the steps (whole, on the
    host)."""
    from repro_torch.data import DataConfig
    from repro_torch.launch import adapters, train as T
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.parallel.fsdp import ShardedParams

    cfg = _config(args)
    tcfg = T.train_config(args.steps, learning_rate=args.lr)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_per_host=args.batch)
    mesh = make_host_mesh() if sharded_run else sharding.abstract_mesh(
        (1, 1), ("data", "model"))
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(
        tcfg.seed), cfg)
    state = adamw.init_state(dict(model.named_parameters()), tcfg,
                             T.moment_dtype(cfg))
    sp = None
    if mesh.device_mesh is not None:
        sp = ShardedParams(model, mesh, tcfg.grad_compression)
        state = adamw.AdamWState(state.step, sp.shard(state.mu),
                                 sp.shard(state.nu))
    step_fn = make_train_step(cfg, tcfg, sp)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    losses, secs = [], 0.0
    for step in range(args.steps):
        batch = T.build_batch(cfg, dcfg, step, dev)
        _sync(dev)
        t0 = time.perf_counter()
        with sharding.set_mesh(mesh, local_batch=True):
            shards = sharding.data_shards()
            if shards is not None:
                batch = T.rank_rows(batch, shards)
            state, metrics = step_fn(model, state, batch)
        _sync(dev)
        secs = time.perf_counter() - t0
        losses.append(float(metrics["loss"]))
    out = {"losses": losses, "last_step_s": secs}
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["at_rest_bytes"] = base
    if sp is not None:
        out["split_leaves"] = len(sp.split)
        params = sp.full(sp.local())
    else:
        params = {k: p.detach() for k, p in model.named_parameters()}
    return out, {k: v.cpu() for k, v in params.items()}


def distance(got: torch.Tensor, want: torch.Tensor):
    """``(the largest |got - want|, the elements more than one bf16 step
    at want's magnitude apart)``."""
    want, diff = want.float(), (got.float() - want.float()).abs()
    e = torch.floor(torch.log2(want.abs().clamp(min=1e-30)))
    return float(diff.max()), int((diff > torch.exp2(e - 7)).sum())


def _rank(rank, args, port, out_path):
    import torch.distributed as dist

    dev = torch.device("cpu")
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=args.ranks)
    if rank == 0:
        # the same step in one process, the others waiting
        alone, want = run_step(args, dev, sharded_run=False)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    got, params = run_step(args, dev, sharded_run=True)
    recs = [None] * args.ranks
    dist.all_gather_object(recs, got)
    if rank == 0:
        dist_of = {k: distance(params[k], want[k]) for k in want}
        worst = max(dist_of, key=lambda k: dist_of[k][0])
        result = {"unsharded": alone, "sharded": recs,
                  "max_abs_diff": dist_of[worst][0], "worst_leaf": worst,
                  "max_abs_diff_over_lr": dist_of[worst][0] / args.lr,
                  "elements_beyond_one_bf16_step": sum(
                      v[1] for v in dist_of.values()),
                  "elements": sum(v.numel() for v in want.values()),
                  "loss_rel_diff": [abs(a - b) / abs(b) for a, b in zip(
                      recs[0]["losses"], alone["losses"])]}
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-110b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "experiments", "sharded_step_torch.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"needs {args.ranks} cards", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build
        from repro_torch.kernels.skipper_match import kernel

        _build.build(kernel.SOURCE)       # once, before the ranks load it
    import torch.multiprocessing as mp

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import adapters, dryrun

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_path = args.out
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    mp.spawn(_rank, args=(args, port, out_path), nprocs=args.ranks,
             join=True)
    with open(out_path) as f:
        result = json.load(f)
    cfg = _config(args)
    shape = ShapeConfig("run", "train", args.seq, args.batch)
    result["reckoned"] = dryrun.port_step(cfg, shape,
                                          adapters.abstract_model(cfg),
                                          args.ranks, 1)
    result["args"] = vars(args)
    if args.device == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
