"""End-to-end training with fault tolerance (port of
``repro.launch.train``).

* Deterministic data: the batch of (step, host) is a pure function
  (``data.batch_for_step``), so a restart replays nothing. Documents are
  packed into rows by the Skipper matcher, on the card through the
  global-tier kernel.
* Checkpoint and restart: versioned, digest-checked, asynchronous, in the
  reference's format (``checkpoint.Checkpointer``); the run resumes from
  the latest step, so killing it at any point and running the same command
  again goes on where it stopped.

* Sharded: the run's mesh is ``launch.mesh.make_host_mesh()``, ``(data =
  world, model = 1)`` over the default process group's ranks when one is
  initialised (one NCCL rank a card; gloo ranks on the CPU). There the
  parameters and the AdamW moments live sharded as
  ``parallel.sharding.param_specs`` says (``parallel.fsdp``: a split
  parameter is made whole only where the model reads it), each rank
  takes its rows of every batch (``batch_spec``: rows over ``data``), and
  the loss is the global masked mean. Checkpoints are gathered and written
  by rank 0. Without a process group the mesh is a 1x1 descriptor and the
  run is one process's.

Runs on the card unless ``--device cpu`` is given; without a card the
default raises. Weights are drawn on the device from a ``torch.Generator``
seeded with ``TrainConfig.seed`` (every rank draws the same, then keeps
its slices). The AdamW moments are of the config's ``opt_state_dtype``.
``layers`` cuts the depth. Every family of the registry trains here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --steps 3 --batch 2 --seq 2048 --lr 1e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 64 --ckpt-dir ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.device import resolve_device
from repro_torch.interop import arrays_from_params, params_from_arrays
from repro_torch.launch import adapters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.vlm import make_mrope_positions
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel.fsdp import ShardedParams

#: the reference's checkpoint keys of ``AdamWState``'s fields (how JAX
#: names a NamedTuple's fields in a path)
OPT_KEYS = (".step", ".mu", ".nu")


def build_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
                device) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` on ``device``; the packer matches there. The
    vlm family adds a stub image prefix (``max(4, S // 8)`` patches rounded
    down to a square grid, N(0, 1) embeddings) and its M-RoPE positions,
    the audio family ``encoder_frames`` N(0, 1) frames: drawn from
    ``np.random.default_rng(step)`` as the reference draws them."""
    tokens, mask = batch_for_step(step, dcfg, device=device)
    batch = {"tokens": torch.from_numpy(tokens).to(device),
             "mask": torch.from_numpy(mask).to(device)}
    b, s = tokens.shape
    if cfg.family == "vlm":
        gh = int(np.sqrt(max(4, s // 8)))
        n_img = gh * gh
        rng = np.random.default_rng(step)
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(b, n_img, cfg.d_model)).astype(np.float32)).to(device)
        batch["mrope_positions"] = make_mrope_positions(
            b, s + n_img, n_img, (gh, gh), device=device)
    if cfg.family == "audio":
        rng = np.random.default_rng(step)
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, cfg.encoder_frames, cfg.d_model)).astype(
                np.float32)).to(device)
    return batch


def rank_rows(batch: Dict[str, torch.Tensor], shards: sharding.DataShards,
              microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """This data rank's rows of a whole batch: of each microbatch's rows,
    the ``index``-th of ``count`` equal blocks (so the step's own
    microbatch slices are the rank's part of each global microbatch);
    the batch axis is 1 for the ``[3, B, S]`` M-RoPE positions."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        b = v.shape[axis]
        if b % (microbatches * shards.count):
            raise ValueError(f"{k}: {b} rows do not split into "
                             f"{microbatches} microbatch(es) over "
                             f"{shards.count} data ranks")
        shape = (v.shape[:axis] + (microbatches, shards.count, -1)
                 + v.shape[axis + 1:])
        mine = v.reshape(shape).select(axis + 1, shards.index)
        out[k] = mine.reshape(v.shape[:axis] + (-1,)
                              + v.shape[axis + 1:]).contiguous()
    return out


def moment_dtype(cfg: ModelConfig) -> torch.dtype:
    """The AdamW moments' dtype that the config asks for."""
    return (torch.bfloat16 if cfg.opt_state_dtype == "bfloat16"
            else torch.float32)


def opt_tree(state: adamw.AdamWState, cfg: ModelConfig,
             placeholders: bool = False) -> dict:
    """The optimizer state as the reference's checkpoint tree."""
    step = (np.zeros((), np.int32) if placeholders
            # the step is checkpointed with the moments
            else state.step.cpu().numpy())  # host-sync: ok — checkpoint
    return dict(zip(OPT_KEYS, (
        step,
        arrays_from_params(state.mu, cfg, placeholders=placeholders),
        arrays_from_params(state.nu, cfg, placeholders=placeholders))))


def restore(ckpt: Checkpointer, step: Optional[int], model, state, cfg
            ) -> dict:
    """Load step ``step`` (``None``: the latest) of ``ckpt`` into ``model``
    and the optimizer ``state`` in place; returns the step's metadata."""
    named = dict(model.named_parameters())
    params, opt, meta = ckpt.restore(
        step, arrays_from_params(named, cfg, placeholders=True),
        opt_tree(state, cfg, placeholders=True))
    with torch.no_grad():
        for k, v in params_from_arrays(params, cfg).items():
            named[k].copy_(v)
        for tree, moments in ((opt[".mu"], state.mu), (opt[".nu"], state.nu)):
            for k, v in params_from_arrays(tree, cfg).items():
                moments[k].copy_(v)
        state.step.fill_(int(np.asarray(opt[".step"])))
    return meta


def save(ckpt: Checkpointer, step: int, model, state, cfg,
         block: bool = False, sharded: Optional[ShardedParams] = None
         ) -> None:
    """Copy the parameters and the optimizer state to the host and write
    them as step ``step`` (asynchronously unless ``block``). With
    ``sharded`` every rank gathers them whole and rank 0 writes; a
    blocking save returns on every rank once the step is on disk."""
    if sharded is None:
        params = dict(model.named_parameters())
        ckpt.save(step, arrays_from_params(params, cfg),
                  opt_tree(state, cfg), block=block)
        return
    import torch.distributed as dist

    params = sharded.full(sharded.local())
    state = adamw.AdamWState(state.step, sharded.full(state.mu),
                             sharded.full(state.nu))
    if dist.get_rank() == 0:
        ckpt.save(step, arrays_from_params(params, cfg),
                  opt_tree(state, cfg), block=block)
    if block:
        dist.barrier()


def train_config(steps: int, microbatches: int = 1,
                 checkpoint_every: int = 50,
                 learning_rate: float = TrainConfig.learning_rate
                 ) -> TrainConfig:
    """The ``TrainConfig`` of a run of ``steps`` steps, as the reference's
    ``train`` builds it (a tenth of the steps warm up)."""
    return TrainConfig(learning_rate=learning_rate, total_steps=steps,
                       warmup_steps=max(1, steps // 10),
                       microbatches=microbatches,
                       checkpoint_every=checkpoint_every)


def train(arch: str, smoke: bool, steps: int, batch_size: int, seq_len: int,
          ckpt_dir: Optional[str], checkpoint_every: int = 50,
          microbatches: int = 1, log_every: int = 10, device=None,
          learning_rate: float = TrainConfig.learning_rate,
          layers: Optional[int] = None, return_params: bool = False):
    """Train ``arch`` (``layers`` deep, if given) for ``steps`` steps
    (resuming from the latest checkpoint in ``ckpt_dir``) under
    ``make_host_mesh()``; returns the loss of each step run, and with
    ``return_params`` also the parameters after the last step, whole, by
    state-dict key."""
    dev = resolve_device(device, "cuda", "train")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tcfg = train_config(steps, microbatches, checkpoint_every, learning_rate)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      batch_per_host=batch_size)

    mesh = make_host_mesh()
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(
        tcfg.seed), cfg)
    opt_state = adamw.init_state(dict(model.named_parameters()), tcfg,
                                 moment_dtype(cfg))
    start_step = 0

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        start_step = restore(ckpt, None, model, opt_state, cfg)["step"]
        print(f"[train] resumed from step {start_step}")

    sharded = None
    if mesh.device_mesh is not None:
        sharded = ShardedParams(model, mesh, tcfg.grad_compression)
        opt_state = adamw.AdamWState(opt_state.step,
                                     sharded.shard(opt_state.mu),
                                     sharded.shard(opt_state.nu))
    step_fn = make_train_step(cfg, tcfg, sharded)
    losses = []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch = build_batch(cfg, dcfg, step, dev)
        with sharding.set_mesh(mesh, local_batch=True):
            shards = sharding.data_shards()
            if shards is not None:
                batch = rank_rows(batch, shards, microbatches)
            opt_state, metrics = step_fn(model, opt_state, batch)
        # the loss log reads each step's loss
        losses.append(float(metrics["loss"]))  # host-sync: ok
        if (step + 1) % log_every == 0:
            dt = time.perf_counter() - t0
            tps = log_every * batch_size * seq_len / dt
            lr = float(metrics["lr"])  # host-sync: ok — the log line
            gnorm = float(metrics["grad_norm"])  # host-sync: ok — the log line
            print(f"[train] step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"lr {lr:.2e} gnorm {gnorm:.2f} {tps:,.0f} tok/s",
                  flush=True)
            t0 = time.perf_counter()
        if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
            save(ckpt, step + 1, model, opt_state, cfg, sharded=sharded)
    if ckpt:
        save(ckpt, steps, model, opt_state, cfg, block=True, sharded=sharded)
        ckpt.wait()
    if not return_params:
        return losses
    if sharded is not None:
        return losses, sharded.full(sharded.local())
    return losses, {k: p.detach() for k, p in model.named_parameters()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lr", type=float, default=TrainConfig.learning_rate,
                    help="peak learning rate (default %(default)s, the "
                    "reference's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this depth")
    args = ap.parse_args()
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.ckpt_dir, microbatches=args.microbatches,
                   device=args.device, learning_rate=args.lr,
                   layers=args.layers)
    if losses:
        print(f"[train] final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
