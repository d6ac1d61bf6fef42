"""Production dry-run: reckon every (arch x shape x mesh) cell on the
16x16 and 2x16x16 meshes, with no allocation (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads the compiled executable's memory and cost analyses and
its HLO's collectives. The port compiles nothing: it **reckons** each cell
from the config, the model's parameter shapes on the ``meta`` device
(``adapters.abstract_model``), the sharding specs
(``parallel.sharding.param_specs``, ``adapters.batch_specs`` /
``cache_specs``) and the card's rates (``roofline.h100``). Every record
says ``"method": "reckoned"``. The top-level numbers are the
reference's layout (FSDP over the data axes, TP over ``model``), the
program the reference's dry-run compiles; ``port`` reckons the port's own
program on as many ranks (:func:`port_step`), which has no TP at run
time, gathers a split leaf whole and all-reduces whole gradients, and
serves from a whole model on every rank. Per device, a cell counts:

* bytes at rest: each parameter's share under its spec (its bytes over
  the product of the axis sizes its spec names); for training its
  gradients (the parameters' dtype) and its two AdamW moments
  (``opt_state_dtype``), sharded alike, and the remat's saved activations
  of one microbatch (each block's ``[B, S, D]`` input, rows over the data
  axes and, with ``seq_sharded_residual``, sequence over ``model``); for
  decode cells the cache of ``cache_specs`` at ``seq_len``, for prefill
  the cache it builds; ``fits_hbm`` against the card's memory;
* ``model_flops`` (``roofline.analysis``) over the devices, and the flops
  executed: training recomputes the forward under remat (8 N tokens
  against the model's 6), so ``useful_flops_ratio`` is 0.75 there;
* the compute term at the bf16 tensor-core rate; the memory term: the
  parameters' tensor-parallel share read once a pass (three passes in
  training: forward, recompute, backward), the update's reads and writes
  of the local parameters, gradients and moments, the saved activations
  written and read once, and the cache written (prefill) or read
  (decode);
* the collective term, from the specs: the FSDP all-gather of every
  sharded leaf a pass (forward and backward in training) and the
  reduce-scatter of its gradient, and the tensor-parallel all-reduces of
  each block's attention and MLP outputs (twice a block a pass), each at
  ring cost (``(n-1)/n`` of the bytes per device for a gather or a
  scatter, twice that for an all-reduce) over the rate of the axis's
  links (``h100.link_bytes_per_s``: NVLink inside a node of 8, the
  InfiniBand port beyond). ``dominant`` names the largest term;
* ``port``: :func:`port_step`'s bytes a device, ``fits``, collective
  bytes and term, or ``runs`` false where the port cannot run the cell.

Records go to ``experiments/dryrun_torch/*.json`` (ignored by git); a rerun
reckons only the cells not there (``--force`` all).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod-only
  python experiments/print_table_torch.py                # the table
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback
from typing import Dict, Mapping, Optional

import torch

from repro_torch.configs import get_config, get_shape, runnable_cells
from repro_torch.launch import adapters
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding
from repro_torch.roofline import analysis, h100

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
#: the tensor-parallel axis of the production meshes
TP_AXIS = "model"


@functools.lru_cache(maxsize=None)
def _abstract(arch: str) -> torch.nn.Module:
    """``arch``'s model on ``meta``, built once for all its cells."""
    return adapters.abstract_model(get_config(arch))


def _moment_bytes(cfg) -> int:
    return 2 if cfg.opt_state_dtype == "bfloat16" else 4


def count_params(model: torch.nn.Module) -> int:
    """Parameters of a model (on ``meta`` too)."""
    return sum(p.numel() for p in model.parameters())


def active_params(cfg, total: int) -> int:
    """MoE: only top-k of E experts touch each token."""
    if cfg.num_experts > 0:
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.num_experts * cfg.num_layers
        dense = total - expert
        return dense + expert * cfg.num_experts_per_tok // cfg.num_experts
    return total


def pick_microbatches(cfg, shape, n_fsdp: int) -> int:
    """Gradient-accumulation factor so a microbatch's activations fit:
    about 64 Mi bf16 activation elements a device a microbatch (tokens x
    d_model), clamped so every microbatch still spans the fsdp axes (the
    reference's rule)."""
    if shape.kind != "train":
        return 1
    budget_elems = 64 * 2**20
    if cfg.family == "audio":
        # enc-dec: the decoder's cross-attention scores add about 4x
        budget_elems //= 4
    tokens_per_dev = shape.global_batch * shape.seq_len / n_fsdp
    mb = 1
    while (
        tokens_per_dev / mb * cfg.d_model > budget_elems
        and shape.global_batch // (mb * 2) >= n_fsdp
        and (shape.global_batch % (mb * 2)) == 0
    ):
        mb *= 2
    return mb


def _factor(spec, mesh: sharding.Mesh, only=None) -> int:
    """Devices a leaf is split over under ``spec`` (the axes ``only``
    names, if given)."""
    n = 1
    for entry in spec:
        for a in sharding.entry_axes(entry):
            if only is None or a in only:
                n *= mesh.axis_size(a)
    return n


def _sharded_bytes(tensors: Mapping[str, torch.Tensor],
                   specs: Mapping[str, sharding.Spec], mesh, only=None,
                   itemsize: Optional[int] = None) -> int:
    """Per-device bytes of ``tensors`` under ``specs`` (an exact integer:
    a spec splits only dims its axes divide)."""
    return sum(t.numel() * (itemsize or t.element_size())
               // _factor(specs[k], mesh, only) for k, t in tensors.items())


def _whole_bytes(tensors: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def _block_of(key: str) -> str:
    """The block a parameter belongs to: its key up to the first layer
    index (``blocks.3.attn.wq`` -> ``blocks.3``), or ``""`` for a leaf of
    no block (embeddings, head, final norm, a shared block)."""
    parts = key.split(".")
    for i, x in enumerate(parts):
        if x.isdigit():
            return ".".join(parts[:i + 1])
    return ""


def port_step(cfg, shape, model: torch.nn.Module, chips: int, mb: int
              ) -> Dict:
    """What the port's own program holds and moves a device when it runs
    the cell on ``chips`` ranks under ``make_host_mesh()`` (``data =
    chips``, ``model = 1``: no tensor parallelism at run time).

    Training (``launch.train``, ``parallel.fsdp``): at rest each rank's
    slices of the parameters, gradients and moments under the specs of
    that mesh; while a split leaf is read it is whole, and with remat
    that is one block at a time plus the leaves of no block, each with
    its whole gradient before the reduce; the saved block inputs of one
    microbatch. Collectives, at ring cost a device: the all-gather of
    every split leaf each time it is read (forward and recompute, each
    microbatch), the all-reduce of every gradient (whole, then sliced),
    and an MoE layer's all-gather of the f32 router scores a pass. The
    rows of a microbatch must split over the ranks (``rank_rows``):
    otherwise the port cannot run the cell (``runs`` false).

    Serving (``launch.serve``): every rank holds the whole model and the
    whole cache of every request; an MoE layer all-gathers its blocks'
    outputs."""
    params = dict(model.named_parameters())
    act_b = 2 if cfg.dtype == "bfloat16" else 4
    moe_layers = cfg.num_layers if cfg.num_experts > 0 else 0
    link = h100.link_bytes_per_s(chips)

    def ring(nbytes: float) -> float:
        return nbytes * (chips - 1) / chips if chips > 1 else 0.0

    out = {"ranks": chips, "runs": True}
    if shape.kind != "train":
        cache, _ = adapters.cache_specs(
            cfg, shape, sharding.abstract_mesh((1, 1), ("data", "model")),
            model)
        tok = shape.global_batch * (shape.seq_len
                                    if shape.kind == "prefill" else 1)
        nbytes = {"params": _whole_bytes(params),
                  "cache": _whole_bytes(cache)}
        coll = {"moe_all_gather": ring(tok * cfg.d_model * act_b)
                * moe_layers}
    else:
        while mb > 1 and shape.global_batch % (mb * chips):
            mb //= 2
        if shape.global_batch % (mb * chips):
            return dict(out, runs=False, reason=(
                f"{shape.global_batch} rows do not split over {chips} "
                "ranks"))
        mesh = sharding.abstract_mesh((chips, 1), ("data", "model"))
        specs = sharding.module_specs(model, mesh)
        split = {k: p for k, p in params.items()
                 if _factor(specs[k], mesh) > 1}
        blocks: Dict[str, int] = {}
        for k, p in split.items():
            b = _block_of(k)
            blocks[b] = blocks.get(b, 0) + p.numel() * p.element_size()
        root = blocks.pop("", 0)
        gathered = root + (max(blocks.values()) if blocks else 0)
        if not cfg.remat:
            gathered = root + sum(blocks.values())
        shard_b = _sharded_bytes(params, specs, mesh)
        tok_dev = shape.global_batch * shape.seq_len / mb / chips
        layers = cfg.num_layers + cfg.encoder_layers
        nbytes = {"params": shard_b, "grads": shard_b,
                  "moments": 2 * _sharded_bytes(
                      params, specs, mesh, itemsize=_moment_bytes(cfg)),
                  "gathered": gathered, "gathered_grads": gathered,
                  "activations": int(tok_dev * cfg.d_model * act_b
                                     * layers)}
        reads = 2 if cfg.remat else 1
        tok = shape.global_batch * shape.seq_len / mb
        coll = {"param_all_gather": reads * mb * ring(_whole_bytes(split)),
                "grad_all_reduce": mb * 2 * ring(_whole_bytes(params)),
                "moe_all_gather": reads * mb * moe_layers
                * ring(tok * cfg.num_experts * 4)}
        out["microbatches"] = mb
    total = sum(nbytes.values())
    return dict(out, bytes_per_device=dict(nbytes, total=total),
                hbm_gib=total / 2**30, fits=total <= h100.hbm_bytes(),
                collective_bytes=coll,
                collective_s=sum(coll.values()) / link)


def reckon_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """One cell's record (see the module's docstring)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    fsdp = sharding.rules_for_mesh(mesh).fsdp
    tp = mesh.axis_size(TP_AXIS)
    n_fsdp = mesh.axis_size(fsdp)
    mb = pick_microbatches(cfg, shape, n_fsdp)

    model = _abstract(arch)
    params = dict(model.named_parameters())
    specs = sharding.module_specs(model, mesh)
    n_total = count_params(model)
    n_active = active_params(cfg, n_total)
    train = shape.kind == "train"

    param_b = _sharded_bytes(params, specs, mesh)
    # the tensor-parallel share a device holds once FSDP gathered a leaf
    tp_share_b = _sharded_bytes(params, specs, mesh, only=(TP_AXIS,))
    act_b = 2 if cfg.dtype == "bfloat16" else 4
    out = {"params": param_b, "grads": 0, "moments": 0, "cache": 0,
           "activations": 0}
    tokens = shape.global_batch * shape.seq_len
    # rows split over the data axes where they divide (batch_specs)
    row_split = n_fsdp if shape.global_batch % n_fsdp == 0 else 1
    if train:
        out["grads"] = param_b
        out["moments"] = 2 * _sharded_bytes(params, specs, mesh,
                                            itemsize=_moment_bytes(cfg))
        tok_dev = tokens / mb / row_split
        if cfg.seq_sharded_residual:
            tok_dev /= tp
        layers = cfg.num_layers + cfg.encoder_layers
        out["activations"] = int(tok_dev * cfg.d_model * act_b * layers)
    else:
        cache, c_specs = adapters.cache_specs(cfg, shape, mesh, model)
        out["cache"] = _sharded_bytes(cache, c_specs, mesh)
    total_b = sum(out.values())
    hbm = h100.hbm_bytes()

    mf = analysis.model_flops(cfg, shape, n_active, n_total)
    executed = mf * (8.0 / 6.0 if train and cfg.remat else 1.0)
    passes = 3 if train else 1
    mem = passes * tp_share_b + out["cache"] + 2 * out["activations"]
    if train:
        mem += 2 * (out["params"] + out["grads"] + out["moments"])

    # collectives, per device, at ring cost
    def ring(nbytes: float, n: int) -> float:
        return nbytes * (n - 1) / n if n > 1 else 0.0

    gathers = 2 if train else 1
    fsdp_gather = gathers * ring(tp_share_b, n_fsdp)
    fsdp_scatter = ring(tp_share_b, n_fsdp) if train else 0.0
    tok_dev = (tokens if shape.kind != "decode" else shape.global_batch) \
        / (mb if train else 1) / row_split
    block_out = tok_dev * cfg.d_model * act_b
    tp_passes = (3 * mb) if train else 1
    tp_allreduce = 2 * ring(block_out, tp) * 2 * cfg.num_layers * tp_passes
    coll = {"fsdp_all_gather": fsdp_gather,
            "fsdp_reduce_scatter": fsdp_scatter,
            "tp_all_reduce": tp_allreduce}
    t_coll = ((fsdp_gather + fsdp_scatter) / h100.link_bytes_per_s(n_fsdp)
              + tp_allreduce / h100.link_bytes_per_s(tp))
    terms = {"compute": executed / n_chips / h100.BF16_FLOPS_PER_S,
             "memory": mem / h100.HBM_BYTES_PER_S,
             "collective": t_coll}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh.label(),
        "method": "reckoned", "chips": n_chips, "microbatches": mb,
        "params_total": n_total, "params_active": n_active,
        "model_flops_total": mf, "model_flops_per_device": mf / n_chips,
        "executed_flops_per_device": executed / n_chips,
        "useful_flops_ratio": mf / executed,
        "bytes_per_device": dict(out, total=total_b),
        "hbm_bytes_per_device": total_b, "hbm_gib": total_b / 2**30,
        "hbm_capacity_bytes": hbm, "fits_hbm": total_b <= hbm,
        "memory_traffic_bytes": mem, "collective_bytes": coll,
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "dominant": max(terms, key=terms.get),
        "port": port_step(cfg, shape, model, n_chips, mb),
    }


def cell_path(arch, shape_name, multi_pod, tag=""):
    mesh = "2x16x16" if multi_pod else "16x16"
    safe = arch.replace(".", "_")
    return os.path.join(OUT_DIR, f"{safe}__{shape_name}__{mesh}{tag}.json")


def run_cell(arch, shape_name, multi_pod, force=False, tag="",
             write=True) -> Dict:
    """One cell's record, read from ``OUT_DIR`` if there (and not
    ``force``), else reckoned and (with ``write``) stored there; a cell
    that raises is recorded with ``"ok": false`` and its error."""
    path = cell_path(arch, shape_name, multi_pod, tag)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.perf_counter()
    try:
        record = reckon_cell(arch, shape_name, multi_pod)
        record["ok"] = True
    except Exception as e:  # a failed cell is recorded: it is a bug
        record = {"arch": arch, "shape": shape_name,
                  "mesh": "2x16x16" if multi_pod else "16x16",
                  "method": "reckoned", "ok": False,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    record["reckon_s"] = time.perf_counter() - t0
    if write:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=2)
    return record


def line(rec: Dict) -> str:
    """One cell as a line of the run's log."""
    head = f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s}"
    if not rec.get("ok"):
        return f"FAIL {head} {rec['error'][:160]}"
    port = rec["port"]
    own = (f"port={port['hbm_gib']:.2f}GiB fits={port['fits']}"
           if port["runs"] else "port=cannot-run")
    return (f"OK   {head} hbm={rec['hbm_gib']:.2f}GiB "
            f"fits={rec['fits_hbm']} {own} dom={rec['dominant']:10s} "
            f"t_c={rec['compute_s'] * 1e3:.2f}ms "
            f"t_m={rec['memory_s'] * 1e3:.2f}ms "
            f"t_x={rec['collective_s'] * 1e3:.2f}ms "
            f"useful={rec['useful_flops_ratio']:.3f} mb={rec['microbatches']}"
            f" [reckoned in {rec['reckon_s']:.2f}s]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]
    n_ok = n_fail = 0
    for arch, shapes in runnable_cells().items():
        if args.arch and arch != args.arch:
            continue
        for shape_name in shapes:
            if args.shape and shape_name != args.shape:
                continue
            for mp in meshes:
                rec = run_cell(arch, shape_name, mp, force=args.force)
                n_ok += bool(rec.get("ok"))
                n_fail += not rec.get("ok")
                print(line(rec), flush=True)
    print(f"\ndry-run complete (reckoned, not compiled): {n_ok} ok, "
          f"{n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
