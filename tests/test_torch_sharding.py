"""The port's sharding layer (``repro_torch.parallel``, ``launch.mesh``,
the adapters' input specs and the shard-local MoE) on the CPU against the
JAX package's, on the same numpy-seeded inputs and the reference's
parameters.

* Specs, in this process: ``param_specs`` leaf by leaf for all ten
  architectures on meshes (1,1), (4,2), (16,16) and (2,16,16) against
  the reference's on ``compat.abstract_mesh``; ``batch_specs``,
  ``cache_specs`` and ``decode_token_specs`` in shape, dtype and spec for
  every runnable cell on (4,2) and (16,16); the reference's four tests of
  ``tests/test_sharding.py`` restated. Exact equality.
* D = 2 and D = 4 through gloo: one ``torch.multiprocessing.spawn`` of D
  ranks a D runs every case of that D, beside one reference subprocess a
  D at D forced host devices (``strategies.run_subprocess``; the two run
  at once, with the port's spawns, in this fixture):
  - ``compressed_psum`` against the reference's ``psum`` under
    ``shard_map``: bit-equal on integer-valued inputs, within one bf16
    step on N(0, 1) inputs;
  - ``moe_mlp`` on granite-moe's smoke config (layer 0) under the
    reference's host mesh in ``jit``: the aligned regime (16,384 tokens,
    four routing groups, one or two a shard) and the misaligned one (256
    tokens, one group across every shard, where the reference drops the
    edges whose slot lands in another shard's columns: ROADMAP, reference
    caveat 5); each with the input on every rank whole (serving) and with
    each rank's own rows (training); f32, within ``MOE_TOL``;
  - three smoke training steps of granite-moe-3b-a800m and llama3-405b
    through ``launch.train.train`` against the reference's ``train``: the
    losses within 1e-5 relative (f32);
  - at D = 2, a greedy ``serve`` of granite-moe's smoke config: the
    reference's tokens exactly;
  - at D = 4, the parameters at rest on meshes (4,1) and (2,2): each
    rank's local shard is, bit for bit, the slice of the reference's
    array that the reference's spec names for that rank.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from strategies import run_subprocess

#: f32 tolerance of the MoE layer against the reference (absolute, on
#: outputs of magnitude about 1): the models' own (test_torch_models.py)
MOE_TOL = 5e-5
#: relative tolerance of the training losses (f32)
LOSS_TOL = 1e-5
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MOE_ARCH = "granite-moe-3b-a800m"
#: the two regimes: (name, x shape), x ~ N(0, 1) from numpy; and the
#: probe that found the reference's drop: the misaligned shape with x
#: from jax.random.normal(PRNGKey(1)) (ROADMAP, reference caveat 5)
MOE_SHAPES = {"misaligned": (4, 64, 64), "aligned": (4, 4096, 64)}
MOE_CASES = tuple(MOE_SHAPES) + ("probe",)
#: the probe's max |delta| against the unsharded call at 4 devices
PROBE_GAP = 4.3054
TRAIN_ARCHS = ("granite-moe-3b-a800m", "llama3-405b")
TRAIN_KW = dict(steps=3, batch_size=4, seq_len=64)
SERVE_KW = dict(num_requests=3, slots=2, prompt_len=16, max_new=6)
PLACEMENT_MESHES = ((4, 1), (2, 2))
#: D = 3: the MoE input (one row a rank) whose 64 buffer columns do not
#: split over 3 shards, so the layer takes its global path, as the
#: reference's does; and the training run there (3 rows of 64 tokens)
MISFIT_D = 3
MISFIT_SHAPE = (3, 64, 64)
MISFIT_TRAIN_KW = dict(steps=2, batch_size=3, seq_len=64)


def _ref_tree(arch, seed=0):
    import jax

    from repro.configs import get_smoke_config
    from repro.launch.adapters import init_fn

    return jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed),
                                             get_smoke_config(arch)))


def _ref_leaves(specs):
    import jax
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) for k in path): tuple(v) for path, v in flat}


# ----------------------------------------------------------------- specs --
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [
    "granite-moe-3b-a800m", "mixtral-8x7b", "qwen2-vl-2b", "llama3-405b",
    "qwen1.5-110b", "llama3.2-1b", "qwen1.5-0.5b", "whisper-large-v3",
    "zamba2-2.7b", "mamba2-130m"])
def test_param_specs_equal_reference(arch, mesh):
    """Every leaf's spec equals the reference's, on the full config's
    shapes (the port's model on ``meta``, the reference's
    ``eval_shape``)."""
    import jax

    from repro import compat
    from repro.configs import get_config as jget
    from repro.launch import adapters as JA
    from repro.parallel.sharding import param_specs as jspecs

    from repro_torch.configs import get_config
    from repro_torch.launch import adapters
    from repro_torch.parallel import sharding

    shape, names = MESHES[mesh]
    tree = jax.eval_shape(lambda: JA.init_fn(jax.random.PRNGKey(0),
                                             jget(arch)))
    want = _ref_leaves(jspecs(tree, compat.abstract_mesh(shape, names)))
    model = adapters.abstract_model(get_config(arch))
    got = sharding.leaves(sharding.param_specs(
        model, sharding.abstract_mesh(shape, names)))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    # the skeleton's placeholders give the same specs as the model
    skel = sharding.leaves(sharding.param_specs(
        sharding.reference_tree(model), sharding.abstract_mesh(shape, names)))
    assert skel == got


def _cells():
    from repro_torch.configs import runnable_cells

    return [(a, s) for a, shapes in runnable_cells().items() for s in shapes]


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("mesh", ["4x2", "16x16"])
@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_equal_reference(arch, shape, mesh):
    """``batch_specs`` (train and prefill cells), ``cache_specs`` and
    ``decode_token_specs`` (decode cells): shape, dtype and spec of every
    entry equal the reference's."""
    from repro import compat
    from repro.configs import get_config as jget, get_shape as jshape
    from repro.launch import adapters as JA

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import adapters
    from repro_torch.parallel import sharding

    mshape, names = MESHES[mesh]
    jmesh = compat.abstract_mesh(mshape, names)
    tmesh = sharding.abstract_mesh(mshape, names)
    cfg, jcfg = get_config(arch), jget(arch)
    sh, jsh = get_shape(shape), jshape(shape)

    def same(got, want, label):
        (t, spec), (sds, ns) = got, want
        assert tuple(t.shape) == tuple(sds.shape), label
        assert t.device.type == "meta", label
        assert _dtype_name(t.dtype) == str(sds.dtype), label
        assert spec == tuple(ns.spec), (label, spec, ns.spec)

    if sh.kind in ("train", "prefill"):
        (gb, gs), (wb, ws) = (adapters.batch_specs(cfg, sh, tmesh),
                              JA.batch_specs(jcfg, jsh, jmesh))
        assert set(gb) == set(wb)
        for k in wb:
            same((gb[k], gs[k]), (wb[k], ws[k]), k)
    else:
        (gc, gs), (wc, ws) = (adapters.cache_specs(cfg, sh, tmesh),
                              JA.cache_specs(jcfg, jsh, jmesh))
        assert set(gc) == set(wc)
        for k in wc:
            same((gc[k], gs[k]), (wc[k], ws[k]), k)
        same(adapters.decode_token_specs(cfg, sh, tmesh),
             JA.decode_token_specs(jcfg, jsh, jmesh), "tokens")


# ------------------------------------------- the reference's tests, restated
def test_specs_cover_all_params():
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.launch import adapters
    from repro_torch.parallel import sharding

    for arch in ARCH_IDS:
        model = adapters.abstract_model(get_smoke_config(arch))
        specs = sharding.param_specs(model, sharding.abstract_mesh(
            (1, 1), ("data", "model")))
        tree = sharding.reference_tree(model)
        assert len(sharding.leaves(specs)) == len(sharding.leaves(tree))
        assert set(sharding.module_specs(model, sharding.abstract_mesh(
            (1, 1), ("data", "model")))) == set(dict(model.named_parameters()))


def test_divisibility_fallback():
    """A dim that doesn't divide the axis size is replicated, not an
    error."""
    from repro_torch.parallel import sharding

    mesh = sharding.abstract_mesh((4, 2), ("data", "model"))
    tree = {"wq": torch.empty((6, 10), device="meta")}     # 6 % 4 != 0
    spec = sharding.param_specs(tree, mesh)["wq"]
    assert spec[0] is None
    assert spec[1] == "model"


def test_big_model_params_sharded():
    """llama3-405b: the big matrices are 2-D sharded (fsdp x tp)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import adapters
    from repro_torch.parallel import sharding

    model = adapters.abstract_model(get_config("llama3-405b"))
    specs = sharding.param_specs(model, sharding.abstract_mesh(
        (4, 2), ("data", "model")))
    wq = specs["blocks"]["attn"]["wq"]
    assert wq[1] is not None and wq[2] is not None
    assert sharding.module_specs(model, sharding.abstract_mesh(
        (4, 2), ("data", "model")))["blocks.0.attn.wq"] == wq[1:]


def test_rules_pod_axes():
    from repro_torch.parallel import sharding

    rules = sharding.rules_for_mesh(sharding.abstract_mesh(
        (2, 2, 2), ("pod", "data", "model")))
    assert rules.fsdp == ("pod", "data")
    assert rules.tp == "model"


# ---------------------------------------------------------- small pieces --
def test_spec_equals_partition_spec():
    from jax.sharding import PartitionSpec as P

    from repro.parallel.sharding import batch_spec as jbatch

    from repro_torch.parallel import sharding

    assert sharding.Spec(("data",), None) == tuple(P(("data",), None))
    assert sharding.Spec(("pod", "data")) == tuple(P(("pod", "data")))
    assert sharding.Spec() == tuple(P())
    for names in (("data", "model"), ("pod", "data", "model"), ("model",)):
        assert sharding.batch_spec(names) == tuple(jbatch(names))


def test_param_shardings_are_the_specs_placements():
    """``param_shardings``: ``Shard(dim)`` on each mesh dim that a spec's
    entry names (both, for a two-axis entry), ``Replicate()`` elsewhere;
    keyed as ``param_specs``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch import adapters
    from repro_torch.parallel import sharding

    model = adapters.abstract_model(get_config("llama3-405b"))
    for shape, names in (MESHES["4x2"], MESHES["2x16x16"]):
        mesh = sharding.abstract_mesh(shape, names)
        specs = sharding.leaves(sharding.param_specs(model, mesh))
        got = sharding.leaves(sharding.param_shardings(model, mesh))
        assert set(got) == set(specs)
        for path, spec in specs.items():
            want = [Replicate()] * len(names)
            for dim, entry in enumerate(spec):
                for a in sharding.entry_axes(entry):
                    want[names.index(a)] = Shard(dim)
            assert list(got[path]) == want, path
    wq = sharding.param_shardings(model, sharding.abstract_mesh(
        *MESHES["2x16x16"]))["blocks"]["attn"]["wq"]
    assert tuple(wq) == (Shard(1), Shard(1), Shard(2))


def test_production_and_host_meshes():
    """The reference's production meshes need 256 and 512 devices; their
    shapes and names are the docstring's (``repro.launch.mesh``)."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    one, two = (make_production_mesh(multi_pod=mp) for mp in (False, True))
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.size == 512 and two.label() == "2x16x16"
    assert one.device_mesh is None and two.device_mesh is None
    host = make_host_mesh()          # no process group here
    assert host.shape == {"data": 1, "model": 1} and host.device_mesh is None
    with pytest.raises(ValueError):
        make_host_mesh(model_axis=2)


def test_constrain_and_hooks_are_no_ops_without_ranks():
    """Without a mesh, and under a mesh of no ranks, ``constrain`` and
    the model hooks return their input itself."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding

    x = torch.randn(2, 4, 8)
    assert sharding.current_mesh() is None
    assert sharding.constrain(x, sharding.Spec("data")) is x
    mesh = sharding.abstract_mesh((4, 2), ("data", "model"))
    with sharding.set_mesh(mesh):
        assert sharding.current_mesh() is mesh
        assert sharding.data_shards() is None
        for hook in (L.batch_shard, L.seq_shard):
            assert hook(x) is x
    assert sharding.current_mesh() is None


@pytest.mark.parametrize("mode", ["bf16", "none"])
def test_compress_tree_round_trip(mode):
    from jax import numpy as jnp

    from repro.parallel.collectives import compress_tree as jcomp

    from repro_torch.parallel import collectives as C

    rng = np.random.default_rng(0)
    g = rng.standard_normal(33).astype(np.float32)
    i = np.arange(5, dtype=np.int32)
    tree = {"a": torch.from_numpy(g), "b": {"i": torch.from_numpy(i)}}
    small = C.compress_tree(tree, mode)
    want = jcomp({"a": jnp.asarray(g), "b": {"i": jnp.asarray(i)}}, mode)
    assert _dtype_name(small["a"].dtype) == str(want["a"].dtype)
    assert small["b"]["i"].dtype == torch.int32
    np.testing.assert_array_equal(
        small["a"].float().numpy(), np.asarray(want["a"], np.float32))
    back = C.decompress_tree(small, mode)
    assert back["a"].dtype == torch.float32


def test_rank_rows_split_each_microbatch():
    from repro_torch.launch.train import rank_rows
    from repro_torch.parallel.sharding import DataShards

    b = {"tokens": torch.arange(8)[:, None].expand(8, 3),
         "mrope_positions": torch.arange(8)[None, :, None].expand(3, 8, 2)}
    got = rank_rows(b, DataShards(2, 1, None, True), microbatches=2)
    assert got["tokens"][:, 0].tolist() == [2, 3, 6, 7]
    assert got["mrope_positions"][0, :, 0].tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError):
        rank_rows(b, DataShards(3, 0, None, True))


def test_adamw_update_in_slices_is_bit_equal(monkeypatch):
    """AdamW updates a large leaf a slice at a time (bounded f32
    temporaries): the numbers are those of the whole-leaf update."""
    from repro_torch.configs import TrainConfig
    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(0)
    tcfg = TrainConfig(warmup_steps=1)

    def run(chunk):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        g2 = torch.Generator().manual_seed(1)
        params = {"w": torch.randn(37, 29, generator=g2).bfloat16(),
                  "b": torch.randn(53, generator=g2)}
        grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                 for k, v in params.items()}
        state = adamw.init_state(params, tcfg, torch.bfloat16)
        for _ in range(2):
            adamw.apply_updates(params, grads, state, tcfg)
        return params, state

    gen.manual_seed(0)
    want = run(1 << 26)
    gen.manual_seed(0)
    got = run(7)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k])
        assert torch.equal(got[1].mu[k], want[1].mu[k])
        assert torch.equal(got[1].nu[k], want[1].nu[k])


# ------------------------------------------------------------- multi-rank --
def _inputs():
    """Everything both sides read, made here once: the reference's smoke
    parameters, the MoE inputs and each rank's collective inputs."""
    rng = np.random.default_rng(0)
    out = {"trees": {a: _ref_tree(a) for a in TRAIN_ARCHS}}
    for name, shape in MOE_SHAPES.items():
        out[f"x-{name}"] = rng.standard_normal(shape).astype(np.float32)
    import jax

    out["x-probe"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                  MOE_SHAPES["misaligned"]))
    out["x-misfit"] = rng.standard_normal(MISFIT_SHAPE).astype(np.float32)
    out["cot-misfit"] = rng.standard_normal(MISFIT_SHAPE).astype(np.float32)
    out["grad-tokens"] = rng.integers(3, 256, (4, 16)).astype(np.int32)
    for d in (2, 4):
        out[f"psum-int-{d}"] = rng.integers(-64, 64, (d, 257)).astype(
            np.float32)
        out[f"psum-normal-{d}"] = rng.standard_normal((d, 257)).astype(
            np.float32)
    return out


def _moe_params(tree, layer=0):
    return {k: v[layer] for k, v in tree["blocks"]["mlp"].items()}


_REF_SCRIPT = r"""
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import get_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import serve
from repro.launch.train import train
from repro.models import moe as M
from repro.parallel.collectives import compressed_psum

D = {d}
assert jax.device_count() == D
inp = pickle.load(open({inputs!r}, "rb"))
out = {{}}
mesh = make_host_mesh()
for kind in ("int", "normal"):
    x = jnp.asarray(inp[f"psum-{{kind}}-{{D}}"])
    f = compat.shard_map(lambda a: compressed_psum(a, "data", "bf16"),
                         mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    out[f"psum-{{kind}}"] = np.asarray(jax.jit(f)(x))
cfg = get_smoke_config({moe_arch!r})
p = {{k: jnp.asarray(v[0]) for k, v in
      inp["trees"][{moe_arch!r}]["blocks"]["mlp"].items()}}
fn = jax.jit(lambda x, p: M.moe_mlp(x, p, cfg))
for name in {moe_names!r}:
    x = jnp.asarray(inp[f"x-{{name}}"])
    out[f"moe-{{name}}-unsharded"] = np.asarray(fn(x, p))
    with compat.set_mesh(mesh):
        out[f"moe-{{name}}"] = np.asarray(
            jax.jit(lambda x, p: M.moe_mlp(x, p, cfg))(x, p))
for arch in {train_archs!r}:
    out[f"train-{{arch}}"] = [float(v) for v in train(
        arch, True, ckpt_dir=None, log_every=1000, **{train_kw!r})]
if D == 2:
    out["serve"] = serve({moe_arch!r}, True, **{serve_kw!r})
pickle.dump(out, open({out!r}, "wb"))
print("SUBPROCESS_OK")
"""


def _carried_init(trees):
    """``adapters.init_fn`` that loads the reference's smoke parameters of
    the config's architecture (what both sides train and serve from)."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.interop import params_from_arrays
    from repro_torch.launch import adapters

    by_name = {get_smoke_config(a).name: a for a in ARCH_IDS}
    init = adapters.init_fn

    def init_fn(gen, cfg):
        model = init(gen, cfg)
        arch = by_name[cfg.name]
        model.load_state_dict(params_from_arrays(trees[arch], cfg))
        return model

    return init_fn


def _worker(rank, world, store, inputs_path, out_dir):
    """One gloo rank: every case of its D; what it got saved."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import adapters, mesh as M
    from repro_torch.launch import serve as S, train as T
    from repro_torch.models.moe import moe_mlp
    from repro_torch.parallel import collectives as C, sharding
    from repro_torch.parallel.fsdp import ShardedParams

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    for kind in ("int", "normal"):
        x = torch.from_numpy(inp[f"psum-{kind}-{world}"][rank].copy())
        out[f"psum-{kind}"] = C.compressed_psum({"g": x})["g"].numpy()
    mesh = M.make_host_mesh()
    cfg = get_smoke_config(MOE_ARCH)
    p = {k: torch.from_numpy(v.copy())
         for k, v in _moe_params(inp["trees"][MOE_ARCH]).items()}
    for name in MOE_CASES:
        x = torch.from_numpy(inp[f"x-{name}"])
        with sharding.set_mesh(mesh):
            out[f"moe-{name}-replicated"] = moe_mlp(x, p, cfg).numpy()
        rows = x.shape[0] // world
        with sharding.set_mesh(mesh, local_batch=True):
            out[f"moe-{name}-local"] = moe_mlp(
                x[rank * rows:(rank + 1) * rows], p, cfg).numpy()
    adapters.init_fn = _carried_init(inp["trees"])
    for arch in TRAIN_ARCHS:
        out[f"train-{arch}"] = T.train(arch, True, ckpt_dir=None,
                                       log_every=1000, device="cpu",
                                       **TRAIN_KW)
    if world == 2:
        out["serve"], _ = S.serve(MOE_ARCH, True, device="cpu", **SERVE_KW)
        # a sharded checkpoint at step 2 (gathered, rank 0 writes), the
        # step-3 one removed, and the run resumed from it
        ck = os.path.join(out_dir, "ckpt")
        T.train(MOE_ARCH, True, ckpt_dir=ck, checkpoint_every=2,
                log_every=1000, device="cpu", **TRAIN_KW)
        if rank == 0:
            import shutil

            shutil.rmtree(os.path.join(ck, "step_00000003"))
        dist.barrier()
        out["resumed"] = T.train(MOE_ARCH, True, ckpt_dir=ck,
                                 log_every=1000, device="cpu", **TRAIN_KW)
    if world == 4:
        from torch.distributed.device_mesh import init_device_mesh

        for shape in PLACEMENT_MESHES:
            dm = init_device_mesh("cpu", shape,
                                  mesh_dim_names=("data", "model"))
            tmesh = sharding.Mesh.of(dm)
            model = adapters.init_fn(torch.Generator(),
                                     get_smoke_config("llama3-405b"))
            sp = ShardedParams(model, tmesh)
            if shape == (2, 2):
                from torch.distributed.tensor import Replicate, distribute_tensor

                full = torch.arange(48.0).reshape(8, 6)
                x = distribute_tensor(full, dm, [Replicate(), Replicate()])
                with sharding.set_mesh(tmesh):
                    y = sharding.constrain(
                        x, sharding.Spec("model", ("pod", "data")))
                out["constrained"] = (
                    tuple(q.dim if q.is_shard() else None
                          for q in y.placements), y.to_local().numpy())
            out[f"placement-{shape}"] = {
                "coords": {a: dm.get_local_rank(a) for a in ("data",
                                                             "model")},
                "local": {k: v.clone().numpy()
                          for k, v in sp.local().items()},
                "rest": {k: tuple(p.shape) for k, p in sp.params.items()},
                "own": ({id(p) for p in model.parameters()}
                        == {id(p) for p in sp.params.values()}),
                # a slice that kept the whole tensor's storage would hold
                # the whole model (or moment) at rest
                "storage": [(k, t.untyped_storage().nbytes(),
                             t.numel() * t.element_size())
                            for k, t in list(sp.params.items()) + list(
                                sp.shard({k: torch.zeros(sp.shapes[k][0])
                                          for k in sp.params}).items())]}
            if shape == (4, 1):
                out["grads"] = _sharded_grads(model, sp, tmesh,
                                              inp["grad-tokens"], rank)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _sharded_grads(model, sp, mesh, tokens, rank):
    """This rank's share of a global-mean loss over its row of
    ``tokens``, differentiated through the gathered parameters and
    reduced: the slices and the norm, and the gradients made whole."""
    from repro_torch.parallel import sharding

    tokens = torch.from_numpy(tokens)
    names = list(sp.params)
    for p in sp.params.values():
        p.requires_grad_(True)
    with sharding.set_mesh(mesh, local_batch=True):
        logits = model(tokens[rank:rank + 1])
        loss = logits.float().square().sum() / (logits.numel()
                                               * tokens.shape[0])
        grads = torch.autograd.grad(loss, [sp.params[k] for k in names])
        grads, gnorm = sp.reduce(dict(zip(names, grads)))
    return {"sliced": all(grads[k].shape == sp.params[k].shape
                          for k in names),
            "whole": {k: v.numpy() for k, v in sp.full(grads).items()},
            "gnorm": float(gnorm)}


def _worker_misfit(rank, world, store, inputs_path, out_dir):
    """One of ``MISFIT_D`` gloo ranks: the MoE layer on the rank's own
    row, forward and backward, and a short training run."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import adapters, mesh as M, train as T
    from repro_torch.models.moe import moe_mlp
    from repro_torch.parallel import sharding

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg = get_smoke_config(MOE_ARCH)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in _moe_params(inp["trees"][MOE_ARCH]).items()}
    x = torch.from_numpy(inp["x-misfit"][rank:rank + 1].copy())
    x.requires_grad_(True)
    with sharding.set_mesh(M.make_host_mesh(), local_batch=True):
        y = moe_mlp(x, p, cfg)
    cot = torch.from_numpy(inp["cot-misfit"][rank:rank + 1].copy())
    torch.sum(y * cot).backward()
    out = {"moe": y.detach().numpy(), "dx": x.grad.numpy(),
           "dp": {k: v.grad.numpy() for k, v in p.items()}}
    adapters.init_fn = _carried_init(inp["trees"])
    out["train"] = T.train(MOE_ARCH, True, ckpt_dir=None, log_every=1000,
                           device="cpu", **MISFIT_TRAIN_KW)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """{D: (reference's record, [each rank's record])}."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("sharding")
    inputs_path = str(tmp / "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(_inputs(), f)
    with ThreadPoolExecutor(2) as pool:
        refs = {}
        for d in (2, 4):
            script = _REF_SCRIPT.format(
                d=d, inputs=inputs_path, out=str(tmp / f"ref{d}.pkl"),
                moe_arch=MOE_ARCH, moe_names=MOE_CASES,
                train_archs=TRAIN_ARCHS, train_kw=TRAIN_KW,
                serve_kw=SERVE_KW)
            refs[d] = pool.submit(run_subprocess, script, d)
        port = {}
        for d, worker in ((2, _worker), (4, _worker),
                          (MISFIT_D, _worker_misfit)):
            out_dir = tmp / f"D{d}"
            out_dir.mkdir()
            mp.spawn(worker, args=(d, str(tmp / f"store{d}"), inputs_path,
                                   str(out_dir)), nprocs=d, join=True)
            port[d] = [torch.load(out_dir / f"rank{r}.pt",
                                  weights_only=False) for r in range(d)]
        for r in refs.values():
            r.result()
    out = {MISFIT_D: (None, port[MISFIT_D])}
    for d in (2, 4):
        with open(tmp / f"ref{d}.pkl", "rb") as f:
            out[d] = (pickle.load(f), port[d])
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 step at each value's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("kind", ["int", "normal"])
@pytest.mark.parametrize("d", [2, 4])
def test_compressed_psum_equals_reference(multi_rank, d, kind):
    """Integer-valued inputs: bit-equal. N(0, 1) inputs: within one bf16
    step at the largest magnitude a partial sum can reach (the sum of the
    ranks' magnitudes): the reference's psum adds the bf16 values in f32
    and rounds once, gloo (and NCCL) round each partial sum to bf16."""
    ref, ranks = multi_rank[d]
    want = ref[f"psum-{kind}"]                  # [D, n]: every row the sum
    x = _inputs()[f"psum-{kind}-{d}"]
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    step = _bf16_ulp(np.abs(xb).sum(0))
    for r, got in enumerate(ranks):
        g = got[f"psum-{kind}"]
        assert g.dtype == np.float32
        if kind == "int":
            np.testing.assert_array_equal(g, want[r])
        else:
            assert np.all(np.abs(g - want[r]) <= step), r


@pytest.mark.parametrize("layout", ["replicated", "local"])
@pytest.mark.parametrize("regime", sorted(MOE_CASES))
@pytest.mark.parametrize("d", [2, 4])
def test_moe_equals_reference(multi_rank, d, regime, layout):
    """The shard-local dispatch and combine equal the reference's, the
    dropped edges of the misaligned regime included; with the input whole
    on every rank each returns the whole output, with its own rows its
    rows."""
    ref, ranks = multi_rank[d]
    want = ref[f"moe-{regime}"]
    rows = want.shape[0] // d
    for r, got in enumerate(ranks):
        g = got[f"moe-{regime}-{layout}"]
        w = want if layout == "replicated" else want[r * rows:(r + 1) * rows]
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= MOE_TOL, (r, err)


@pytest.mark.parametrize("d", [2, 4])
def test_misaligned_groups_drop_edges_as_the_reference(multi_rank, d):
    """Reference caveat 5, pinned: with one routing group across the
    shards the sharded layer differs from the unsharded one (edges
    dropped); with groups whole in shards it does not. The port's
    unsharded call equals the reference's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import moe_mlp

    ref, ranks = multi_rank[d]
    cfg = get_smoke_config(MOE_ARCH)
    p = {k: torch.from_numpy(v.copy())
         for k, v in _moe_params(_ref_tree(MOE_ARCH)).items()}
    x = _inputs()
    for regime in MOE_CASES:
        unsharded = moe_mlp(torch.from_numpy(x[f"x-{regime}"].copy()), p,
                            cfg).numpy()
        assert np.abs(unsharded - ref[f"moe-{regime}-unsharded"]).max() \
            <= MOE_TOL
        gap = np.abs(ranks[0][f"moe-{regime}-replicated"] - unsharded).max()
        ref_gap = np.abs(ref[f"moe-{regime}"]
                         - ref[f"moe-{regime}-unsharded"]).max()
        if regime == "aligned":
            assert gap <= MOE_TOL and ref_gap <= MOE_TOL, (gap, ref_gap)
        else:
            assert gap > 1.0 and abs(gap - ref_gap) <= MOE_TOL, (gap, ref_gap)
        if regime == "probe" and d == 4:
            assert abs(ref_gap - PROBE_GAP) <= 1e-4, ref_gap


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_training_equals_reference(multi_rank, d, arch):
    """Three smoke steps at D ranks (parameters and moments sharded, each
    rank its rows, the global masked mean) give the reference's losses at
    D host devices, on every rank."""
    ref, ranks = multi_rank[d]
    want = np.asarray(ref[f"train-{arch}"])
    assert len(want) == TRAIN_KW["steps"]
    for r, got in enumerate(ranks):
        err = np.abs(np.asarray(got[f"train-{arch}"]) - want) / np.abs(want)
        assert err.max() <= LOSS_TOL, (r, got[f"train-{arch}"], want)


def test_sharded_checkpoint_resumes_the_reference_run(multi_rank):
    """At D = 2: the step-2 checkpoint that the ranks gathered and rank 0
    wrote, resumed on both ranks, gives the reference's third loss."""
    ref, ranks = multi_rank[2]
    want = ref[f"train-{MOE_ARCH}"][2]
    for got in ranks:
        assert len(got["resumed"]) == 1
        assert abs(got["resumed"][0] - want) / abs(want) <= LOSS_TOL


def test_sharded_serve_equals_reference(multi_rank):
    ref, ranks = multi_rank[2]
    want = {int(k): [int(t) for t in v] for k, v in ref["serve"].items()}
    for got in ranks:
        assert got["serve"] == want


def test_constrain_redistributes_a_dtensor(multi_rank):
    """Under a mesh with ranks, ``constrain`` lays a DTensor out as the
    spec says (axes the mesh lacks dropped): rows over ``model``,
    columns over ``data``."""
    _, ranks = multi_rank[4]
    full = np.arange(48.0, dtype=np.float32).reshape(8, 6)
    for got in ranks:
        placements, local = got["constrained"]
        assert placements == (1, 0)
        c = got["placement-(2, 2)"]["coords"]
        np.testing.assert_array_equal(
            local, full[4 * c["model"]:4 * (c["model"] + 1),
                        3 * c["data"]:3 * (c["data"] + 1)])


@pytest.mark.parametrize("shape", PLACEMENT_MESHES)
def test_placements_are_the_spec_slices(multi_rank, shape):
    """At rest each rank holds, bit for bit, the slice of each of the
    reference's stacked arrays that the reference's spec names for its
    mesh coordinates (block ``i``'s parameter is stacked row ``i``), the
    module's parameters are those slices, and they and the sliced
    moments hold no more storage than their own elements."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.parallel.sharding import param_specs as jspecs

    tree = _ref_tree("llama3-405b")
    mesh = compat.abstract_mesh(shape, ("data", "model"))
    specs = _ref_leaves(jspecs(jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree), mesh))
    flat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    sizes = dict(zip(("data", "model"), shape))
    _, ranks = multi_rank[4]
    split = 0
    for got in ranks:
        rec = got[f"placement-{shape}"]
        for path, full in flat.items():
            spec = specs[path] + (None,) * (full.ndim - len(specs[path]))
            idx = []
            for dim, entry in enumerate(spec):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                n, i = 1, 0
                for a in axes:
                    i, n = i * sizes[a] + rec["coords"][a], n * sizes[a]
                step = full.shape[dim] // n
                idx.append(slice(i * step, (i + 1) * step))
                split += n > 1
            want = full[tuple(idx)]
            parts = path.split("/")
            if parts[0] == "blocks":
                for layer in range(full.shape[0]):
                    key = ".".join([parts[0], str(layer)] + parts[1:])
                    np.testing.assert_array_equal(rec["local"][key],
                                                  want[layer], err_msg=key)
                    assert rec["rest"][key] == want[layer].shape
            else:
                np.testing.assert_array_equal(rec["local"][path], want,
                                              err_msg=path)
                assert rec["rest"][path] == want.shape
        assert rec["own"]
        for key, held, size in rec["storage"]:
            assert held == size, (key, held, size)
    assert split > 0


def test_sharded_gradients_are_summed_slices(multi_rank):
    """At D = 4 on mesh (4,1), each rank differentiating its share of a
    global-mean loss through the gathered parameters gets, after
    ``reduce``, its slice of the whole batch's gradient (f32, 1e-5
    relative to each leaf's largest) and its global norm."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import params_from_arrays
    from repro_torch.launch import adapters

    cfg = get_smoke_config("llama3-405b")
    model = adapters.init_fn(torch.Generator(), cfg)
    model.load_state_dict(params_from_arrays(_ref_tree("llama3-405b"), cfg))
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    tokens = torch.from_numpy(_inputs()["grad-tokens"])
    logits = model(tokens)
    loss = logits.float().square().sum() / logits.numel()
    want = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    norm = float(torch.sqrt(sum(torch.sum(g.square()) for g in
                                want.values())))
    _, ranks = multi_rank[4]
    for got in ranks:
        rec = got["grads"]
        assert rec["sliced"]
        assert set(rec["whole"]) == set(want)
        for k, w in want.items():
            w = w.numpy()
            err = np.abs(rec["whole"][k] - w).max()
            assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (k, err)
        assert abs(rec["gnorm"] - norm) <= 1e-5 * norm


def test_moe_global_path_where_columns_do_not_split(multi_rank):
    """At D = 3 the layer's 64 buffer columns do not split over the
    shards, so each rank, holding its own row, takes the global path as
    the reference does (it equals the unsharded layer there): the ranks'
    rows are the reference's output, each rank's input gradient its rows
    of the reference's, and the parameter gradients summed over the
    ranks the reference's (f32, ``MOE_TOL`` on the output, 1e-5 relative
    on the gradients)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import moe as JM

    cfg = jsmoke(MOE_ARCH)
    inp = _inputs()
    p = {k: jnp.asarray(v) for k, v in _moe_params(_ref_tree(MOE_ARCH)
                                                   ).items()}
    x = jnp.asarray(inp["x-misfit"])
    y, vjp = jax.vjp(lambda x, p: JM.moe_mlp(x, p, cfg), x, p)
    dx, dp = vjp(jnp.asarray(inp["cot-misfit"]))
    _, ranks = multi_rank[MISFIT_D]

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    got_y = np.concatenate([r["moe"] for r in ranks])
    assert np.abs(got_y - np.asarray(y)).max() <= MOE_TOL
    close(np.concatenate([r["dx"] for r in ranks]), dx)
    for k, want in dp.items():
        close(sum(r["dp"][k] for r in ranks), want)


def test_sharded_training_where_columns_do_not_split(multi_rank):
    """Two smoke steps of granite-moe at D = 3 (3 rows of 64 tokens: the
    MoE layers take their global path) give the reference's losses
    within 1e-5 relative, on every rank."""
    from repro.launch.train import train

    want = np.asarray(train(MOE_ARCH, True, ckpt_dir=None, log_every=1000,
                            **MISFIT_TRAIN_KW))
    for r, got in enumerate(multi_rank[MISFIT_D][1]):
        err = np.abs(np.asarray(got["train"]) - want) / np.abs(want)
        assert err.max() <= LOSS_TOL, (r, got["train"], want)
