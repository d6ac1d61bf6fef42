"""End-to-end training with the PyTorch + CUDA port: a ~100M-parameter
llama3.2-family model, trained for a few hundred steps with
matching-based sequence packing and (with ``--ckpt-dir``) checkpoints that
a rerun resumes from.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \
        --steps 3 --layers 2 --batch 2 --seq 64

On a CUDA device the packer matches through the hand-written global-tier
kernel; on the CPU through its plain PyTorch version.
"""
import argparse
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod

# ~100M params: 12L x 768d llama-style with a 32k vocab
LM100M = ModelConfig(
    name="lm-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
    d_ff=2048, vocab_size=32000, tie_embeddings=True,
    dtype="float32", remat=False,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=LM100M.num_layers,
                    help="depth of the model (a shallower one for a quick "
                    "run)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint there every 100 steps and resume from "
                    "its latest step")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(LM100M, num_layers=args.layers)

    # train() resolves architectures by name: have it resolve this one
    def get(arch):
        if arch != cfg.name:
            raise KeyError(arch)
        return cfg

    train_mod.get_config = train_mod.get_smoke_config = get
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    per_layer = 2 * d * d + 2 * d * kv + 3 * d * f + 2 * d
    n = cfg.num_layers * per_layer + v * d + d
    print(f"[example] {cfg.name}: {n / 1e6:.0f}M params, {cfg.num_layers} "
          f"layers, {args.steps} steps, batch {args.batch} x seq {args.seq} "
          f"on {args.device}")
    losses = train_mod.train(
        cfg.name, smoke=False, steps=args.steps, batch_size=args.batch,
        seq_len=args.seq, ckpt_dir=args.ckpt_dir, checkpoint_every=100,
        device=args.device)
    if losses:
        print(f"[example] loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
