"""Batched serving with the PyTorch + CUDA port: prefill and decode with
continuous slot refill over the qwen1.5-0.5b smoke config.

    PYTHONPATH=src python examples/serve_lm_torch.py                # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    outputs, _ = serve("qwen1.5-0.5b", smoke=True, num_requests=8, slots=4,
                       prompt_len=32, max_new=12, device=args.device)
    for rid, toks in sorted(outputs.items()):
        more = "..." if len(toks) > 8 else ""
        print(f"request {rid}: {len(toks)} tokens -> {toks[:8]}{more}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
