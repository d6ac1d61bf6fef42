"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40 experts top-8 (fine-grained experts).
[hf:ibm-granite/granite-3.0-3b-a800m-base family; hf]
Note: the assignment lists "MoE 40e top-8" alongside the 1b-a400m source tag
(32e); we follow the explicit 40e top-8 spec.
Uses the Skipper b-matching router by default — the paper technique as a
first-class MoE feature (DESIGN.md §3)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, num_experts_per_tok=8, moe_router="skipper",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=256,
    num_experts=8, num_experts_per_tok=2, moe_router="skipper",
    dtype="float32", remat=False,
)
