"""zamba2-2.7b [hybrid] — 54 Mamba-2 layers d_model=2560, one SHARED
attention block (32H MHA + d_ff=10240 MLP) applied every 6 layers,
ssm_state=64, vocab=32000. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=64,
    shared_attn_period=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
    shared_attn_period=2, dtype="float32", remat=False,
)
