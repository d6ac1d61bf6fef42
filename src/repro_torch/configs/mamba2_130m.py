"""mamba2-130m [ssm] — 24L d_model=768 attention-free, ssm_state=128,
SSD (state-space duality), vocab=50280, tied embeddings.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256, tie_embeddings=True,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
    dtype="float32", remat=False,
)
