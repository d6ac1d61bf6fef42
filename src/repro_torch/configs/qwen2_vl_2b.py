"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE + dynamic resolution (vision tower stubbed to
precomputed patch embeddings). [arXiv:2409.12191; hf]
M-RoPE sections (t,h,w) = (16,24,24) over head_dim/2 = 64 freq slots."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, qkv_bias=True,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, qkv_bias=True,
    mrope_sections=(2, 3, 3), dtype="float32", remat=False,
)
