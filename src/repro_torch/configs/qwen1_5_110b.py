"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-110B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6, opt_state_dtype="bfloat16", seq_sharded_residual=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, qkv_bias=True, dtype="float32", remat=False,
)
