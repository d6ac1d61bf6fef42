"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783; unverified]
opt_state_dtype=bf16: at 405B params, f32 Adam moments alone outgrow a
256-device mesh's memory; bf16 moments (FSDP implementations with 16-bit
optimizer state) bring train_4k under it (``launch.dryrun``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    rope_theta=5e5, opt_state_dtype="bfloat16", seq_sharded_residual=True,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, dtype="float32", remat=False,
)
