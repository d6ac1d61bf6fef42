"""whisper-large-v3 [audio] — enc-dec, 32+32L d_model=1280 20H (MHA)
d_ff=5120 vocab=51866; conv frontend STUBBED to precomputed 1500-frame
embeddings (input_specs). train_4k = 4096 decoder tokens teacher-forced
against the standard 1500-frame encoder. [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, encoder_layers=32, encoder_frames=1500,
    d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    norm="layernorm", act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, encoder_layers=2, encoder_frames=32,
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    norm="layernorm", act="gelu", tie_embeddings=True,
    dtype="float32", remat=False,
)
