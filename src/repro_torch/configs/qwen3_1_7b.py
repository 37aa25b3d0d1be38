"""qwen3-1.7b [dense] — 28L d2048 16H (GQA kv=8) d_ff 6144, vocab 151936,
qk_norm, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    d_head=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    d_head=32,
    qk_norm=True,
    tie_embeddings=True,
    param_dtype="float32",
    act_dtype="float32",
)
