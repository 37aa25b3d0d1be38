"""minitron-8b [dense] — 32L d4096 32H (GQA kv=8) d_ff 16384, vocab 256000.
Pruned nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=256_000,
    d_head=128,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="minitron-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=768,
    d_head=32,
    param_dtype="float32",
    act_dtype="float32",
)
