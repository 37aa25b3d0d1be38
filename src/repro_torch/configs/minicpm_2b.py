"""minicpm-2b [dense] — 40L d2304 36H (MHA kv=36) d_ff 5760, vocab 122753.
[arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    d_head=64,
    tie_embeddings=True,      # minicpm ties embeddings
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="minicpm-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=6,
    d_ff=192,
    vocab_size=512,
    d_head=16,
    tie_embeddings=True,
    param_dtype="float32",
    act_dtype="float32",
)
