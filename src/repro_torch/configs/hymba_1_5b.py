"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5) d_ff 5504, vocab 32001,
ssm_state=16; parallel attn+mamba heads; SWA except 3 full-attention
layers (first/middle/last). [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    d_head=64,
    ssm_state=16,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_expand=2,
    attn_window=1024,
    full_attn_every=1,        # keep {first, middle, last} full-attention
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    d_head=16,
    ssm_state=8,
    ssm_headdim=16,
    ssm_chunk=8,
    ssm_expand=2,
    attn_window=8,
    full_attn_every=1,
    param_dtype="float32",
    act_dtype="float32",
)
