"""mamba2-780m [ssm] — 48L d1536 attn-free, vocab 50280, ssm_state=128,
SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=8,
    ssm_expand=2,
    tie_embeddings=True,
    param_dtype="float32",
    act_dtype="float32",
)
