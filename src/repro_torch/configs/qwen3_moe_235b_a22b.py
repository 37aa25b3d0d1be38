"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) expert d_ff=1536,
vocab 151936, MoE 128 experts top-8, no shared experts."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                # per-expert FFN width
    vocab_size=151_936,
    d_head=128,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    n_shared_experts=0,
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    d_head=32,
    qk_norm=True,
    n_experts=8,
    top_k=2,
    capacity_factor=2.0,
    param_dtype="float32",
    act_dtype="float32",
)
