"""moonshot-v1-16b-a3b [moe] — 48L d2048 16H (MHA kv=16) expert d_ff=1408,
vocab 163840, MoE 64 experts top-6 plus 2 shared experts (moonlight-style)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                # per-expert FFN width
    vocab_size=163_840,
    d_head=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    rope_theta=50_000.0,
)

SMOKE = ArchConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    d_head=32,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    capacity_factor=2.0,
    param_dtype="float32",
    act_dtype="float32",
)
