"""chameleon-34b [vlm] — 48L d8192 64H (GQA kv=8) d_ff 22016, vocab 65536.
Early fusion: VQ image tokens live in the vocab, so the frontend stub is
the tokenizer itself; the backbone is a dense LM with qk-norm.
[arXiv:2405.09818]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    d_head=128,
    qk_norm=True,             # chameleon stabilizes with qk-norm
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="chameleon-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    d_head=32,
    qk_norm=True,
    param_dtype="float32",
    act_dtype="float32",
)
