"""mistral-nemo-12b [dense] — 40L d5120 32H (GQA kv=8) d_ff 14336,
vocab 131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    d_head=128,
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="mistral-nemo-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    d_head=32,
    param_dtype="float32",
    act_dtype="float32",
)
