"""whisper-tiny [audio] — 4L enc + 4L dec, d384 6H d_ff 1536, vocab 51865.
Encoder-decoder; the conv frontend is stubbed, as in the JAX package: the
encoder takes precomputed frame embeddings (B, S_enc, d_model).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    d_head=64,
    is_encoder_decoder=True,
    n_enc_layers=4,
    enc_seq_ratio=1.0,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    d_head=16,
    is_encoder_decoder=True,
    n_enc_layers=2,
    param_dtype="float32",
    act_dtype="float32",
)
