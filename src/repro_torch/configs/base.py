"""Architecture configuration schema, without JAX.

The twin of ``repro/configs/base.py``'s ``ArchConfig``: the same fields
with the same defaults (a test holds the two field sets equal), and the
derived sizes and the per-layer window schedule the port reads.  Fields
of the family the port does not run yet (encoder-decoder) are kept so a
config reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One LM-family architecture."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attn-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- hybrid (hymba) ------------------------------------------------------
    attn_window: Optional[int] = None      # sliding window for SWA layers
    full_attn_every: int = 0               # 0 = all full attention

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_ratio: float = 1.0

    # --- numerics ------------------------------------------------------------
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    kv_cache_dtype: str = "auto"           # "auto" follows act_dtype

    # --- paper technique -----------------------------------------------------
    use_pallas_kernels: bool = False       # JAX package only (TPU kernels)
    binary_mlp: bool = False
    packed_weights: bool = False
    packed_weight_bits: int = 4

    def __post_init__(self):
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: heads {self.n_heads} % kv "
                             f"{self.n_kv_heads} != 0")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (logits beyond vocab_size are masked
        at decode)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def subquadratic(self) -> bool:
        """An SSM, or a hybrid whose attention is windowed."""
        return self.has_ssm and (
            self.family == "ssm"
            or (self.family == "hybrid" and self.attn_window is not None))

    def layer_window(self, layer: int) -> Optional[int]:
        """Layer ``layer``'s sliding window: ``attn_window``, except the
        full-attention layers {first, middle, last} when
        ``full_attn_every`` is set (hymba)."""
        if self.attn_window is None:
            return None
        if self.full_attn_every:
            if layer in {0, self.n_layers // 2, self.n_layers - 1}:
                return None
        return self.attn_window
