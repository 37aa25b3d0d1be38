"""Architecture configuration schema, without JAX.

The twin of ``repro/configs/base.py``'s ``ArchConfig``: the same fields
with the same defaults (a test holds the two field sets equal), and the
derived sizes, the per-layer window schedule and the analytic parameter
counts; and the assigned input shapes (``SHAPES``) with their meta-device
stand-ins (``input_specs``), which the dry-run runs a step over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


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

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head), the
        reference's formula."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                    # embed
        if not self.tie_embeddings:
            total += v * d                               # lm head
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim \
                + self.q_dim * d
            per_layer += 2 * d                           # norms
            if self.qk_norm:
                per_layer += 2 * self.d_head
        if self.has_ssm:
            di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di + 2 * n + h)        # in_proj(z,x,B,C,dt)
            per_layer += di * self.ssm_conv + di         # conv + D
            per_layer += h                               # A_log
            per_layer += di * d                          # out_proj
        if self.n_experts:
            per_layer += d * self.n_experts              # router
            per_layer += self.n_experts * 3 * d * self.d_ff
            per_layer += self.n_shared_experts * 3 * d * self.d_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff               # SwiGLU
        per_layer += d                                   # final/extra norm
        total += self.n_layers * per_layer
        if self.is_encoder_decoder:
            enc_layer = 4 * d * d + 3 * d * self.d_ff + 2 * d
            total += self.n_enc_layers * enc_layer
            total += self.n_layers * (4 * d * d + d)     # cross attention
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        expert_params = self.n_layers * self.n_experts * 3 * self.d_model \
            * self.d_ff
        active_expert = self.n_layers * (self.top_k + self.n_shared_experts) \
            * 3 * self.d_model * self.d_ff
        return self.param_count() - expert_params + active_expert


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input (no allocation), the
    counterpart of the reference's ``ShapeDtypeStruct`` specs.

    train/prefill: token ids (B, S) (train adds targets; an
    encoder-decoder adds its precomputed frame embeddings, the stubbed
    frontend); decode: one new token per sequence and its position."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if shape.kind == "decode":
        return {"tokens": spec((b, 1)), "positions": spec((b,))}
    specs = {"tokens": spec((b, s))}
    if shape.kind == "train":
        specs["targets"] = spec((b, s))
    if cfg.is_encoder_decoder:
        specs["enc_frames"] = spec((b, int(s * cfg.enc_seq_ratio),
                                    cfg.d_model), getattr(torch, cfg.act_dtype))
    return specs
