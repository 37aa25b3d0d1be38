"""Sub-byte (MSR-coded) weight packing with a sparse outlier sidecar.

The port's copy of ``repro/kernels/pack.py``.  An int8 weight matrix
(K, N) is stored as dense sub-byte codes plus an exact correction
sidecar:

* per-column(-group) symmetric int8 pre-quantization
  (``core.quant.symmetric_int8``) -> ``q`` (K, N) int8, ``scale``
  (1, N) float32;
* offset-binary codes ``u = clip(q, lo, hi) + 2**(bits-1)`` with
  ``[lo, hi] = [-2**(bits-1), 2**(bits-1)-1]``, bits in {4, 5};
* **nibble plane** ``codes``: (K/8, N) int32, the low 4 code bits of 8
  consecutive K rows per word (row ``r*8 + t`` in bits ``[4t, 4t+4)``);
* **bit plane** ``highbits`` (bits == 5 only): (K/32, N) int32, code bit
  4 of 32 consecutive K rows per word;
* **outlier sidecar**: the K rows where ``q`` leaves ``[lo, hi]`` are
  stored exactly as ``delta = q_row - clip(q_row)`` under
  ``(outlier_idx (R,) int32, outlier_delta (R, N) int32)``; unused
  capacity slots carry ``idx == k_pad`` and zero deltas.

K is padded to a multiple of 32 at pack time; the pad rows encode the
value 0 exactly.  Words are int32 tensors holding the JAX package's
uint32 words bit for bit (it bitcasts them to int32 too): packing
builds them in int64 and wraps values at or above 2**31, since the top
nibble sets the sign bit.

The CUDA kernels decode the planes in-register at the tile load
(``csrc/pack_common.cuh``, B6); :func:`unpack_block` is that decode's
plain version, and the ``unpack_*`` functions are the oracles' exact
int8 images.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.quant import symmetric_int8

WORD_NIBBLES = 8       # 4-bit codes per int32 word (nibble plane)
WORD_BITS = 32         # bit-plane entries per int32 word
PACK_BITS = (4, 5)     # supported code widths


def outlier_capacity(k: int) -> int:
    """Worst-case MSR outlier rows for a K-deep weight: <=3 per 256."""
    return max(1, -(-(3 * k) // 256))


def packed_bytes(k: int, n: int, bits: int) -> int:
    """Bytes of a packed (k, n) weight in device memory: the planes and a
    sidecar at ``outlier_capacity(k)`` (an int32 row index and an int32
    delta row a slot), as the reference's cost model charges them."""
    kp = -(-k // WORD_BITS) * WORD_BITS
    words = kp // WORD_NIBBLES + (kp // WORD_BITS if bits == 5 else 0)
    return words * n * 4 + outlier_capacity(k) * (4 + 4 * n)


def _code_range(bits: int) -> Tuple[int, int]:
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def _wrap_i32(words: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 words below 2**32 -> int32 with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _pack_plane(u: torch.Tensor, per_word: int, width: int) -> torch.Tensor:
    """(K, N) fields of ``width`` bits -> (K/per_word, N) int32 words,
    row ``r*per_word + t`` in bits ``[width*t, width*(t+1))``."""
    kp, n = u.shape
    w = u.to(torch.int64).reshape(kp // per_word, per_word, n)
    shifts = (torch.arange(per_word, device=u.device) * width)[None, :, None]
    return _wrap_i32((w << shifts).sum(dim=1))


def _pack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """(K, N) codes in [0, 16) -> (K/8, N) int32 words (K % 8 == 0)."""
    return _pack_plane(u, WORD_NIBBLES, 4)


def _pack_bits(b: torch.Tensor) -> torch.Tensor:
    """(K, N) bits in {0, 1} -> (K/32, N) int32 words (K % 32 == 0)."""
    return _pack_plane(b, WORD_BITS, 1)


def unpack_block(words: torch.Tensor, hi_words: Optional[torch.Tensor],
                 bits: int, rows: int) -> torch.Tensor:
    """Decode packed int32 words to int8 values: the plain version of
    the kernels' in-register decompress.

    ``words`` is a (rows/8, cols) nibble plane, ``hi_words`` the
    matching (rows/32, cols) bit plane when ``bits == 5``.  (The
    arithmetic right shift on int32 drags sign bits through the top
    nibble; the ``& 0xF`` mask discards them.)
    """
    cols = words.shape[-1]
    shifts = (torch.arange(WORD_NIBBLES, dtype=torch.int32,
                           device=words.device) * 4)[None, :, None]
    u = ((words[:, None, :] >> shifts) & 0xF).reshape(rows, cols)
    if bits == 5:
        hs = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=words.device)[None, :, None]
        hb = (hi_words[:, None, :] >> hs) & 0x1
        u = u + (hb.reshape(rows, cols) << 4)
    return (u - (1 << (bits - 1))).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class PackedWeights:
    """Packed sub-byte weight planes, per-column scales and the outlier
    sidecar.  A stacked per-layer parameter carries a leading ``L`` axis
    on every leaf; ``layer(i)`` is layer i's view."""

    LEAVES = ("codes", "highbits", "scale", "outlier_idx", "outlier_delta")

    codes: torch.Tensor                 # (k_pad/8, n) int32 nibble plane
    highbits: Optional[torch.Tensor]    # (k_pad/32, n) int32, bits == 5
    scale: torch.Tensor                 # (1, n) float32 per column(-group)
    outlier_idx: torch.Tensor           # (r,) int32; k_pad marks empty slots
    outlier_delta: torch.Tensor         # (r, n) int32 exact row corrections
    bits: int                           # 4 or 5
    k: int                              # true reduction length
    n: int

    @property
    def k_pad(self) -> int:
        return self.codes.shape[-2] * WORD_NIBBLES

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "PackedWeights":
        """These weights with ``fn`` applied to each tensor leaf."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else fn(getattr(self, f))
            for f in self.LEAVES})

    def layer(self, i: int) -> "PackedWeights":
        return self.map(lambda t: t[i])


def stack(items) -> PackedWeights:
    """Per-layer packed weights of one shape -> one ``PackedWeights``
    whose leaves carry a leading layer axis."""
    first = items[0]
    return dataclasses.replace(first, **{
        f: None if getattr(first, f) is None
        else torch.stack([getattr(it, f) for it in items])
        for f in first.LEAVES})


def _pack_core(qp: torch.Tensor, bits: int, max_outliers: Optional[int]):
    """Planes and sidecar of a row-padded (Kp, N) integer matrix
    (Kp % 32 == 0) -> (codes, highbits, idx, delta)."""
    kp = qp.shape[0]
    qp = qp.to(torch.int32)
    lo, hi = _code_range(bits)
    trunc = torch.clamp(qp, lo, hi)
    u = trunc + (1 << (bits - 1))              # offset-binary, >= 0
    codes = _pack_nibbles(u & 0xF)
    highbits = _pack_bits((u >> 4) & 0x1) if bits == 5 else None

    is_out = (qp != trunc).any(dim=1)          # (kp,) rows with no MSR run
    rows = torch.nonzero(is_out).flatten().to(torch.int32)
    if max_outliers is not None:
        cap = int(max_outliers)
        if rows.numel() > cap:
            raise ValueError(f"{rows.numel()} outlier rows exceed "
                             f"max_outliers={cap}")
        rows = torch.cat([rows, torch.full((cap - rows.numel(),), kp,
                                           dtype=torch.int32,
                                           device=qp.device)])
    real = rows < kp
    safe = torch.where(real, rows, torch.zeros_like(rows)).long()
    delta = torch.where(real[:, None], qp[safe] - trunc[safe],
                        torch.zeros((), dtype=torch.int32,
                                    device=qp.device))
    return codes, highbits, rows, delta.to(torch.int32)


def pack_int8(q: torch.Tensor, scale: torch.Tensor, bits: int = 4,
              max_outliers: Optional[int] = None) -> PackedWeights:
    """Pack an int8 weight matrix (K, N) into sub-byte planes + sidecar.

    ``max_outliers=None`` sizes the sidecar to the outlier rows found;
    an int gives a fixed capacity (empty slots ``idx == k_pad``) and
    raises when the rows do not fit.
    """
    if bits not in PACK_BITS:
        raise ValueError(f"weight_bits must be one of {PACK_BITS}, got {bits}")
    if q.ndim != 2:
        raise ValueError(f"expected a (K, N) weight matrix, got "
                         f"{tuple(q.shape)}")
    k, n = q.shape
    qp = q.to(torch.int32)
    pad = (-k) % WORD_BITS
    if pad:
        qp = torch.nn.functional.pad(qp, (0, 0, 0, pad))  # 0 encodes exactly
    codes, highbits, idx, delta = _pack_core(qp, bits, max_outliers)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=q.device).reshape(1, -1).expand(1, n)
    return PackedWeights(codes, highbits, scale.contiguous(), idx, delta,
                         bits, k, n)


def pack_weights(w: torch.Tensor, bits: int = 4, group_size: int = 1,
                 max_outliers: Optional[int] = None) -> PackedWeights:
    """Quantize a float weight matrix (K, N) to int8 and pack it.

    The symmetric int8 scale is shared per group of ``group_size``
    adjacent output columns (group 1 = per column): constant along the
    reduction, so the kernels apply it once at the flush.
    """
    k, n = w.shape
    if group_size <= 0 or n % group_size:
        raise ValueError(f"group_size {group_size} must divide n={n}")
    wg = w.reshape(k, n // group_size, group_size)
    qg, sg = symmetric_int8(wg, axis=(0, 2))          # (1, G, 1) scales
    scale = sg.expand(1, n // group_size, group_size).reshape(1, n)
    return pack_int8(qg.reshape(k, n), scale, bits=bits,
                     max_outliers=max_outliers)


def unpack_codes(pw: PackedWeights) -> torch.Tensor:
    """Dense int8 matrix (k, n) from the planes alone (outlier rows still
    truncated: what the kernels' decode gives before the sidecar)."""
    return unpack_block(pw.codes, pw.highbits, pw.bits, pw.k_pad)[: pw.k]


def _scatter_outliers(q: torch.Tensor, idx: torch.Tensor,
                      delta: torch.Tensor) -> torch.Tensor:
    """``q`` (rows, n) int32 plus the sidecar rows; slots at or past
    ``rows`` are empty and drop out."""
    real = idx < q.shape[0]
    return q.index_add(0, idx[real].long(), delta[real])


def unpack_planes(codes: torch.Tensor, highbits: Optional[torch.Tensor],
                  bits: int, k: int,
                  outlier_idx: Optional[torch.Tensor] = None,
                  outlier_delta: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Exact (k, n) int8 matrix of the planes and their sidecar (none:
    the truncated codes)."""
    q = unpack_block(codes, highbits, bits, codes.shape[0] * WORD_NIBBLES)
    if outlier_idx is not None:
        q = _scatter_outliers(q.to(torch.int32), outlier_idx, outlier_delta)
    return q[:k].to(torch.int8)


def unpack_weights(pw: PackedWeights
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact int8 reconstruction -> (q (k, n) int8, scale (1, n) f32)."""
    return unpack_planes(pw.codes, pw.highbits, pw.bits, pw.k,
                         pw.outlier_idx, pw.outlier_delta), pw.scale


def dequantize(pw: PackedWeights,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Float reconstruction (k, n): exact int8 image times the scale."""
    q, scale = unpack_weights(pw)
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# Conv weights: the same planes, laid out per filter tap.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PackedConvWeights:
    """Packed (fh, fw, C, K) conv weights.

    Channels are padded to a multiple of 32 per tap, so a 32-deep
    reduction step never straddles two taps.  Outlier rows live in the
    flattened ``(ky * fw + kx) * cin_pad + c`` index space; empty slots
    carry ``idx == fh * fw * cin_pad`` and zero deltas.
    """

    codes: torch.Tensor                 # (fh, fw, cin_pad/8, kout) int32
    highbits: Optional[torch.Tensor]    # (fh, fw, cin_pad/32, kout) int32
    scale: torch.Tensor                 # (1, kout) float32 per channel
    outlier_idx: torch.Tensor           # (r,) int32 flat tap-channel rows
    outlier_delta: torch.Tensor         # (r, kout) int32
    bits: int
    fh: int
    fw: int
    cin: int                            # true input channels
    cin_pad: int                        # per-tap padded channels
    kout: int


def pack_conv_weights(w: torch.Tensor, bits: int = 4,
                      max_outliers: Optional[int] = None
                      ) -> PackedConvWeights:
    """Quantize (fh, fw, C, K) conv weights per output channel and pack."""
    if bits not in PACK_BITS:
        raise ValueError(f"weight_bits must be one of {PACK_BITS}, got {bits}")
    fh, fw, c, kout = w.shape
    q, scale = symmetric_int8(w, axis=(0, 1, 2))      # scale (1, 1, 1, K)
    cp = c + ((-c) % WORD_BITS)
    qp = torch.nn.functional.pad(q.to(torch.int32), (0, 0, 0, cp - c))
    codes, highbits, idx, delta = _pack_core(
        qp.reshape(fh * fw * cp, kout), bits, max_outliers)
    codes = codes.reshape(fh, fw, cp // WORD_NIBBLES, kout)
    if highbits is not None:
        highbits = highbits.reshape(fh, fw, cp // WORD_BITS, kout)
    return PackedConvWeights(codes, highbits, scale.reshape(1, kout),
                             idx, delta, bits, fh, fw, c, cp, kout)


def unpack_conv_weights(pcw: PackedConvWeights
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact int8 reconstruction -> (q (fh, fw, cin, K) int8, scale)."""
    return unpack_conv_planes(pcw.codes, pcw.highbits, pcw.bits, pcw.cin,
                              pcw.outlier_idx, pcw.outlier_delta), pcw.scale


def unpack_conv_planes(codes: torch.Tensor, highbits: Optional[torch.Tensor],
                       bits: int, cin: int,
                       outlier_idx: Optional[torch.Tensor] = None,
                       outlier_delta: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Exact (fh, fw, cin, K) int8 filter of per-tap planes (fh, fw,
    cin_pad/8, K) and their sidecar."""
    fh, fw, cw, kout = codes.shape
    rows = fh * fw * cw * WORD_NIBBLES
    hi = None if highbits is None else highbits.reshape(-1, kout)
    q = unpack_planes(codes.reshape(-1, kout), hi, bits, rows, outlier_idx,
                      outlier_delta)
    return q.reshape(fh, fw, cw * WORD_NIBBLES, kout)[:, :, :cin]
