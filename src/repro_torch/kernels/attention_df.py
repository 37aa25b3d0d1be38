"""B2, B3 and B7: banded flash attention, paged decode attention and
KV-stationary attention, as CUDA kernels.

Ports of ``repro/kernels/attention_df.py``:

* ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``_flash_kernel``: output-stationary GQA attention with an online
  softmax, one CTA per (batch*head, q tile), visiting only the KV tiles
  inside the tile's band — the valid length (scalar, or one per batch
  row read from device memory, q rows right-aligned against it), the
  causal diagonal and the sliding window.  bf16 runs on the tensor cores
  (64-row q tiles, 64-key K/V tiles, ``mma.sync`` for QK^T and PV, P
  split exactly into three bf16 parts), f32 on the CUDA cores (16-row q
  tiles, 32-key tiles): ``FLASH_BLOCKS``.
* ``paged_flash_attention`` (``csrc/paged_attention.cu``) replaces
  ``_paged_kernel``: decode attention (Sq == 1) off a page pool through
  an ``(R, max_pages)`` block table, at any page size.  Each row's
  visited keys are cut into chunks (``paged_chunks``:
  ``PAGED_CHUNK_TILES`` tiles of ``paged_tile_keys(page)`` keys, counted
  from the window's first page, a function of the row's own kv_len,
  window and page size alone; a tile is 32 keys of the row's logical key
  range, each key mapped to its page and offset, so a page over 32 keys
  spans several tiles), one CTA per (chunk, kv head,
  row), its tiles streamed through a ``cp.async`` ring; the chunks'
  partial (m, l, acc) meet in a workspace the wrapper sizes from the
  shapes, merged in chunk order by the row's last CTA.  A CTA has a warp
  per q head of its group bound: 8 warps for a group of at most 8, 16
  for a group of 9 to ``MAX_GROUP`` (qwen3-moe-235b-a22b's 16), so each
  K/V key is read once per (chunk, kv head) at either.
* ``kv_stationary_attention`` (``csrc/kv_stationary.cu``) replaces
  ``_kv_stationary_kernel`` / ``_kv_single_kernel``: the WS anchor, the
  KV blocks walked outer and the q tiles inner, the same band and mask as
  B2.  bf16 runs on thread-block clusters and the tensor cores: a cluster
  of ``kv_stationary_plan(...).cluster`` CTAs per (batch row, kv head),
  each 64-key K and V block fetched once per cluster (once per kv head,
  for every q head of its group) by TMA copies multicast into every CTA,
  the cluster's units (q head of the group, 64-row q tile) dealt to its
  CTAs, each warp folding with B2's step (``csrc/flash_tc.cuh``), so
  every output equals B2's bit for bit; a CTA with one unit keeps its
  state in registers, one with several passes each unit's f32 state
  through device memory between KV blocks.  The launch reports its
  (cluster, CTAs, shared memory) and ``check_took`` holds it against the
  plan.  f32 keeps the CUDA cores: one CTA per (batch*head), each KV
  block fetched once per q head, the state through device memory once per
  visible (KV block, 16-row q tile) pair.  ``KV_BLOCKS``.

B2 also writes each q row's softmax statistic on request
(``flash_attention(..., return_lse=True)``: ``m + log(l)`` from its
online softmax's final state, f32, ``-inf`` for a row that sees no key),
on every path (bf16, f32, int8 K/V), in its epilogue alone; such a launch
also counts under ``FLASH_LSE``.  With it, a rank of a device mesh
attends over its own range of a cache split over the keys (its valid
length ``kv_len - k0``, which may lie outside ``[0, Skv]``: the band is
clipped to the buffer) and the ranks' partial outputs merge through
their statistics (``models/parallel.merge_key_ranges``).  B7 keeps no
statistics, so that path pins B2.

B2 and B7 also take int8 K/V with per-position f32 scales (the int8 KV
cache; the TPU kernels' ``_load_kv`` dequantizes at the block load).
Under bf16 queries the int8 tiles stream in at half the bytes (B2
through its ``cp.async`` ring, B7 multicast by the TMA), are converted
exactly to bf16 in shared memory, and fold with the same step, which
multiplies each score by its key's K scale and each probability by its
key's V scale (``ref.attention_ref``'s folded dequant), so B7's int8
output equals B2's bit for bit; such a launch also counts under
``FLASH_I8KV`` / ``KV_CLUSTER_I8KV``.  Under float32 queries the f32
CUDA-core kernels read the int8 tiles as exact floats and fold the
scales the same way, B7's f32 kernel with B2's f32 step, so again B7
equals B2 bit for bit; such a launch also counts under
``FLASH_F32_I8KV`` / ``KV_F32_I8KV``.  Every kernel is built for
``HEAD_DIMS``.

Each wrapper launches its kernel for CUDA tensors and raises for what it
does not take; for CPU tensors it computes the kernel's plain version
(``ref.attention_ref`` / ``ref.paged_attention_ref``; B7's is
``attention_ref`` too).  The kernels mask the ragged q and KV edges
themselves, so nothing is padded.  B3's pools stay float, as the JAX
package's do.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.dataflow import (DataflowSpec, KernelRegistration, OS,
                                       WS, register_kernel)
from repro_torch.kernels import _build, matmul_df, ref

HEAD_DIMS = (16, 32, 64, 128)      # d_head values the kernels are built for
# (bq, bkv) of csrc/flash_attention.cu by dtype: the bf16 tensor-core tile
# (the serving path's) and the f32 CUDA-core one.
FLASH_BLOCKS = {torch.bfloat16: (64, 64), torch.float32: (16, 32)}
FLASH_BLOCK = FLASH_BLOCKS[torch.bfloat16]
# (bq, bkv) of csrc/kv_stationary.cu by dtype: the bf16 cluster kernel's
# (B2's tensor-core tile) and the f32 CUDA-core one.
KV_BLOCKS = {torch.bfloat16: (64, 64), torch.float32: (16, 32)}
KV_BLOCK = KV_BLOCKS[torch.bfloat16]
KV_STAGES = 2                      # csrc/kv_stationary.cu: KV blocks held
MAX_GROUP = 16                     # csrc/paged_attention.cu: q heads per kv head
PAGED_NARROW_GROUP = 8             # ... at most, on its 8-warp kernel
PAGED_TILE_KEYS = 32               # csrc/paged_attention.cu: keys a tile, at most
PAGED_CHUNK_TILES = 4              # csrc/paged_attention.cu: tiles a chunk

FLASH = register_kernel(KernelRegistration(
    name="flash_attention",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
    replaces="src/repro/kernels/attention_df.py:328",
    spec=DataflowSpec(anchor=OS, block=FLASH_BLOCK + (1,)),
))
KV_STATIONARY = register_kernel(KernelRegistration(
    name="kv_stationary",
    source="src/repro_torch/kernels/csrc/kv_stationary.cu",
    replaces="src/repro/kernels/attention_df.py:538",
    spec=DataflowSpec(anchor=WS, block=KV_BLOCK + (1,)),
))
KV_CLUSTER = register_kernel(KernelRegistration(
    name="kv_stationary_cluster",
    source="src/repro_torch/kernels/csrc/kv_stationary.cu",
    replaces="src/repro/kernels/attention_df.py:538",
    spec=DataflowSpec(anchor=WS, block=KV_BLOCK + (1,)),
))
FLASH_I8KV = register_kernel(KernelRegistration(
    name="flash_attention_i8kv",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
    replaces="src/repro/kernels/attention_df.py:328",
    spec=DataflowSpec(anchor=OS, block=FLASH_BLOCK + (1,)),
))
KV_CLUSTER_I8KV = register_kernel(KernelRegistration(
    name="kv_stationary_cluster_i8kv",
    source="src/repro_torch/kernels/csrc/kv_stationary.cu",
    replaces="src/repro/kernels/attention_df.py:538",
    spec=DataflowSpec(anchor=WS, block=KV_BLOCK + (1,)),
))
FLASH_LSE = register_kernel(KernelRegistration(
    name=_build.FLASH_LSE,
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
    replaces="src/repro/kernels/attention_df.py:328",
    spec=DataflowSpec(anchor=OS, block=FLASH_BLOCK + (1,)),
))
FLASH_F32_I8KV = register_kernel(KernelRegistration(
    name="flash_attention_f32_i8kv",
    source="src/repro_torch/kernels/csrc/flash_attention.cu",
    replaces="src/repro/kernels/attention_df.py:328",
    spec=DataflowSpec(anchor=OS, block=FLASH_BLOCKS[torch.float32] + (1,)),
))
KV_F32_I8KV = register_kernel(KernelRegistration(
    name="kv_stationary_f32_i8kv",
    source="src/repro_torch/kernels/csrc/kv_stationary.cu",
    replaces="src/repro/kernels/attention_df.py:538",
    spec=DataflowSpec(anchor=WS, block=KV_BLOCKS[torch.float32] + (1,)),
))
PAGED = register_kernel(KernelRegistration(
    name="paged_attention",
    source="src/repro_torch/kernels/csrc/paged_attention.cu",
    replaces="src/repro/kernels/attention_df.py:714",
    spec=DataflowSpec(anchor=OS, block=(1, PAGED_TILE_KEYS, 1)),
))
PAGED_G16 = register_kernel(KernelRegistration(
    name=_build.PAGED_G16,
    source="src/repro_torch/kernels/csrc/paged_attention.cu",
    replaces="src/repro/kernels/attention_df.py:714",
    spec=DataflowSpec(anchor=OS, block=(1, PAGED_TILE_KEYS, 1)),
))


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernels take d_head in {HEAD_DIMS}, "
                         f"got {d}")


def _kv_scales(q, k, v, k_scale, v_scale):
    """The K/V scales a banded kernel takes: None for float K/V, else
    both (B, Hkv, Skv, 1) scales as contiguous f32.  K/V are either of
    q's float dtype, or both int8 with both scales."""
    int8 = k.dtype == torch.int8 or v.dtype == torch.int8
    if not int8:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError("q, k and v must share one float dtype, or K/V "
                            "be int8 with per-position scales")
        if k_scale is not None or v_scale is not None:
            raise TypeError("k_scale/v_scale go with int8 K/V only")
        return None
    if k.dtype != v.dtype or k_scale is None or v_scale is None:
        raise TypeError("int8 K/V need both K and V int8 and both "
                        "per-position k_scale/v_scale")
    want = tuple(k.shape[:-1]) + (1,)
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(f"int8 K/V scales must be per-position with a "
                         f"trailing singleton lane: expected {want}, got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    return (k_scale.to(torch.float32).contiguous(),
            v_scale.to(torch.float32).contiguous())


def _i8kv_count(q, scales, bf16_path, f32_path) -> Optional[str]:
    """The count a launch over int8 K/V also adds one to: its bf16- or
    float32-query path's; None over float K/V."""
    if scales is None:
        return None
    return (bf16_path if q.dtype == torch.bfloat16 else f32_path).name


def _banded_args(q, k, v, window, kv_len, k_scale=None, v_scale=None):
    """Checks shared by the banded kernels (B2, B7); returns the per-row
    lengths on the device (or None), the shared length, the heads per
    batch row and the K/V scales (``_kv_scales``).  A length may be any
    int, below 0 or above ``Skv`` too (``ref.visible_keys``): the
    kernels clip the band to the buffer."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check_head_dim(d)
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    scales = _kv_scales(q, k, v, k_scale, v_scale)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if torch.is_tensor(kv_len) and kv_len.ndim == 1:
        if kv_len.shape[0] != b:
            raise ValueError(f"per-row kv_len needs one entry per batch row "
                             f"({b}), got shape {tuple(kv_len.shape)}")
        return (kv_len.to(device=q.device, dtype=torch.int32).contiguous(),
                skv, hq, scales)
    return None, (skv if kv_len is None else int(kv_len)), 0, scales


def flash_attention(
    q: torch.Tensor,                 # (B, Hq, Sq, D)
    k: torch.Tensor,                 # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kv_len: ref.KvLen = None,        # int, 0-d or (B,) int tensor
    k_scale: Optional[torch.Tensor] = None,   # int8 K/V: (B, Hkv, Skv, 1)
    v_scale: Optional[torch.Tensor] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Banded GQA attention in one kernel launch.  Returns (B, Hq, Sq, D);
    with ``return_lse``, also each row's statistic, f32 (B, Hq, Sq)
    (``ref.attention_ref``'s)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_len=kv_len, k_scale=k_scale,
                                 v_scale=v_scale, return_lse=return_lse)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kv_lens, kv_scalar, heads_per_row, scales = _banded_args(
        q, k, v, window, kv_len, k_scale, v_scale)
    ks, vs = scales or (None, None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.refuse_grad("flash_attention", q, k, v)
    _build.require_cuda(q, k, v, kv_lens, ks, vs)
    _build.require_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    also = tuple(n for n in (_i8kv_count(q, scales, FLASH_I8KV,
                                         FLASH_F32_I8KV),
                             FLASH_LSE.name if return_lse else None) if n)
    _build.launch(
        "flash_attention", _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(ks), _build.ptr(vs), _build.ptr(out), _build.ptr(lse),
        _build.dtype_code(q), _build.dtype_code(k), d, b * hq, sq, skv,
        hq // hkv, heads_per_row, _build.ptr(kv_lens), kv_scalar,
        0 if window is None else int(window), int(causal),
        float(scale if scale is not None else d ** -0.5), also=also)
    return (out, lse) if return_lse else out


class KvPlan(NamedTuple):
    """How B7's bf16 cluster kernel runs at one shape."""

    cluster: int        # CTAs of a cluster, one cluster per (batch row, kv head)
    ctas: int
    smem_bytes: int     # dynamic shared memory of a CTA


def kv_stationary_plan(b: int, hq: int, hkv: int, sq: int, skv: int,
                       dtype: torch.dtype = torch.bfloat16,
                       d: int = 128, kv_int8: bool = False
                       ) -> Optional[KvPlan]:
    """The cluster, CTAs and shared memory of B7's bf16 cluster kernel
    (``csrc/kv_stationary.cu``, which is the source: every launch reports
    them and ``check_took`` holds the report against this copy); None for
    float32, which keeps one CTA per (batch*head).  The cluster size is
    ``matmul_df.cluster_size``'s rule over the clusters' units (one CTA
    for a single unit); CTA r takes units r, r + C, ....  ``skv`` does not
    change the plan: the shared memory is the ring of ``KV_STAGES`` K and
    V blocks of 64 keys (``kv_int8``: of int8 codes, then the block
    converted to bf16 and its 64 K and 64 V scales)."""
    if dtype != torch.bfloat16:
        return None
    _check_head_dim(d)
    bq, bkv = KV_BLOCKS[dtype]
    clusters, units = b * hkv, -(-sq // bq) * (hq // hkv)
    c = 1 if units < 2 else matmul_df.cluster_size(clusters, units)
    block = 2 * bkv * d * 2                # a K and a V block in bf16
    ring = KV_STAGES * (block // 2 if kv_int8 else block)
    work = block + 2 * bkv * 4 if kv_int8 else 0
    smem = ring + work + -(-16 * KV_STAGES // 128) * 128
    return KvPlan(cluster=c, ctas=clusters * c, smem_bytes=smem)


def kv_band(q0: int, sq: int, skv: int, kv_valid: int, causal: bool,
            window: Optional[int], bq: int = 64,
            bkv: int = 64) -> Tuple[int, int]:
    """The KV blocks [lo, hi] the q tile at row q0 sees (``csrc/flash_tc.cuh``
    ``fa::band``, B2's rule; ``repro/kernels/attention_df.py``
    ``_band_lo_hi``); lo > hi: none."""
    off = kv_valid - sq
    hi = min(-(-kv_valid // bkv), -(-skv // bkv)) - 1
    if causal:
        qmax = min(q0 + bq, sq) - 1 + off
        hi = min(hi, qmax // bkv if qmax >= 0 else -1)
    lo = max(0, (q0 + off - window + 1) // bkv) if window else 0
    return lo, hi


def kv_schedule(sq: int, skv: int, kv_valid: int, group: int, causal: bool,
                window: Optional[int], cluster: int, rank: int):
    """What CTA ``rank`` of a B7 cluster does, in order (the bf16 cluster
    kernel's walk): ``("fold", block, unit)`` for each KV block the
    cluster walks (the lowest band's first to the highest band's last,
    every CTA waiting on each) and each of its units r, r + C, ... whose
    band holds the block, then ``("zeros", unit)`` for each of its units
    whose band is empty.  Unit u is (q tile u // group, q head u %
    group)."""
    gq = -(-sq // KV_BLOCK[0])
    mine = list(matmul_df.cluster_tiles(gq * group, cluster, rank))
    bands = {u: kv_band(u // group * KV_BLOCK[0], sq, skv, kv_valid, causal,
                        window) for u in range(gq * group)}
    seen = [b for b in bands.values() if b[0] <= b[1]]
    blocks = range(min(lo for lo, _ in seen),
                   max(hi for _, hi in seen) + 1) if seen else range(0)
    steps = [("fold", blk, u) for blk in blocks for u in mine
             if bands[u][0] <= blk <= bands[u][1]]
    return steps + [("zeros", u) for u in mine if bands[u][0] > bands[u][1]]


def check_took(plan: Optional[KvPlan], took: Optional[tuple]) -> None:
    """Raise unless B7's launch report (``_build.launch``: tile, shared
    memory bytes, CTAs, cluster) is the one ``plan`` gives; a float32
    launch reports none."""
    want = None if plan is None else (KV_CLUSTER.name, plan.smem_bytes,
                                      plan.ctas, plan.cluster)
    if took != want:
        raise _build.KernelError(
            f"kv_stationary took {took} (name, shared memory bytes, CTAs, "
            f"cluster) where its plan says {want}")


def kv_stationary_attention(
    q: torch.Tensor,                 # (B, Hq, Sq, D)
    k: torch.Tensor,                 # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kv_len: ref.KvLen = None,        # int, 0-d or (B,) int tensor
    k_scale: Optional[torch.Tensor] = None,   # int8 K/V: (B, Hkv, Skv, 1)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KV-stationary (WS) GQA attention in one kernel launch: each KV
    block fetched once per kv head (bf16 and int8; float32: once per q
    head), the (acc, m, l) state through device memory between KV blocks
    (except a bf16 CTA holding one q tile, which keeps it in registers).
    Returns (B, Hq, Sq, D)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_len=kv_len, k_scale=k_scale,
                                 v_scale=v_scale)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kv_lens, kv_scalar, heads_per_row, scales = _banded_args(
        q, k, v, window, kv_len, k_scale, v_scale)
    ks, vs = scales or (None, None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.refuse_grad("kv_stationary", q, k, v)
    _build.require_cuda(q, k, v, kv_lens, ks, vs)
    _build.require_aligned(q, k, v)
    plan = kv_stationary_plan(b, hq, hkv, sq, skv, q.dtype, d,
                              kv_int8=scales is not None)
    out = torch.empty_like(q)
    acc = torch.empty((b * hq, sq, d), dtype=torch.float32, device=q.device)
    ml = torch.empty((b * hq, sq, 2), dtype=torch.float32, device=q.device)
    took = _build.launch(
        "kv_stationary", _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(ks), _build.ptr(vs), _build.ptr(out), _build.ptr(acc),
        _build.ptr(ml), _build.dtype_code(q), _build.dtype_code(k), d,
        b * hq, sq, skv, hq // hkv, heads_per_row, _build.ptr(kv_lens),
        kv_scalar, 0 if window is None else int(window), int(causal),
        float(scale if scale is not None else d ** -0.5),
        also=_i8kv_count(q, scales, KV_CLUSTER_I8KV, KV_F32_I8KV))
    check_took(plan, took)
    return out


def paged_tile_keys(page: int) -> int:
    """Keys of one of B3's tiles: whole pages where a page holds fewer
    than 32 keys (as many as fit: 32 at a page of 16, 30 at a page of 5),
    else a 32-key slice of the row's key range."""
    if page >= PAGED_TILE_KEYS:
        return PAGED_TILE_KEYS
    return PAGED_TILE_KEYS // page * page


def paged_chunk_keys(page: int) -> int:
    """Keys of one of B3's chunks: ``PAGED_CHUNK_TILES`` tiles."""
    return PAGED_CHUNK_TILES * paged_tile_keys(page)


def paged_max_chunks(page: int, max_pages: int) -> int:
    """Chunks of the longest row a (R, max_pages) table can hold: the
    kernel's grid and the workspace's depth."""
    return -(-max_pages * page // paged_chunk_keys(page))


def paged_chunks(kv_len: int, page: int, max_pages: int,
                 window: Optional[int] = None):
    """The key ranges [first, end) of each of B3's chunks of one row.
    The row visits logical pages lo..hi (``repro/kernels/attention_df.py
    :602-608``, hi also capped by the table); its keys run from the
    32-key slice of page lo holding the window's first key (page lo's
    first key, at a page of 32 keys or fewer) to its last valid key the
    table holds, cut into runs of ``paged_chunk_keys(page)``.  A function
    of the row alone; a row of kv_len 0 has none.  At a page of 32 keys or
    fewer each chunk starts on a page boundary and covers whole pages."""
    hi = min(-(-kv_len // page), max_pages) - 1
    if hi < 0:
        return []
    lo = 0 if not window else min(max(0, (kv_len - window) // page), hi)
    k_end = min(kv_len, (hi + 1) * page)
    k_lo = lo * page
    if window:
        k_lo += max(0, kv_len - window - k_lo) // PAGED_TILE_KEYS \
            * PAGED_TILE_KEYS
    ck = paged_chunk_keys(page)
    return [(c, min(k_end, c + ck)) for c in range(k_lo, k_end, ck)]


# The zeroed arrival counters of B3's chunks, one per (row, kv head), by
# (device, stream): each launch leaves them zero again (the last CTA of a
# row wraps the row's counter to zero as it arrives), so they are zeroed
# once, when first needed or grown. Launches that share a buffer run in
# order on its stream; a launch on another stream gets a buffer of its own.
_PAGED_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _paged_counters(device: torch.device, stream: int,
                    count: int) -> torch.Tensor:
    held = _PAGED_COUNTERS.get((device, stream))
    if held is None or held.numel() < count:
        held = torch.zeros(max(count, 64), dtype=torch.int32, device=device)
        _PAGED_COUNTERS[(device, stream)] = held
    return held


def paged_flash_attention(
    q: torch.Tensor,                 # (B, Hq, 1, D)
    k_pages: torch.Tensor,           # (Hkv, P, page, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,      # (B, max_pages) int32 page ids
    kv_lens: torch.Tensor,           # (B,) int32 valid lengths
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention off a page pool in one kernel launch.
    Returns (B, Hq, 1, D)."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       kv_lens, scale=scale, window=window)
    b, hq, sq, d = q.shape
    hkv, n_pages, page, _ = k_pages.shape
    _check_head_dim(d)
    if sq != 1:
        raise ValueError(f"paged attention is decode-only (Sq == 1), "
                         f"got {sq}")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d or hq % hkv:
        raise ValueError(f"bad paged shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"paged kernel takes at most {MAX_GROUP} q heads "
                         f"per kv head")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or tuple(kv_lens.shape) != (b,):
        raise ValueError(f"need a (B, max_pages) table and (B,) kv_lens for "
                         f"B={b}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the page pools must share one float dtype")
    tables = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    q = q.contiguous()
    _build.refuse_grad("paged_attention", q, k_pages, v_pages)
    _build.require_cuda(q, k_pages, v_pages, tables, lens)
    _build.require_aligned(q, k_pages, v_pages)
    out = torch.empty_like(q)
    max_pages = tables.shape[1]
    chunks = paged_max_chunks(page, max_pages)
    ws_acc = torch.empty((b * hq, chunks, d), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b * hq, chunks, 2), dtype=torch.float32,
                        device=q.device)
    counters = _paged_counters(
        q.device, torch.cuda.current_stream(q.device).cuda_stream, b * hkv)
    _build.launch(
        "paged_attention", _build.ptr(q), _build.ptr(k_pages),
        _build.ptr(v_pages), _build.ptr(tables), _build.ptr(lens),
        _build.ptr(out), _build.ptr(ws_acc), _build.ptr(ws_ml),
        _build.ptr(counters), _build.dtype_code(q), d, b, hq, hkv, n_pages,
        page, max_pages, chunks,
        float(scale if scale is not None else d ** -0.5),
        0 if window is None else int(window),
        also=PAGED_G16.name if hq // hkv > PAGED_NARROW_GROUP else None)
    return out
