#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase, as the gate runs it
    python3 chip_smoke.py --phases card,build,kernels   # a quicker kernel check
    python3 chip_smoke.py --phases card,build,autotune  # the explorer's picks against the card
    python3 chip_smoke.py --phases card,build,kernels,dataflows
    python3 chip_smoke.py --phases card,build,kernels,quantized
    python3 chip_smoke.py --phases card,build,serve_packed --layers 2
    python3 chip_smoke.py --phases card,build,serve_recovery
    python3 chip_smoke.py --phases card,build,kernels,serve_int8kv
    python3 chip_smoke.py --phases card,build,serve_dense,serve_f32
    python3 chip_smoke.py --phases card,build,serve_moe
    python3 chip_smoke.py --phases card,build,serve_ssm
    python3 chip_smoke.py --phases card,build,serve_audio
    python3 chip_smoke.py --phases card,build,train

Phases, each printing JSON lines:

1. ``card``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: every kernel built from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), with its time; then
   ``cuobjdump -sass`` shows that every bf16 GEMM and flash kernel issues
   tensor-core instructions (HMMA) and no float32 or int8 one does, that
   B1's int8 tile kernels and B8's int8 and packed kernels issue integer
   ones (IMMA) and no other kernel does (B8's bf16 kernels issue HMMA,
   its f32 walk neither), that B9's binary tile kernels issue binary ones
   (``BMMA.168256.AND.POPC``) and no other kernel does, and that the
   cluster walks of B1's residencies, B4, B5a and B5b
   (``csrc/gemm_cluster.cuh``) and B7's bf16 cluster kernel
   (``csrc/kv_stationary.cu``) are in their libraries and issue HMMA.
3. ``kernels``: each kernel held against its plain PyTorch version on the
   card, at the full-width qwen3-1.7b shapes of the serving path, in bf16,
   with the tolerance stated per kernel; then each timed by CUDA events
   beside its plain version, the one PyTorch library call that computes
   the same function (where there is one; timed for the record, never on
   the port's path) and its bound on an H100: B1's bf16 prefill tile
   (M > 16) and decode tile (M <= 16) at qwen3-1.7b's MLP shapes, B1 and
   B2 on float32 (the CUDA cores) apart from bf16, and how B1's bf16 sums
   round against cuBLAS (``bench/rounding.py``, not gated).  The GEMM
   dataflows (B1's
   residencies, B4, B5a, B5b) run each of the nine canonical specs at
   qwen3-1.7b's MLP shapes, the paper's layer grid and small odd shapes: each
   runs through the kernel ``matmul_df.plan`` names (a bf16 walk over a
   sweep of two tiles or more on its thread-block cluster walk, counted
   under its cluster key, with the cluster size it reported), matches the
   plain version and equals B1's output bit for bit, or raises
   ``ValueError`` naming the shared memory it needs; B4's WS and IS walks
   and B1's weight-stripe residency are timed at the paper's layer
   (56,3,1,128), B5a at qwen3-1.7b's down projection, B5b (on its cluster
   walk) at the paper's layer.  B7 is held against the plain version with
   B2's tolerances and, at bf16 on its cluster kernel, against B2 bit for
   bit (a gate), and timed at prefill 512 and 2048 beside B2.  B3 (split
   across CTAs) at the served
   decode shape and at a long row (4 x 4096 keys), with and without a
   window, timed at both; the same two shapes at pages of 48, 64 and 128
   keys (a tile is a 32-key slice of a row's key range, so a page spans
   several); at a GQA group of 16 (Hq 64, Hkv 4: its 16-warp
   kernel, counted under ``paged_attention_g16``) at the served decode
   shape, timed with its byte bound.  B1 and B2 at whisper-tiny's widths
   (the encoder's MLP at M = 4 x 1 500, the decoder's prefills and decode,
   6 heads of 64), beside ``torch.matmul`` and SDPA.  B2 over the int8 KV cache's K/V (int8 codes
   with per-position f32 scales, bf16 queries) at a prefill chunk and at
   slot-cache decode, held against the plain version and timed beside it
   and bf16 B2; B7 over int8 K/V at prefill 512, equal to B2's int8
   output bit for bit (a gate) and timed.  Under float32 queries over int8
   K/V, K1 (B2's f32 kernel) at the chunk and slot-cache decode at full
   width and at d_head 16/32/64 over every mask of B2's card tests, and
   K2 (B7's f32 kernel) equal to K1 bit for bit (a gate) at prefill 512
   and over the same cases; each timed beside its plain version and f32
   B2/B7 over the float K/V.  At d_head 16, B2 (bf16, f32), B7 (bf16 on
   its cluster kernel, equal to B2 bit for bit; f32) and B3 (bf16, f32)
   held against their plain versions and timed at qwen3-1.7b's heads,
   beside SDPA.  B9 is held bit for bit at every anchor
   and epilogue stage at the served binary-MLP shapes, its basic OS on
   the binary tensor-core tiles (prefill for M > 16, decode for
   M <= 16), each timed at both projections; B8 at int8 bit for
   bit, and at f32/bf16 within B1's tolerance, on the ResNet-18 layers,
   every anchor equal to OS; each infeasible anchor raises naming its
   bytes; every int8, packed and bf16 launch takes the tensor-core tile
   ``conv2d_df.plan`` names (the kernel reports it: tile, shared memory,
   CTAs, split of k); int8 OS, WS and IS, packed 4-bit OS, bf16 OS, WS
   (and IS at the next layer) and f32 OS timed at ResNet-18's
   (56,3,1,64->64), bf16 and f32 beside cuDNN (no TF32).  int8
   operands in the GEMM family and packed int4/int5 weights (B6 decoding
   them inside B1/B4/B5 and B8) are held bit for bit at
   qwen3-1.7b's MLP shapes under each of the nine specs (int32 out, the
   fused dequant) and on the ResNet-18 conv body under each anchor; B1's
   int8 and packed basic launch runs on its integer tensor-core tiles
   (prefill for M > 16, decode for M <= 16), timed at M = 512 and 4.
   Every launch of B1's basic OS reports the tile it took, its shared
   memory and CTAs, and raises unless ``matmul_df.plan`` planned the same.
4. ``autotune``: the explorer (``core.explorer``) against the card.  For
   each distinct workload the serve phases hand the autotuner (qwen3-1.7b
   at full width: the MLP GEMMs at bf16, packed 4-bit and binary for the
   serve prompts and at decode batch 4, the prefill, chunk and slot-decode
   attention over bf16 and int8 K/V), the paper's 12-layer grid, Fig.
   2/7's qwen3-1.7b GEMMs, the quantized phase's convs and serve_f32's
   smoke problems: every feasible candidate with its analytical estimate,
   run through its public op, held bit for bit against basic OS (B2 for
   attention; a gate) and timed (CUDA events after an L2 flush, median of
   15); on every serve hot problem and serve_f32 problem the autotuner
   must serve the explorer's fresh pick (the store is this run's own,
   under a temporary directory) and the pick's time must be within
   ``PICK_RATIO`` (1.15x) of the fastest candidate's (gates); the paper
   group's agreement is reported, and that of a group held out of the
   cost model's fit (qwen3-1.7b at a 1 024-token prompt and decode batch
   16).  Every serve phase then measures, the
   same way, each problem it looked up that this phase did not (group
   ``served``; serve_dense's, the other decoders' widths, ``held-out``),
   and reports their agreement.
5. ``dataflows``: the bench twins (``repro_torch.bench``): Fig. 2 (basic
   OS/WS/IS), Fig. 7 (auxiliary residencies) on the paper's layer grid
   and qwen3-1.7b's MLP GEMMs, and attention's OS vs WS anchor at prefill
   512 and 2048; every row printed, every dataflow kernel launched.
6. ``quantized``: the bench twins of the paper's quantized datapaths
   (``repro_torch.bench.conv``, ``repro_torch.bench.binary``): fused
   against unfused conv epilogue per anchor, the ResNet-18 conv body at
   int8 per anchor, Fig. 9 (binary against int8 and bf16 conv on the
   VGG layers) and the packed-weight rows (``repro_torch.bench.packed``:
   B1 on packed 4- and 5-bit, int8 and bf16 weights at qwen3-1.7b's MLP
   shapes); every row printed, B8 (its int8 and bf16 tiles and walks),
   B9, B1 and B6 launched, and each kernel the autotuner's picks of the
   ``spec=None`` calls imply (Fig. 9's convs, the packed rows' B1)
   launched at least that often.
7. ``serve``: full-width qwen3-1.7b (random bf16 weights from a seed, depth
   cut to ``--layers``) served through ``Engine.submit``/``drain``:
   every request DONE, no demotion, every kernel launched, every
   kernel's launches equal to what the autotuner's picks of the ops'
   ``spec=None`` calls imply and each pick the explorer's fresh first
   (``_picks_gate``; every serve phase),
   mixed-length
   batch tokens == each request served alone; prefill tokens/s and decode
   ms/step; then ``torch.profiler`` traces of the 511-token prefill and
   of 6 decode steps at batch 4: device busy ms, idle share, kernel ms by
   name, per prefill and per step; and one prefill under ``cProfile``,
   its functions with the most own host time.
8. ``serve_binary``: the same, for qwen3-1.7b with its binary MLP
   (``binary_mlp=True``: +-1 weights bit-packed, the two projections
   through B9); besides, at every layer of a two-layer prefill the
   binary MLP on the kernels equals its plain version bit for bit.
9. ``serve_packed``: the same, for qwen3-1.7b with packed 4-bit MLP
   weights (``packed_weights=True``: the three projections through B1
   with B6 decoding the planes); at every layer of a two-layer prefill
   ``up`` and ``down`` on the kernels equal their plain versions bit for
   bit on the same int8 inputs and ``gate`` (silu fused) holds B1's
   tolerance.  Its activations are quantized per tensor over the batch,
   so the mixed-batch tokens are compared with each request alone and
   the differing tokens counted, not gated.
10. ``serve_recovery``: full-width qwen3-1.7b (depth ``--layers``) through
   ``Engine`` in the modes the serving loop adds, every gate raising:
   chunked prefill (``prefill_chunk=128``; prompts of 17/64/200/511
   tokens, 16 new) emits the whole prompts' tokens, with the first
   token's logit difference and both prefills' ms (7 repeats each, run
   outside ``Engine`` after the path's counts are read) reported; the
   pressure ladder (prompts of 100/120/60/140 tokens, 64 new, reaches of
   44 pages in a pool of 24) spills or preempts, fails nothing, diverges
   nowhere and emits the tokens of an unconstrained pool; the
   batch-synchronous ``serve()`` on the slot cache (four 64-token
   prompts) ends DONE, its tokens that differ from the paged drain's
   counted (B2 at Sq = 1 and B3 fold in different orders) and both
   loops' decode ms/step reported;
   then two crash drills at 2 layers, each a process killed by
   ``REPRO_FAULT_PLAN`` and a process that restores and finishes (this
   script with ``--drill``): (a) a ragged continuous drain killed in its
   decode loop (a cold replay), (b) the batch loop with snapshots every 2
   steps killed after one (a warm resume); both must recover every
   journaled request with the uninterrupted run's tokens, none FAILED,
   no replay divergence.
11. ``serve_int8kv``: full-width qwen3-1.7b (depth ``--layers``) with
   ``kv_cache_dtype="int8"`` through ``Engine``'s continuous scheduler
   (prompts of 17/64/200/511 tokens, 16 new): every request DONE, 0
   demotions, mixed batch == each request alone, no page pool and no B3
   launch, B2's int8 launches exactly one a layer for every decode step
   and prefill chunk, the int8 cache under 0.6x a bf16 cache's bytes, a
   ``prefill_chunk=128`` run DONE (its tokens that differ from the whole
   prompts' counted), the first decode logits within 0.05 (relative to
   the largest) of the bf16 cache's at 2 layers (the full depth's
   reported), and the decode step traced.
12. ``serve_dense``: the other dense decoders at full width, bf16, random
   weights from ``--seed``, through ``Engine`` on the paged path with the
   serve cell's prompts: minicpm-2b at full depth (40 layers), then
   mistral-nemo-12b, minitron-8b and chameleon-34b at 4 layers each (the
   cut printed).  Gates per config: B1's tile at the down projection
   within B1's tolerance; the first decode step's logits finite and at
   cosine >= 0.999 of the plain path's at 2 layers; every request DONE;
   no token >= ``vocab_size``; every B1 launch on its tiles; B2 launches
   = layers x prompts, B3 = layers x decode steps.  Weights' bytes and
   decode ms/step printed; minicpm-2b's decode step traced.
13. ``serve_f32``: the five dense smoke configs in float32 (minicpm-2b's at
   d_head 16), each from the float cache (B2 and B3 f32) and from an int8
   KV cache (K1: B2's f32 kernel over int8 K/V at every decode step and
   chunk), whole prompts and with ``prefill_chunk=32``: the first decode
   logits within B2's f32 tolerance of the plain path, every request
   DONE, the launch counts exact; differing tokens counted, not gated.
14. ``serve_moe``: the MoE decoders at full width, bf16, random weights
   from ``--seed``, through ``Engine`` on the paged path with the serve
   cell's prompts: moonshot-v1-16b-a3b at full depth (48 layers; 64
   experts top-6, 2 shared experts through B1's tiles), then
   qwen3-moe-235b-a22b at 4 layers (128 experts top-8, B3 at its group
   of 16; the cut printed).  Printed: weights' bytes, capacities, the
   assignments each prefill and decode step dropped, decode ms/step.
   Gates per config: the router's float32 logits within 1e-5 of float64;
   the first decode step's logits finite and at cosine >= 0.999 of the
   plain path's at 2 layers, each layer's top-k printed on both paths and
   a first flip at a margin over 1e-3 failing (after a flip the cosine is
   reported, not gated); every request DONE, 0 demotions; no decode
   token >= ``vocab_size`` (first tokens past it, from the prefill's
   unmasked logits as in the reference, counted); every B1 launch on its
   tiles; B2 = layers x prompts,
   B3 = layers x decode steps (qwen3-moe's all on the 16-warp kernel);
   the mixed batch == each request alone wherever no decode step
   dropped.  moonshot's decode step traced, the expert GEMMs' device time
   beside the port's kernels.
15. ``serve_ssm``: the SSM and hybrid decoders whole, full width, bf16,
   random weights from ``--seed``, through ``Engine`` off the slot cache
   (each row's SSM state beside its K/V), decode batch 4, ``max_len``
   2 048: mamba2-780m (48 attention-free layers; no kernel of the port)
   and hymba-1.5b (32 layers, B1's tiles at its MLP, B2 at group 5 with a
   1 024-key window on 29 layers), the serve cell's prompts plus one of
   1 536 tokens for hymba.  Gates per config: the first decode logits at
   2 layers at cosine >= 0.999 of the plain path's; at 2 layers the
   chunked SSD prefill's layer-0 state within ``SSD_STATE_RTOL`` of the
   per-token recurrence's, its logits at cosine >= 0.999; every request
   DONE, 0 demotions; every B1 launch on its tiles; the attention calls
   of the full and the windowed layers each layers x (prompts + decode
   steps), B2/B7 as the picks imply, no B3; mixed batch == alone.
   Counted: a ``prefill_chunk=128`` run's tokens that differ.  Printed:
   weights' and state bytes, prefill tokens/s, decode ms/step, the decode
   step traced with the Mamba2 blocks' device time.  The kernels phase
   holds B2 and B1 at hymba's widths (``hymba_checks``); ``serve_f32``
   serves mamba2-smoke and hymba-smoke.
16. ``serve_audio``: whisper-tiny whole (4 encoder and 4 decoder layers,
   bf16, random weights from ``--seed``) through its entry points,
   ``lm.prefill(..., enc_frames=)`` and ``lm.decode_step`` (the engine
   passes no frames, as the JAX engine passes none): 4 rows of 64 tokens
   over 1 500 encoder frames a row and 16 greedy steps, then one row of
   432 tokens and 16 steps to ``max_len`` 448.  Gates: the first decode
   logits at cosine >= 0.999 of the plain path's at 2 + 2 layers (4 + 4
   reported); ``lm.forward``'s last-position logits at cosine >= 0.999
   of ``prefill`` + ``decode_step``'s; the launches equal to the picks'
   and every B1 launch on its tiles; no decode token past
   ``vocab_size``.  Reported: the cross cache's bytes, the encoder's ms,
   prefill ms and decode ms/step, the decode step traced.  ``serve_f32``
   adds whisper-smoke from a float and an int8 KV cache; ``serve`` adds an
   engine at pages of 128 keys (4 layers: DONE, mixed == alone, tokens
   against page 16's counted); ``autotune`` times whisper's two frontend
   convs.
17. ``train``: training on the card (``train_phase``): qwen3-1.7b's loss
   and every gradient on the kernels against the plain path at 2 layers
   of full width (gated) and 28 (reported); one step of each of the ten
   smoke configs in float32 against the plain path, B1 and B2 counted in
   forward and backward; qwen3-1.7b whole (28 layers, bf16, batch 4 x
   512) trained 8 steps under remat none, dots and full (losses falling,
   step ms, tokens/s, peak memory, B1's launches split into forward,
   backward and recompute); a traced step; a crash and resume of the
   training driver, bit for bit; B1 timed at the backward's shapes.

The ``kernels`` record gives each kernel's launches on its path (serve:
B1 with its bf16 prefill and decode tiles, B2, B3; serve_binary: B9 with
its prefill and decode tiles, B2, B3; serve_packed: B6, B1 with its int8
prefill and decode tiles, B2, B3; serve_recovery: B1 with its bf16
prefill and decode tiles, B2 (at chunks and slot-cache decode too), B3,
counted over its in-process ``Engine`` runs; serve_int8kv: B1 with its
bf16 tiles, B2 and its int8 path; serve_dense: B1 with its bf16 tiles,
B2, B3, over its four configs; serve_f32: B1's f32 walk, B2, K1, B3;
serve_moe: B1 with its bf16 tiles, B2, B3 and its 16-warp kernel;
serve_ssm: B1 with its bf16 tiles, B2; serve_audio: B1 with its bf16
tiles, B2; train: B1 with its bf16 prefill tile (forward and backward),
B2 or B7 as picked, over 8 whole-model steps without remat;
B7's int8 paths (K2 among them), on no serving path, their launches in
the kernels phase; dataflows: B1 and its bf16 tiles, B2,
B4, B5a, B5b (B1's residencies, B4, B5a and B5b on their cluster walks),
B7 (on its cluster kernel);
quantized: B8 with its int8 and bf16 OS tiles and WS/IS walks, B9 and
its prefill tile, B1 and its int8 tiles, B6); on serve, serve_packed,
serve_int8kv, serve_dense and serve_moe every B1 launch, and on serve_binary every
B9 launch, is one of its tiles' (prefill plus decode),
counted from 0 just before the path runs; a serve path's kernels include
whichever its autotuned picks launch (B5a and B5b at some bf16 prefill
down projections). B2's and B7's attention launches are gated on their
sum and each on the picks. The
last lines are the ``{"kernels": [...]}``
record, the card line, and ``{"ok": true, "device": {...}}``. Any
failure raises, so the script exits non-zero and prints no ``ok`` line;
it also exits non-zero when no CUDA device is visible or the port's
sources are not beside it.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ALL_PHASES = ("card", "build", "kernels", "autotune", "dataflows",
              "quantized", "serve",
              "serve_binary", "serve_packed", "serve_recovery",
              "serve_int8kv", "serve_dense", "serve_f32", "serve_moe",
              "serve_ssm", "serve_audio", "train")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    from repro_torch.bench.common import card_line as line
    return line()


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def bf16_ulp(x):
    """One bf16 ulp of |x| (x = m 2^e, m in [0.5, 1): 2^(e - 8)); 0 at 0."""
    import torch

    x = x.float().abs()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x > 0, ulp, torch.zeros_like(x))


def check(name: str, got, want, atol: float, rtol: float, row_rtol: float,
          shape: str, plus_bf16_ulp: bool = False):
    """Element-wise |got - want| <= atol + rtol*|want| (plus one bf16 ulp
    of |want| with ``plus_bf16_ulp``, for a bf16 output: two correct
    roundings of f32 sums a few 1e-6 apart may land on neighbouring bf16
    values, and never further apart), and per output row (the last axis)
    ||got - want|| <= row_rtol*||want||: a row whose every element sits
    inside the element limit but is shifted as a whole (a skipped KV
    block, a page read from the wrong id) fails the row check.  A row
    whose reference is all zeros must be all zeros."""
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    bound = atol + rtol * want.float().abs()
    if plus_bf16_ulp:
        bound = bound + bf16_ulp(want)
    limit = float(bound.min())
    ok = bool((diff.abs() <= bound).all())
    d = diff.reshape(-1, diff.shape[-1]).norm(dim=-1)
    w = want.float().reshape(-1, diff.shape[-1]).norm(dim=-1)
    row_err = float((d / w.clamp_min(1e-30)).max())
    row_ok = bool((d <= row_rtol * w).all())
    emit({"check": name, "shape": shape, "max_abs_err": err,
          "max_row_rel_err": row_err, "atol": atol, "rtol": rtol,
          "row_rtol": row_rtol, "plus_bf16_ulp": plus_bf16_ulp,
          "ok": ok and row_ok})
    if not ok:
        raise AssertionError(f"{name} {shape}: max |err| {err} exceeds "
                             f"atol {atol} + rtol {rtol}*|ref|"
                             f"{' + 1 bf16 ulp' if plus_bf16_ulp else ''} "
                             f"(tightest {limit})")
    if not row_ok:
        raise AssertionError(f"{name} {shape}: a row's error norm is "
                             f"{row_err} of its reference's, over "
                             f"{row_rtol}")
    return err


# B1: f32 output of bf16 operands accumulated in f32 by both sides; only
# the order of the k sums differs (for int8 operands, only the activation:
# the kernel's silu and PyTorch's may round one ulp apart).
B1_TOL = dict(atol=1e-3, rtol=1e-3, row_rtol=1e-4)
# B2 (and B1, B3, B7) on float32: f32 math on both sides, only the order of
# the sums differs; also the first decode logits of a float32 model on the
# kernels against its plain path (serve_f32).
F32_TOL = dict(atol=1e-4, rtol=1e-4, row_rtol=1e-4)


# ---------------------------------------------------------------------------
# Phase 2: which kernels run on the tensor cores.
# ---------------------------------------------------------------------------
TC_LIBRARIES = ("matmul_os", "matmul_rmw", "matmul_ws_stripe",
                "matmul_is_stripe", "flash_attention", "kv_stationary",
                "binary_mm", "conv2d")


# The int8 tensor-core tiles of B1 (csrc/gemm_tc_i8.cuh), by __global__ name.
I8_TILE_FUNCTIONS = ("i8_prefill_kernel", "i8_decode_kernel")
# B8's tensor-core kernels (csrc/conv_tc.cuh): the OS tile and the WS and
# IS walks, each instantiated for bf16 (HMMA) and for int8 images with an
# int8 or packed filter (IMMA); the f32 walk (conv2d.cu conv_kernel)
# issues neither.
CONV_TC_FUNCTIONS = ("conv_os_kernel", "conv_ws_kernel", "conv_is_kernel")
# The binary tensor-core tiles of B9 (csrc/binary_mm.cu), and the SASS
# instruction of mma.sync m16n8k256 .b1 .and.popc as cuobjdump shows it
# for sm_90a (any other BMMA form is counted apart).
B1_TILE_FUNCTIONS = ("bin_prefill_kernel", "bin_decode_kernel")
B1_MMA_SASS = "BMMA.168256.AND.POPC"
# The bf16 cluster walks (csrc/gemm_cluster.cuh) and B7's bf16 cluster
# kernel (csrc/kv_stationary.cu) each library must hold: bf16 kernels, some
# of whose TMA twins take no bf16 pointer (their operands come through
# tensor maps), so they are named here.
CLUSTER_FUNCTIONS = {"matmul_os": ("walk_cluster_kernel", "walk_tma_kernel"),
                     "matmul_rmw": ("walk_cluster_kernel", "walk_tma_kernel"),
                     "matmul_ws_stripe": ("ws_stripe_cluster_kernel",),
                     "matmul_is_stripe": ("is_stripe_cluster_kernel",),
                     "kv_stationary": ("kv_cluster_kernel",)}


def tensor_core_check():
    """The SASS of the GEMM, flash, binary and conv libraries (``cuobjdump
    -sass``): every kernel that takes bf16 operands (``__nv_bfloat16`` in
    its mangled name) issues tensor-core instructions (HMMA), and no
    float32 or int8 kernel does (float32 stays on the CUDA cores, without
    TF32); every int8 tile kernel of B1 and every int8 (or packed) kernel
    of B8 issues integer tensor-core instructions (IMMA), and no other
    kernel does (B1's other integer walks stay on the CUDA cores); every
    binary tile kernel of B9 issues the binary
    tensor-core instruction (``B1_MMA_SASS``) and no other BMMA form, and
    no other kernel issues any BMMA (B9's WS and IS walks stay on the CUDA
    cores)."""
    import re
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        emit({"check": "tensor_core_sass", "ok": None,
              "why": f"{tool} not found"})
        return
    summary, wrong = {}, []
    for lib in TC_LIBRARIES:
        sass = subprocess.run(
            [str(tool), "-sass", str(_build.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=600).stdout
        hmma, imma, bmma, bmma_any, fn = {}, {}, {}, {}, None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = found.group(1)
                hmma[fn] = imma[fn] = bmma[fn] = bmma_any[fn] = 0
            elif fn is not None and "HMMA" in line:
                hmma[fn] += 1
            elif fn is not None and "IMMA" in line:
                imma[fn] += 1
            elif fn is not None and "BMMA" in line:
                bmma_any[fn] += 1
                bmma[fn] += B1_MMA_SASS in line
        bf16 = {f: c for f, c in hmma.items() if "__nv_bfloat16" in f
                or any(w in f for w in CLUSTER_FUNCTIONS.get(lib, ()))}
        other = {f: c for f, c in hmma.items() if f not in bf16}
        tiles = {f: c for f, c in imma.items()
                 if any(t in f for t in I8_TILE_FUNCTIONS)
                 or (any(t in f for t in CONV_TC_FUNCTIONS)
                     and "__nv_bfloat16" not in f)}
        wrong += [f for f, c in bf16.items() if c == 0]
        wrong += [f for f, c in other.items() if c > 0]
        wrong += [f for f, c in tiles.items() if c == 0]
        wrong += [f for f, c in imma.items() if c > 0 and f not in tiles]
        b1_tiles = {f: c for f, c in bmma.items()
                    if any(t in f for t in B1_TILE_FUNCTIONS)}
        wrong += [f for f, c in b1_tiles.items()
                  if c == 0 or c != bmma_any[f]]
        wrong += [f for f, c in bmma_any.items()
                  if c > 0 and f not in b1_tiles]
        summary[lib] = {
            "bf16_kernels": len(bf16),
            "bf16_with_hmma": sum(c > 0 for c in bf16.values()),
            "other_kernels": len(other),
            "other_with_hmma": sum(c > 0 for c in other.values()),
            "hmma_by_bf16_kernel": {f[:96]: c for f, c in sorted(bf16.items())},
            "int8_tile_kernels": len(tiles),
            "int8_tiles_with_imma": sum(c > 0 for c in tiles.values()),
            "other_with_imma": sum(c > 0 for f, c in imma.items()
                                   if f not in tiles),
            "imma_by_int8_tile": {f[:96]: c for f, c in sorted(tiles.items())},
            "binary_tile_kernels": len(b1_tiles),
            "binary_tiles_with_b1_mma": sum(c > 0 for c in b1_tiles.values()),
            "other_with_bmma": sum(c > 0 for f, c in bmma_any.items()
                                   if f not in b1_tiles),
            "b1_mma_by_binary_tile": {f[:96]: c
                                      for f, c in sorted(b1_tiles.items())},
        }
    if not summary["matmul_os"]["int8_tile_kernels"]:
        wrong.append("matmul_os: no int8 tile kernel found")
    for fn in CONV_TC_FUNCTIONS:  # each B8 kernel in both datapaths
        if not any(fn in f for f in summary["conv2d"]["imma_by_int8_tile"]):
            wrong.append(f"conv2d: no int8 {fn} found")
        if not any(fn in f for f in summary["conv2d"]["hmma_by_bf16_kernel"]):
            wrong.append(f"conv2d: no bf16 {fn} found")
    found = summary["binary_mm"]["b1_mma_by_binary_tile"]
    wrong += [f"binary_mm: no {t} found" for t in B1_TILE_FUNCTIONS
              if not any(t in f for f in found)]
    for lib, fns in CLUSTER_FUNCTIONS.items():
        for fn in fns:
            held = {f: c for f, c in
                    summary[lib]["hmma_by_bf16_kernel"].items() if fn in f}
            summary[lib].setdefault("hmma_by_cluster_walk", {}).update(held)
            if not held or not all(held.values()):
                wrong.append(f"{lib}: {fn} missing or without HMMA")
    emit({"check": "tensor_core_sass", "libraries": summary,
          "ok": not wrong})
    if wrong:
        raise AssertionError(f"kernels on the wrong cores (bf16 without "
                             f"HMMA, float32/int8 with it, an int8 tile or "
                             f"conv kernel without IMMA or another kernel "
                             f"with it, a "
                             f"binary tile without {B1_MMA_SASS} or "
                             f"another kernel with it): {wrong}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------
def kernel_phase(torch, cfg, timer):
    import torch.nn.functional as F

    from repro_torch.bench.common import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S,
                                          bound)
    from repro_torch.kernels import attention_df, matmul_df, ref

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, generator=gen):
        return (torch.randn(shape, generator=generator, device=dev)
                * std).to(bf16)

    # Operands of the timed shapes that no check before this slice drew
    # come from their own generator, so every check keeps its inputs.
    timed = torch.Generator(device=dev).manual_seed(1)
    records = {}
    d, dff = cfg.d_model, cfg.d_ff

    b1_tol = B1_TOL
    errs = []
    tile_errs = {"matmul_os_prefill": [], "matmul_os_decode": []}
    head = None
    for m in (1, 4, 137, 512):
        tile = ("matmul_os_decode" if m <= matmul_df.DECODE_M
                else "matmul_os_prefill")
        for k, n, act in ((d, dff, "silu"), (dff, d, None)):
            a = randn(m, k)
            w = randn(k, n, std=(2.0 / (k + n)) ** 0.5)
            res = torch.randn((m, n), generator=gen, device=dev)
            for residual in (None, res):
                got = matmul_df.matmul_os(a, w, activation=act,
                                          residual=residual)
                want = ref.matmul_fused_ref(a, w, activation=act,
                                            residual=residual)
                shape = (f"M={m} K={k} N={n} act={act} "
                         f"residual={residual is not None}")
                errs.append(check(tile, got, want, shape=shape, **b1_tol))
                tile_errs[tile].append(errs[-1])
            if m == 512 and act is None:
                head = (a, w, shape.replace(" residual=True", ""))
    # Odd widths take the kernel's element-wise loads, float32 inputs its
    # other instantiation; every epilogue stage at once.
    for dt, (m, k, n) in ((bf16, (37, 100, 50)), (torch.float32, (37, 100, 50)),
                          (torch.float32, (64, 256, 128))):
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
        epi = dict(scale=torch.rand((1, n), generator=gen, device=dev) + 0.5,
                   bias=torch.randn((1, n), generator=gen, device=dev),
                   residual=torch.randn((m, n), generator=gen, device=dev),
                   activation="gelu")
        errs.append(check("matmul_os", matmul_df.matmul_os(a, w, **epi),
                          ref.matmul_fused_ref(a, w, **epi), **b1_tol,
                          shape=f"{dt} M={m} K={k} N={n} scale+bias+gelu+res"))
    def b1_record(a, w, shape, err, act=None):
        """B1's time at one shape beside its plain version, torch.matmul
        on the same operands and its bound (the bf16 tensor cores', or
        the CUDA cores' float32 rate for float32 operands)."""
        m, k = a.shape
        n = w.shape[1]
        elt = a.element_size()
        rate = BF16_FLOPS_PER_S if a.dtype == bf16 else F32_FLOPS_PER_S
        bnd = bound((m * k + k * n) * elt + m * n * 4, 2.0 * m * k * n,
                    rate)
        return dict(
            shape=shape, max_abs_err=err,
            ms=timer.ms(lambda: matmul_df.matmul_os(a, w, activation=act)),
            plain_ms=timer.ms(lambda: ref.matmul_fused_ref(
                a, w, activation=act)),
            library_ms=timer.ms(lambda: torch.matmul(a, w)),
            library_call=f"torch.matmul ({a.dtype} out)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=b1_tol)

    # The decode shapes (M = batch 4), where the weight stream bounds B1:
    # the decode tile.
    for k, n, act in ((d, dff, "silu"), (dff, d, None)):
        a = randn(4, k)
        w = randn(k, n, std=(2.0 / (k + n)) ** 0.5)
        rec = b1_record(a, w, f"decode M=4 K={k} N={n} act={act}",
                        max(tile_errs["matmul_os_decode"]), act)
        emit({"kernel_timing_detail": "matmul_os_decode", **rec})
        if k == dff:
            records["matmul_os_decode"] = rec
    a, w, shape = head
    records["matmul_os"] = b1_record(a, w, shape, max(errs))
    # The prefill tile at the other MLP shape (the up projection).
    a = randn(512, d, generator=timed)
    w = randn(d, dff, std=(2.0 / (d + dff)) ** 0.5, generator=timed)
    records["matmul_os_prefill"] = b1_record(
        a, w, f"M=512 K={d} N={dff} act=silu",
        max(tile_errs["matmul_os_prefill"]), "silu")
    # float32 operands stay on the CUDA cores (one fmaf per k, no TF32):
    # the same shapes, timed apart from bf16.
    f32 = {}
    for m, k, n in ((512, dff, d), (4, dff, d)):
        a = torch.randn((m, k), generator=timed, device=dev)
        w = torch.randn((k, n), generator=timed, device=dev) * k ** -0.5
        rec = b1_record(a, w, f"float32 M={m} K={k} N={n}", check(
            "matmul_os", matmul_df.matmul_os(a, w), ref.matmul_fused_ref(a, w),
            shape=f"float32 M={m} K={k} N={n}", **b1_tol))
        emit({"kernel_timing_detail": "matmul_os", **rec})
        f32[f"M={m}"] = rec
    records["matmul_os"]["float32"] = f32

    # B2: bf16 outputs of f32 softmax math on both sides, which may round
    # one bf16 ulp apart (2^-8 to 2^-7 of the value); long rows average to
    # |x| ~ 0.05, where atol 4e-3 is still under a tenth of the value.
    # Row norms of the error stay under 1e-2 of the reference's: a skipped
    # KV block or page moves a row by far more.
    att_tol = dict(atol=4e-3, rtol=8e-3, row_rtol=1e-2)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    errs = []
    cases = ((512, 512, None), (17, 1024, 65), (512, 1024, 600))
    for sq, skv, kv_len in cases:
        q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, skv, dh), \
            randn(1, hkv, skv, dh)
        got = attention_df.flash_attention(q, kk, vv, kv_len=kv_len)
        want = ref.attention_ref(q, kk, vv, kv_len=kv_len)
        errs.append(check("flash_attention", got, want, **att_tol,
                          shape=f"Sq={sq} Skv={skv} kv_len={kv_len}"))
    # ragged (B,) kv_len with a window: the band's other edges
    kvb = torch.tensor([0, 5, 40, 64], device=dev, dtype=torch.int32)
    q, kk, vv = randn(4, hq, 3, dh), randn(4, hkv, 64, dh), \
        randn(4, hkv, 64, dh)
    got = attention_df.flash_attention(q, kk, vv, kv_len=kvb, window=24)
    want = ref.attention_ref(q, kk, vv, kv_len=kvb, window=24)
    errs.append(check("flash_attention", got, want, **att_tol,
                      shape="B=4 Sq=3 Skv=64 kv_len=[0,5,40,64] window=24"))
    # float32 instantiation at D=64 (f32 math on both sides)
    f32_tol = F32_TOL
    q, kk, vv = (torch.randn(s, generator=gen, device=dev) for s in (
        (2, 4, 40, 64), (2, 2, 40, 64), (2, 2, 40, 64)))
    check("flash_attention", attention_df.flash_attention(
        q, kk, vv, window=9), ref.attention_ref(q, kk, vv, window=9),
        shape="float32 B=2 Sq=Skv=40 D=64 window=9", **f32_tol)
    sq = 512
    pairs = sq * (sq + 1) // 2

    def b2_record(q, kk, vv, err, tol):
        elt = q.element_size()
        rate = BF16_FLOPS_PER_S if q.dtype == bf16 else F32_FLOPS_PER_S
        bnd = bound((hq + 2 * hkv) * sq * dh * elt + hq * sq * dh * elt,
                    4.0 * dh * pairs * hq, rate)
        return dict(
            shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal "
                  f"{q.dtype}",
            max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(q, kk, vv)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, is_causal=True, enable_gqa=True)),
            library_call="F.scaled_dot_product_attention(is_causal, "
                         "enable_gqa)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)

    q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, sq, dh), \
        randn(1, hkv, sq, dh)
    records["flash_attention"] = b2_record(q, kk, vv, max(errs), att_tol)
    # float32 stays on the CUDA cores: the same shape, timed apart.
    q, kk, vv = (t.float() for t in (q, kk, vv))
    rec = b2_record(q, kk, vv, check(
        "flash_attention", attention_df.flash_attention(q, kk, vv),
        ref.attention_ref(q, kk, vv), shape=f"float32 prefill Sq=Skv={sq}",
        **f32_tol), f32_tol)
    emit({"kernel_timing_detail": "flash_attention", **rec})
    records["flash_attention"]["float32"] = {f"Sq={sq}": rec}
    modes, modes_i8 = b2_serving_modes(torch, timer, hq, hkv, dh, att_tol)
    records["flash_attention"].update(modes)
    records["flash_attention"]["group5"], records["matmul_os"]["hymba"] = \
        hymba_checks(torch, timer, att_tol)
    records["flash_attention"]["whisper"], records["matmul_os"]["whisper"] = \
        whisper_checks(torch, timer, att_tol)
    # the int8 KV cache's B2: the slot-cache decode step (its serving
    # path's every decode launch), the chunk beside it
    records["flash_attention_i8kv"] = dict(modes_i8["slot_decode"],
                                           chunk=modes_i8["chunk"])

    # B3: 4 rows, ragged lengths including 0, shuffled page ids.
    page, max_pages = 16, 64
    rows = 4
    n_pages = rows * max_pages
    kp = randn(hkv, n_pages + 1, page, dh)
    vp = randn(hkv, n_pages + 1, page, dh)
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    tables = perm.reshape(rows, max_pages).to(torch.int32).contiguous()
    lens = torch.tensor([0, 17, 200, 527], device=dev, dtype=torch.int32)
    q = randn(rows, hq, 1, dh)
    errs = []
    for window in (None, 100):
        got = attention_df.paged_flash_attention(q, kp, vp, tables, lens,
                                                 window=window)
        want = ref.paged_attention_ref(q, kp, vp, tables, lens,
                                       window=window)
        errs.append(check("paged_attention", got, want, **att_tol,
                          shape=f"R={rows} page={page} kv_lens=[0,17,200,"
                                f"527] shuffled window={window}"))
    kp32, vp32, q32 = (t[..., :64].float().contiguous() for t in (kp, vp, q))
    check("paged_attention",
          attention_df.paged_flash_attention(q32, kp32, vp32, tables, lens),
          ref.paged_attention_ref(q32, kp32, vp32, tables, lens),
          shape="float32 D=64 kv_lens=[0,17,200,527]", **f32_tol)
    keys = int(lens.sum())
    bnd = bound(2 * keys * hkv * dh * 2 + 2 * rows * hq * dh * 2
                + tables.numel() * 4, 4.0 * dh * keys * hq)
    records["paged_attention"] = dict(
        shape=f"decode R={rows} Hq={hq} Hkv={hkv} D={dh} page={page} "
              f"kv_lens=[0,17,200,527]",
        max_abs_err=max(errs),
        ms=timer.ms(lambda: attention_df.paged_flash_attention(
            q, kp, vp, tables, lens)),
        plain_ms=timer.ms(lambda: ref.paged_attention_ref(
            q, kp, vp, tables, lens)),
        library_ms=None, library_call=None,
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=att_tol)
    # One long row a row: 4 rows at kv_len 4096 (256 pages, 32 chunks
    # each), from their own generator so every later check keeps its
    # inputs; checked with and without a window, timed beside the served
    # shape.
    long_gen = torch.Generator(device=dev).manual_seed(2)
    long_pages = 256
    n_long = rows * long_pages
    kpl = randn(hkv, n_long, page, dh, generator=long_gen)
    vpl = randn(hkv, n_long, page, dh, generator=long_gen)
    tables_l = torch.randperm(n_long, generator=long_gen, device=dev).reshape(
        rows, long_pages).to(torch.int32).contiguous()
    lens_l = torch.full((rows,), 4096, device=dev, dtype=torch.int32)
    ql = randn(rows, hq, 1, dh, generator=long_gen)
    long_errs = []
    for window in (None, 100):
        long_errs.append(check(
            "paged_attention",
            attention_df.paged_flash_attention(ql, kpl, vpl, tables_l, lens_l,
                                               window=window),
            ref.paged_attention_ref(ql, kpl, vpl, tables_l, lens_l,
                                    window=window),
            shape=f"long R={rows} kv_lens=4096 window={window}", **att_tol))
    keys_l = int(lens_l.sum())
    bnd_l = bound(2 * keys_l * hkv * dh * 2 + 2 * rows * hq * dh * 2
                  + tables_l.numel() * 4, 4.0 * dh * keys_l * hq)
    long_rec = dict(
        shape=f"decode R={rows} Hq={hq} Hkv={hkv} D={dh} page={page} "
              f"kv_lens=4096 x {rows}",
        max_abs_err=max(long_errs),
        ms=timer.ms(lambda: attention_df.paged_flash_attention(
            ql, kpl, vpl, tables_l, lens_l)),
        plain_ms=timer.ms(lambda: ref.paged_attention_ref(
            ql, kpl, vpl, tables_l, lens_l)),
        library_ms=None, bound_ms=bnd_l[0], bound_by=bnd_l[1],
        tolerance=att_tol)
    emit({"kernel_timing_detail": "paged_attention", **long_rec})
    records["paged_attention"]["long_row"] = long_rec
    records["paged_attention"]["pages"] = paged_page_checks(
        torch, timer, hq, hkv, dh, att_tol, f32_tol)
    records["paged_attention_g16"] = paged_group16_checks(
        torch, timer, att_tol, f32_tol)
    records.update(gemm_dataflow_checks(torch, cfg, timer, gen, b1_tol))
    # How B1's bf16 k steps round against cuBLAS (reported, not gated).
    from repro_torch.bench import rounding
    for row in rounding.run("cuda"):
        emit(row)
    records.update(kv_stationary_checks(torch, cfg, timer, gen, att_tol,
                                        f32_tol))
    k1, k2, d16 = f32_int8_and_d16_checks(torch, cfg, timer, att_tol,
                                          f32_tol)
    records["flash_attention_f32_i8kv"] = k1
    records["kv_stationary_f32_i8kv"] = k2
    for name, rec in d16.items():
        records[name]["d16"] = rec
    records.update(binary_checks(torch, cfg, timer, gen))
    records.update(conv_checks(torch, timer, gen, b1_tol))
    records.update(int8_packed_checks(torch, cfg, timer, gen, b1_tol))
    records["conv2d_os_i8"]["packed4"] = packed_conv_checks(torch, timer,
                                                            gen)
    for name, rec in records.items():
        emit({"kernel_timing": name, **rec})
    return records


# Pages of more than 32 keys B3 takes since its tiles became 32-key slices
# of a row's key range (it refused them before).
PAGED_BIG_PAGES = (48, 64, 128)


def paged_page_checks(torch, timer, hq, hkv, dh, tol, f32_tol):
    """B3 at pages of 48, 64 and 128 keys: the served decode shape (4
    rows, kv_lens 0/17/200/527, shuffled page ids) and the long row (4 x
    4 096 keys), each with and without a 100-key window, held against the
    plain version within B2's tolerance (and the served shape at float32,
    D 64), timed beside it with its byte bound (no single PyTorch call
    attends through a block table).  Inputs from their own generator per
    page, so every other check keeps its inputs.  Returns the records by
    page."""
    from repro_torch.bench.common import bound
    from repro_torch.kernels import attention_df, ref

    dev, bf16, rows = "cuda", torch.bfloat16, 4
    out = {}
    for page in PAGED_BIG_PAGES:
        gen = torch.Generator(device=dev).manual_seed(100 + page)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(bf16)

        recs = {}
        for tag, lens in (("served", [0, 17, 200, 527]),
                          ("long_row", [4096] * rows)):
            max_pages = -(-max(max(lens), 1024) // page)
            n_pages = rows * max_pages
            kp, vp = (randn(hkv, n_pages + 1, page, dh) for _ in range(2))
            tables = torch.randperm(n_pages, generator=gen,
                                    device=dev).reshape(
                rows, max_pages).to(torch.int32).contiguous()
            kv = torch.tensor(lens, device=dev, dtype=torch.int32)
            q = randn(rows, hq, 1, dh)
            errs = []
            for window in (None, 100):
                errs.append(check(
                    "paged_attention",
                    attention_df.paged_flash_attention(q, kp, vp, tables, kv,
                                                       window=window),
                    ref.paged_attention_ref(q, kp, vp, tables, kv,
                                            window=window),
                    shape=f"R={rows} page={page} kv_lens={lens} shuffled "
                          f"window={window}", **tol))
            if tag == "served":
                kp32, vp32, q32 = (t[..., :64].float().contiguous()
                                   for t in (kp, vp, q))
                check("paged_attention",
                      attention_df.paged_flash_attention(q32, kp32, vp32,
                                                         tables, kv),
                      ref.paged_attention_ref(q32, kp32, vp32, tables, kv),
                      shape=f"float32 D=64 page={page} kv_lens={lens}",
                      **f32_tol)
            keys = int(kv.sum())
            bnd = bound(2 * keys * hkv * dh * 2 + 2 * rows * hq * dh * 2
                        + tables.numel() * 4, 4.0 * dh * keys * hq)
            recs[tag] = dict(
                shape=f"decode R={rows} Hq={hq} Hkv={hkv} D={dh} "
                      f"page={page} kv_lens={lens}",
                max_abs_err=max(errs),
                ms=timer.ms(lambda: attention_df.paged_flash_attention(
                    q, kp, vp, tables, kv)),
                plain_ms=timer.ms(lambda: ref.paged_attention_ref(
                    q, kp, vp, tables, kv)),
                library_ms=None,
                library_why="no single PyTorch call attends through a "
                            "block table",
                bound_ms=bnd[0], bound_by=bnd[1],
                chunks_per_row=[len(attention_df.paged_chunks(
                    n, page, max_pages)) for n in lens],
                tolerance=tol)
            emit({"kernel_timing_detail": "paged_attention", "page": page,
                  **recs[tag]})
            del kp, vp
        out[f"page={page}"] = recs
    return out


def paged_group16_checks(torch, timer, tol, f32_tol):
    """B3 at a GQA group of 16 (qwen3-moe-235b-a22b's 64 q heads over 4
    kv heads, D 128): its 16-warp kernel at the served decode shape (4
    rows, kv_lens 0/17/200/527, page 16, shuffled page ids), with and
    without a window, held against the plain version within B2's
    tolerance (and at float32, D 64), timed beside it with its byte
    bound.  Inputs from their own generator, so every other check keeps
    its inputs.  Returns the kernel's record."""
    from repro_torch.bench.common import bound
    from repro_torch.kernels import _build, attention_df, ref

    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    hq, hkv, dh, page, max_pages, rows = 64, 4, 128, 16, 64, 4
    n_pages = rows * max_pages

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    kp, vp = randn(hkv, n_pages + 1, page, dh), randn(hkv, n_pages + 1,
                                                       page, dh)
    tables = torch.randperm(n_pages, generator=gen, device=dev).reshape(
        rows, max_pages).to(torch.int32).contiguous()
    lens = torch.tensor([0, 17, 200, 527], device=dev, dtype=torch.int32)
    q = randn(rows, hq, 1, dh)
    errs = []
    before = _build.LAUNCHES[_build.PAGED_G16]
    for window in (None, 100):
        errs.append(check(
            "paged_attention_g16",
            attention_df.paged_flash_attention(q, kp, vp, tables, lens,
                                               window=window),
            ref.paged_attention_ref(q, kp, vp, tables, lens, window=window),
            shape=f"group 16 R={rows} page={page} kv_lens=[0,17,200,527] "
                  f"shuffled window={window}", **tol))
    kp32, vp32, q32 = (t[..., :64].float().contiguous() for t in (kp, vp, q))
    check("paged_attention_g16",
          attention_df.paged_flash_attention(q32, kp32, vp32, tables, lens),
          ref.paged_attention_ref(q32, kp32, vp32, tables, lens),
          shape="group 16 float32 D=64 kv_lens=[0,17,200,527]", **f32_tol)
    if _build.LAUNCHES[_build.PAGED_G16] != before + 3:
        raise AssertionError("B3 at group 16 did not run its 16-warp kernel")
    keys = int(lens.sum())
    bnd = bound(2 * keys * hkv * dh * 2 + 2 * rows * hq * dh * 2
                + tables.numel() * 4, 4.0 * dh * keys * hq)
    return dict(
        shape=f"decode R={rows} Hq={hq} Hkv={hkv} D={dh} page={page} "
              f"kv_lens=[0,17,200,527]",
        max_abs_err=max(errs),
        ms=timer.ms(lambda: attention_df.paged_flash_attention(
            q, kp, vp, tables, lens)),
        plain_ms=timer.ms(lambda: ref.paged_attention_ref(
            q, kp, vp, tables, lens)),
        library_ms=None, library_call=None,
        library_why="no single PyTorch call attends through a block table",
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)


def b2_serving_modes(torch, timer, hq, hkv, dh, tol):
    """B2 in the two modes the serving loop adds, at full width in a
    1 024-key buffer: one prefill chunk (Sq = 128 queries at offset 384,
    kv_len 512) and the slot-cache decode step (4 rows of Sq = 1, per-row
    kv_len 17/64/200/511; B2's 64-row q tile carries one live row).  Each
    is held against the plain version and timed beside it and SDPA with
    the equivalent boolean mask; the bound counts the keys each row's
    band reads.  Then the same two modes over the int8 KV cache's K/V
    (the bf16 K/V quantized per position, ``quant.symmetric_int8``),
    held against the plain version with the scales, each launch counted
    under ``flash_attention_i8kv``, timed beside the plain version and
    bf16 B2 at the same shape (no PyTorch call attends over int8 K/V
    with per-position scales); the bound counts the int8 codes and f32
    scales of the visited keys.  Returns (bf16 records, int8 records)
    by mode."""
    import torch.nn.functional as F

    from repro_torch.bench.common import bound
    from repro_torch.core import quant
    from repro_torch.kernels import _build, attention_df, ref

    dev, buf = "cuda", 1024
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    out, out_i8 = {}, {}
    for mode, sq, lens in (("chunk", 128, [512]),
                           ("slot_decode", 1, [17, 64, 200, 511])):
        b = len(lens)
        q, kk, vv = randn(b, hq, sq, dh), randn(b, hkv, buf, dh), \
            randn(b, hkv, buf, dh)
        kv = (lens[0] if b == 1
              else torch.tensor(lens, device=dev, dtype=torch.int32))
        shape = (f"{mode} B={b} Sq={sq} kv_len={lens} buffer={buf} "
                 f"Hq={hq} Hkv={hkv} D={dh} bf16")
        err = check("flash_attention",
                    attention_df.flash_attention(q, kk, vv, kv_len=kv),
                    ref.attention_ref(q, kk, vv, kv_len=kv), shape=shape,
                    **tol)
        kv_col = torch.tensor(lens, device=dev)[:, None, None]
        row = torch.arange(sq, device=dev)[None, :, None] + kv_col - sq
        key = torch.arange(buf, device=dev)[None, None, :]
        mask = ((key < kv_col) & (key <= row))[:, None]     # (B, 1, Sq, buf)
        pairs = sum(sq * n - sq * (sq - 1) // 2 for n in lens)
        qo_bytes = 2 * b * hq * sq * dh * 2
        bnd = bound(2 * sum(lens) * hkv * dh * 2 + qo_bytes,
                    4.0 * dh * pairs * hq)
        rec = dict(
            shape=shape, max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(
                q, kk, vv, kv_len=kv)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv,
                                                        kv_len=kv)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, enable_gqa=True)),
            library_call="F.scaled_dot_product_attention(attn_mask, "
                         "enable_gqa)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)
        emit({"kernel_timing_detail": "flash_attention", **rec})
        out[mode] = rec

        # int8 K/V: the same keys quantized per position
        (kq, ks), (vq, vs) = quant.symmetric_int8(kk, -1), \
            quant.symmetric_int8(vv, -1)
        i8 = dict(kv_len=kv, k_scale=ks, v_scale=vs)
        shape8 = shape.replace("bf16", "bf16 q, int8 K/V + f32 scales")
        before = _build.LAUNCHES["flash_attention_i8kv"]
        got = attention_df.flash_attention(q, kq, vq, **i8)
        if _build.LAUNCHES["flash_attention_i8kv"] != before + 1:
            raise AssertionError(f"flash_attention at {shape8} did not "
                                 f"launch its int8 path once")
        err8 = check("flash_attention_i8kv", got,
                     ref.attention_ref(q, kq, vq, **i8), shape=shape8, **tol)
        bnd8 = bound(2 * sum(lens) * hkv * (dh + 4) + qo_bytes,
                     4.0 * dh * pairs * hq)
        rec8 = dict(
            shape=shape8, max_abs_err=err8,
            ms=timer.ms(lambda: attention_df.flash_attention(q, kq, vq,
                                                             **i8)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kq, vq, **i8)),
            library_ms=None,
            library_call=None, library_why="no PyTorch call attends over "
            "int8 K/V with per-position scales",
            bf16_ms=rec["ms"], bound_ms=bnd8[0], bound_by=bnd8[1],
            tolerance=tol)
        emit({"kernel_timing_detail": "flash_attention_i8kv", **rec8})
        out_i8[mode] = rec8
    return out, out_i8


def hymba_checks(torch, timer, tol):
    """The kernels at hymba-1.5b's widths, which no config served before
    it: B2 at its GQA group of 5 (25 q heads over 5 kv heads, D 64),
    windowed (1 024 keys) as 29 of its 32 layers attend and full as the
    other 3, at the prefill square of its longest served prompt (Sq =
    1 536) and at the slot-cache decode step (4 rows of Sq = 1 in a
    2 048-key buffer, kv_len 17/64/200/1 536); and B1's bf16 tiles at its
    MLP (K 1 600 -> N 5 504 with the silu, 5 504 -> 1 600; M 4, 511 and
    1 536).  Each held against its plain version (B2's tolerance ``tol``,
    B1's ``B1_TOL``) and timed beside it and the PyTorch call (SDPA with
    the equivalent boolean mask; ``torch.matmul``); B2's bound counts the
    keys each row's band reads.  Inputs from their own generator, so
    every other check keeps its inputs.  Returns (B2 records by mode, B1
    records by shape)."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.bench.common import bound
    from repro_torch.kernels import attention_df, matmul_df, ref

    cfg = configs.get("hymba-1.5b")
    hq, hkv, dh, win = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, \
        cfg.attn_window
    dev, buf, sq = "cuda", 2048, 1536
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)

    att = {}
    q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, sq, dh), \
        randn(1, hkv, sq, dh)
    lens = [17, 64, 200, sq]
    qd, kd, vd = randn(4, hq, 1, dh), randn(4, hkv, buf, dh), \
        randn(4, hkv, buf, dh)
    kv = torch.tensor(lens, device=dev, dtype=torch.int32)
    key = torch.arange(buf, device=dev)
    kv_col = kv.long()[:, None]
    pos = torch.arange(sq, device=dev)
    for w in (win, None):
        tag = f"window={w}"
        band = sq if w is None else w
        # the prefill square: row i sees min(i + 1, band) keys
        pairs = sum(min(i + 1, band) for i in range(sq))
        err = check("flash_attention",
                    attention_df.flash_attention(q, kk, vv, window=w),
                    ref.attention_ref(q, kk, vv, window=w), **tol,
                    shape=f"hymba prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} "
                          f"D={dh} {tag}")
        mask = pos[None, :] <= pos[:, None]
        if w is not None:
            mask = mask & (pos[None, :] > pos[:, None] - w)
        bnd = bound(2 * (hq + hkv) * sq * dh * 2, 4.0 * dh * pairs * hq)
        att[f"prefill {tag}"] = dict(
            shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} {tag} bf16",
            max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(q, kk, vv,
                                                             window=w)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv,
                                                        window=w)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, enable_gqa=True)),
            library_call="F.scaled_dot_product_attention(attn_mask, "
                         "enable_gqa)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)
        # the slot-cache decode step: row r sees min(kv_len_r, band) keys
        keys = sum(min(n, band) for n in lens)
        err = check("flash_attention",
                    attention_df.flash_attention(qd, kd, vd, kv_len=kv,
                                                 window=w),
                    ref.attention_ref(qd, kd, vd, kv_len=kv, window=w),
                    **tol, shape=f"hymba slot decode B=4 Sq=1 kv_len={lens}"
                                 f" buffer={buf} {tag}")
        dmask = key[None, :] < kv_col
        if w is not None:
            dmask = dmask & (key[None, :] >= kv_col - w)
        dmask = dmask[:, None, None, :]
        bnd = bound(2 * keys * hkv * dh * 2 + 2 * 4 * hq * dh * 2,
                    4.0 * dh * keys * hq)
        att[f"slot_decode {tag}"] = dict(
            shape=f"slot decode B=4 Sq=1 kv_len={lens} buffer={buf} "
                  f"Hq={hq} Hkv={hkv} D={dh} {tag} bf16",
            max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(
                qd, kd, vd, kv_len=kv, window=w)),
            plain_ms=timer.ms(lambda: ref.attention_ref(
                qd, kd, vd, kv_len=kv, window=w)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=dmask, enable_gqa=True)),
            library_call="F.scaled_dot_product_attention(attn_mask, "
                         "enable_gqa)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)
    for rec in att.values():
        emit({"kernel_timing_detail": "flash_attention", "config": cfg.name,
              **rec})

    mlp = {}
    d, dff = cfg.d_model, cfg.d_ff
    for k, n, act in ((d, dff, "silu"), (dff, d, None)):
        w2 = randn(k, n, std=(2.0 / (k + n)) ** 0.5)
        for m in (4, 511, sq):
            a = randn(m, k)
            tile = ("matmul_os_decode" if m <= matmul_df.DECODE_M
                    else "matmul_os_prefill")
            shape = f"hymba M={m} K={k} N={n} act={act}"
            err = check(tile, matmul_df.matmul_os(a, w2, activation=act),
                        ref.matmul_fused_ref(a, w2, activation=act),
                        shape=shape, **B1_TOL)
            if m == 511:
                continue
            bnd = bound((m * k + k * n) * 2 + m * n * 4, 2.0 * m * k * n)
            mlp[f"M={m} K={k} N={n}"] = dict(
                shape=shape, tile=tile, max_abs_err=err,
                ms=timer.ms(lambda: matmul_df.matmul_os(a, w2,
                                                        activation=act)),
                plain_ms=timer.ms(lambda: ref.matmul_fused_ref(
                    a, w2, activation=act)),
                library_ms=timer.ms(lambda: torch.matmul(a, w2)),
                library_call="torch.matmul (bf16 out)",
                bound_ms=bnd[0], bound_by=bnd[1], tolerance=B1_TOL)
            emit({"kernel_timing_detail": tile, "config": cfg.name,
                  **mlp[f"M={m} K={k} N={n}"]})
    return att, mlp


def whisper_checks(torch, timer, tol):
    """The kernels at whisper-tiny's widths, which no config served before
    it: B2 at 6 q heads over 6 kv heads, D 64, causal, at the decoder's
    prefills (4 rows of 64 tokens; one row of 432) and its slot-cache
    decode steps (4 rows of Sq = 1 at one shared kv_len 72 of a 448-key
    buffer, as ``lm.decode_step`` runs a batch at one index; one row at
    kv_len 440); and B1's bf16 tiles at its MLP (K 384 -> N 1 536 with
    the silu, 1 536 -> 384) at the encoder's M = 4 x 1 500 rows, the
    decoder's prefills (M 256 and 432) and decode (M 4).  Each held
    against its plain version (B2's tolerance ``tol``, B1's ``B1_TOL``)
    and timed beside it and the PyTorch call (SDPA, causal or with the
    equivalent boolean mask; ``torch.matmul``); B2's bound counts the
    keys each row's band reads.  Inputs from their own generator, so
    every other check keeps its inputs.  Returns (B2 records by mode, B1
    records by shape)."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.bench.common import bound
    from repro_torch.kernels import attention_df, matmul_df, ref

    cfg = configs.get("whisper-tiny")
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev, buf = "cuda", SERVE_AUDIO_MAX_LEN
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)

    att = {}
    for b, sq in ((SERVE_BATCH, SERVE_AUDIO_PROMPT), (1, SERVE_AUDIO_LONG)):
        q, kk, vv = (randn(b, h, sq, dh) for h in (hq, hkv, hkv))
        shape = f"prefill B={b} Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal"
        err = check("flash_attention", attention_df.flash_attention(q, kk, vv),
                    ref.attention_ref(q, kk, vv), shape=f"whisper {shape}",
                    **tol)
        bnd = bound(2 * b * (hq + hkv) * sq * dh * 2,
                    4.0 * dh * b * hq * sq * (sq + 1) / 2)
        att[f"prefill B={b} Sq={sq}"] = dict(
            shape=f"{shape} bf16", max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(q, kk, vv)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, is_causal=True)),
            library_call="F.scaled_dot_product_attention(is_causal=True)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)
    for b, kv in ((SERVE_BATCH, 72), (1, 440)):
        qd, kd, vd = randn(b, hq, 1, dh), randn(b, hkv, buf, dh), \
            randn(b, hkv, buf, dh)
        shape = (f"slot decode B={b} Sq=1 kv_len={kv} buffer={buf} Hq={hq} "
                 f"Hkv={hkv} D={dh}")
        err = check("flash_attention",
                    attention_df.flash_attention(qd, kd, vd, kv_len=kv),
                    ref.attention_ref(qd, kd, vd, kv_len=kv),
                    shape=f"whisper {shape}", **tol)
        mask = (torch.arange(buf, device=dev) < kv)[None, None, None, :]
        bnd = bound(2 * b * kv * hkv * dh * 2 + 2 * b * hq * dh * 2,
                    4.0 * dh * b * kv * hq)
        att[f"slot_decode B={b} kv_len={kv}"] = dict(
            shape=f"{shape} bf16", max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(
                qd, kd, vd, kv_len=kv)),
            plain_ms=timer.ms(lambda: ref.attention_ref(qd, kd, vd,
                                                        kv_len=kv)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask)),
            library_call="F.scaled_dot_product_attention(attn_mask)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)
    for rec in att.values():
        emit({"kernel_timing_detail": "flash_attention", "config": cfg.name,
              **rec})

    mlp = {}
    d, dff = cfg.d_model, cfg.d_ff
    enc_m = SERVE_BATCH * SERVE_AUDIO_FRAMES
    for k, n, act in ((d, dff, "silu"), (dff, d, None)):
        w2 = randn(k, n, std=(2.0 / (k + n)) ** 0.5)
        for m in (SERVE_BATCH, SERVE_BATCH * SERVE_AUDIO_PROMPT,
                  SERVE_AUDIO_LONG, enc_m):
            a = randn(m, k)
            tile = ("matmul_os_decode" if m <= matmul_df.DECODE_M
                    else "matmul_os_prefill")
            shape = f"whisper M={m} K={k} N={n} act={act}"
            err = check(tile, matmul_df.matmul_os(a, w2, activation=act),
                        ref.matmul_fused_ref(a, w2, activation=act),
                        shape=shape, **B1_TOL)
            if m not in (SERVE_BATCH, enc_m):
                continue
            bnd = bound((m * k + k * n) * 2 + m * n * 4, 2.0 * m * k * n)
            mlp[f"M={m} K={k} N={n}"] = dict(
                shape=shape, tile=tile, max_abs_err=err,
                ms=timer.ms(lambda: matmul_df.matmul_os(a, w2,
                                                        activation=act)),
                plain_ms=timer.ms(lambda: ref.matmul_fused_ref(
                    a, w2, activation=act)),
                library_ms=timer.ms(lambda: torch.matmul(a, w2)),
                library_call="torch.matmul (bf16 out)",
                bound_ms=bnd[0], bound_by=bnd[1], tolerance=B1_TOL)
            emit({"kernel_timing_detail": tile, "config": cfg.name,
                  **mlp[f"M={m} K={k} N={n}"]})
    return att, mlp


def gemm_dataflow_checks(torch, cfg, timer, gen, tol):
    """B1's residencies, B4, B5a and B5b: each of the nine canonical specs
    at the shapes the dataflows phase gives them (qwen3-1.7b's MLP GEMMs
    and the paper's layer grid) and at small odd shapes.  A
    spec whose resident operands fit runs through the kernel
    ``matmul_df.plan`` names (one launch of it), matches the plain version
    within B1's tolerance and equals B1's basic output bit for bit (every
    kernel sums k in the same order, one fmaf per step, in f32); a spec
    that does not fit raises ``ValueError`` naming the bytes."""
    from repro_torch.bench import common
    from repro_torch.kernels import _build, matmul_df, ops, ref

    dev = "cuda"
    bf16 = torch.bfloat16
    d, dff = cfg.d_model, cfg.d_ff
    errs = {}
    feasibility = []

    def run_all(label, a, w, out_dtype=torch.float32, **epi):
        m, k = a.shape
        n = w.shape[1]
        base = matmul_df.matmul_os(a, w, out_dtype=out_dtype, **epi)
        want = ref.matmul_fused_ref(a, w, out_dtype=out_dtype, **epi)
        ran = []
        for name, spec in common.NINE_SPECS.items():
            try:
                p = matmul_df.plan(spec, m, k, n, a.dtype)
            except ValueError as err:
                try:
                    ops.matmul_fused(a, w, spec=spec, out_dtype=out_dtype,
                                     **epi)
                except ValueError as again:
                    if "bytes of shared memory" not in str(again):
                        raise
                else:
                    raise AssertionError(f"{name} at {label} ran though "
                                         f"its plan is infeasible: {err}")
                feasibility.append({"shape": label, "spec": name,
                                    "feasible": False, "why": str(err)})
                continue
            keys = (p.kernel,) + ((p.tile_kernel,) if p.tile_kernel else ())
            before = [_build.LAUNCHES[key] for key in keys]
            got = ops.matmul_fused(a, w, spec=spec, out_dtype=out_dtype,
                                   **epi)
            if [_build.LAUNCHES[key] for key in keys] != \
                    [x + 1 for x in before]:
                raise AssertionError(f"{name} at {label} did not launch "
                                     f"{' and '.join(keys)} once")
            err = check(f"{p.kernel}[{name}]", got, want, shape=label,
                        plus_bf16_ulp=out_dtype == torch.bfloat16, **tol)
            for key in keys:
                errs.setdefault(key, []).append(err)
            bitwise = torch.equal(got, base)
            if not bitwise:
                diff = float((got.float() - base.float()).abs().max())
                raise AssertionError(f"{name} at {label} differs from B1's "
                                     f"output (max |diff| {diff})")
            ran.append(name)
            feasibility.append({"shape": label, "spec": name,
                                "feasible": True, "kernel": p.kernel,
                                "tile_kernel": p.tile_kernel,
                                "cluster": p.cluster,
                                "walk": p.walk, "ctas": p.ctas,
                                "smem_bytes": p.smem_bytes,
                                "demoted": p.demoted})
        emit({"check": "dataflows_equal_b1", "shape": label, "ran": ran,
              "bitwise_equal": True})

    for m, k, n in common.QWEN_MLP:
        a = (torch.randn((m, k), generator=gen, device=dev)).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * (2.0 / (k + n)) ** 0.5).to(bf16)
        if n == dff:
            run_all(f"qwen3 up M={m} K={k} N={n} silu", a, w,
                    activation="silu")
        else:
            res = torch.randn((m, n), generator=gen, device=dev)
            run_all(f"qwen3 down M={m} K={k} N={n} residual", a, w,
                    residual=res)
    for layer in common.PAPER_LAYERS:
        g = common.paper_gemm(layer)
        a, w = common.gemm_operands(g.m, g.k, g.n, dev, seed=sum(layer))
        run_all(f"paper layer {layer} M={g.m} K={g.k} N={g.n}", a, w)
    # Small odd shapes: every spec fits, the element-wise loads, float32
    # inputs, bf16 outputs and every epilogue stage (per-column and per-row
    # scales).
    for dt, (m, k, n), out_dtype, scale_rows in (
            (bf16, (37, 100, 50), torch.float32, False),
            (torch.float32, (37, 100, 50), torch.float32, True),
            (torch.float32, (64, 256, 128), torch.float32, False),
            (bf16, (137, 256, 192), bf16, True)):
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(dt)
        scale = torch.rand((m, 1) if scale_rows else (1, n), generator=gen,
                           device=dev) + 0.5
        run_all(f"{dt} M={m} K={k} N={n} out={out_dtype} "
                f"scale({'row' if scale_rows else 'col'})+bias+gelu+res",
                a, w, out_dtype=out_dtype, scale=scale,
                bias=torch.randn((1, n), generator=gen, device=dev),
                residual=torch.randn((m, n), generator=gen, device=dev),
                activation="gelu")
    emit({"dataflow_feasibility": feasibility})

    # Timed shapes: each kernel where its dataflow fits at full size (the
    # shapes of bench/walk_times.py, which times a parent commit's kernels
    # the same way).
    from repro_torch.bench import walk_times

    records = {}
    for kernel, spec_name, shape in walk_times.TIMED:
        row = walk_times.time_row(timer, spec_name, shape, dev)
        row.update(max_abs_err=max(errs[row["tile_kernel"] or kernel]),
                   tolerance=tol)
        emit({"kernel_timing_detail": kernel, **row})
        key = row["tile_kernel"] or kernel
        if spec_name == "is_basic":   # B4's IS walk, beside its WS walk
            records[key]["is_walk"] = row
        elif spec_name == "os_w_stripe":
            records[key] = row
        else:
            records[kernel] = records[key] = row
    return records


def kv_stationary_checks(torch, cfg, timer, gen, tol, f32_tol):
    """B7 against the plain version at qwen3-1.7b prefill widths (the
    attention-anchor bench's 512 and 2048 among them), with B2's
    tolerances, and at bf16 against B2 bit for bit (the same step over the
    same tiles, the state exact: a gate); each bf16 launch on its cluster
    kernel, counted under its key.  Timed at Sq = 512 and 2048."""
    import torch.nn.functional as F

    from repro_torch.bench.common import bound
    from repro_torch.kernels import _build, attention_df, ref

    dev = "cuda"
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    errs = []
    for b, sq, skv, kv_len, window in (
            (1, 512, 512, None, None), (1, 2048, 2048, None, None),
            (1, 17, 1024, 65, None),
            (1, 512, 1024, 600, None), (1, 200, 200, None, 64),
            (4, 3, 64, [0, 5, 40, 64], 24)):
        q, kk, vv = randn(b, hq, sq, dh), randn(b, hkv, skv, dh), \
            randn(b, hkv, skv, dh)
        lens = kv_len
        if isinstance(kv_len, list):
            lens = torch.tensor(kv_len, device=dev, dtype=torch.int32)
        shape = (f"B={b} Sq={sq} Skv={skv} kv_len={kv_len} "
                 f"window={window}")
        before = _build.LAUNCHES["kv_stationary_cluster"]
        got = attention_df.kv_stationary_attention(q, kk, vv, kv_len=lens,
                                                   window=window)
        if _build.LAUNCHES["kv_stationary_cluster"] != before + 1:
            raise AssertionError(f"kv_stationary at {shape} did not launch "
                                 f"its cluster kernel once")
        want = ref.attention_ref(q, kk, vv, kv_len=lens, window=window)
        errs.append(check("kv_stationary", got, want, **tol, shape=shape))
        _bitwise("kv_stationary_equals_flash_bitwise", got,
                 attention_df.flash_attention(q, kk, vv, kv_len=lens,
                                              window=window), shape)
    q, kk, vv = (torch.randn(s, generator=gen, device=dev) for s in (
        (2, 4, 40, 64), (2, 2, 40, 64), (2, 2, 40, 64)))
    check("kv_stationary", attention_df.kv_stationary_attention(
        q, kk, vv, window=9), ref.attention_ref(q, kk, vv, window=9),
        shape="float32 B=2 Sq=Skv=40 D=64 window=9", **f32_tol)

    def record(sq):
        q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, sq, dh), \
            randn(1, hkv, sq, dh)
        pairs = sq * (sq + 1) // 2
        bnd = bound((hq + 2 * hkv) * sq * dh * 2 + hq * sq * dh * 2,
                    4.0 * dh * pairs * hq)
        plan = attention_df.kv_stationary_plan(1, hq, hkv, sq, sq, d=dh)
        return dict(
            shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal",
            max_abs_err=max(errs), cluster=plan.cluster, ctas=plan.ctas,
            ms=timer.ms(lambda: attention_df.kv_stationary_attention(
                q, kk, vv)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, is_causal=True, enable_gqa=True)),
            library_call="F.scaled_dot_product_attention(is_causal, "
                         "enable_gqa)",
            flash_ms=timer.ms(lambda: attention_df.flash_attention(
                q, kk, vv)),
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol,
            equals_flash_bitwise=True)

    rec = record(512)
    rec["sq2048"] = record(2048)
    emit({"kernel_timing_detail": "kv_stationary", **rec["sq2048"]})

    # int8 K/V (the int8 KV cache's datapath) at prefill 512: B7 on its
    # cluster kernel, counted under its int8 key, equal to B2's int8
    # output bit for bit (a gate) and within B2's tolerance of the plain
    # version; its own generator, so every check above keeps its inputs.
    from repro_torch.core import quant

    sq = 512
    g8 = torch.Generator(device=dev).manual_seed(4)
    q, kk, vv = (torch.randn((1, h, sq, dh), generator=g8, device=dev).to(
        torch.bfloat16) for h in (hq, hkv, hkv))
    (kq, ks), (vq, vs) = quant.symmetric_int8(kk, -1), \
        quant.symmetric_int8(vv, -1)
    i8 = dict(k_scale=ks, v_scale=vs)
    shape = (f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal, bf16 q, "
             f"int8 K/V + f32 scales")
    before = _build.LAUNCHES["kv_stationary_cluster_i8kv"]
    got = attention_df.kv_stationary_attention(q, kq, vq, **i8)
    launched = _build.LAUNCHES["kv_stationary_cluster_i8kv"] - before
    if launched != 1:
        raise AssertionError(f"kv_stationary at {shape} launched its int8 "
                             f"cluster path {launched} times, not once")
    err = check("kv_stationary_cluster_i8kv", got,
                ref.attention_ref(q, kq, vq, **i8), **tol, shape=shape)
    _bitwise("kv_stationary_i8kv_equals_flash_i8kv_bitwise", got,
             attention_df.flash_attention(q, kq, vq, **i8), shape)
    pairs = sq * (sq + 1) // 2
    bnd = bound(2 * sq * hkv * (dh + 4) + 2 * hq * sq * dh * 2,
                4.0 * dh * pairs * hq)
    plan = attention_df.kv_stationary_plan(1, hq, hkv, sq, sq, d=dh,
                                           kv_int8=True)
    rec8 = dict(
        shape=shape, max_abs_err=err, cluster=plan.cluster, ctas=plan.ctas,
        ms=timer.ms(lambda: attention_df.kv_stationary_attention(
            q, kq, vq, **i8)),
        plain_ms=timer.ms(lambda: ref.attention_ref(q, kq, vq, **i8)),
        library_ms=None, library_call=None,
        library_why="no PyTorch call attends over int8 K/V with "
                    "per-position scales",
        flash_ms=timer.ms(lambda: attention_df.flash_attention(
            q, kq, vq, **i8)),
        bf16_ms=rec["ms"], bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol,
        equals_flash_bitwise=True, kernels_phase_launches=launched)
    return {"kv_stationary": rec, "kv_stationary_cluster": rec,
            "kv_stationary_cluster_i8kv": rec8}


# (causal, window, kv_len) of B2's and B7's card tests
# (tests/test_torch_int8_kv.py MASKS): kv_len "short" is a scalar below
# Skv, a list one length per batch row (0 among them).
ATT_MASKS = ((True, None, None), (True, 24, "short"), (False, None, [0, 40]),
             (True, 40, [70, 0]), (False, 16, "short"))
# (Sq, group) of the small cases at each d_head: Skv = Sq + 57, 2 kv heads,
# 2 batch rows.
SMALL_ATT = ((1, 1), (17, 2), (200, 4))


def _small_att_cases(torch, gen, d, dtype):
    """Each small case at ``d``: (label, q, k, v, masks), K/V drawn in
    ``dtype``; masks the ``ATT_MASKS`` as keyword arguments."""
    dev = "cuda"
    for sq, group in SMALL_ATT:
        b, hkv, skv = 2, 2, sq + 57
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((b, hkv * group, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
        masks = []
        for causal, window, kv_len in ATT_MASKS:
            lens = ({None: None, "short": skv - 9}[kv_len]
                    if not isinstance(kv_len, list) else
                    torch.tensor(kv_len, device=dev, dtype=torch.int32))
            masks.append(dict(causal=causal, window=window, kv_len=lens))
        yield f"B={b} Hq={hkv * group} Hkv={hkv} Sq={sq} Skv={skv} D={d}", \
            q, k, v, masks


def f32_int8_and_d16_checks(torch, cfg, timer, tol, f32_tol):
    """The paths of this slice's kernels, each held against its plain
    version on the card.  K1, B2's f32 kernel over int8 K/V (float32
    queries; the int8 codes with per-position f32 scales, counted under
    ``flash_attention_f32_i8kv``): at qwen3-1.7b's full-width heads at
    the prefill chunk and slot-cache decode (B2's serving modes, 1 024-key
    buffer), timed beside its plain version and f32 B2 over the float K/V
    (no PyTorch call attends over int8 K/V with per-position scales), and
    at d_head 16/32/64 over the small cases and every mask of B2's card
    tests.  K2, B7's f32 kernel over int8 K/V (counted under
    ``kv_stationary_f32_i8kv``): equal to K1 bit for bit (a gate; B7's f32
    kernel folds B2's f32 tiles with B2's f32 step) at prefill 512 at full
    width, timed there, and over the small cases.  K3, every attention
    kernel at d_head 16: B2 (bf16 and f32) and B7 (bf16 on its cluster
    kernel, equal to B2 bit for bit; f32) over the small cases, B3 (bf16
    and f32) at the served decode shape, each timed at qwen3-1.7b's
    heads with d_head 16 beside its plain version and SDPA (none for
    B3).  Returns the records to merge into the kernels phase's."""
    import torch.nn.functional as F

    from repro_torch.bench.common import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S,
                                          bound)
    from repro_torch.core import quant
    from repro_torch.kernels import _build, attention_df, ref

    dev, buf = "cuda", 1024
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(5)
    no_lib = "no PyTorch call attends over int8 K/V with per-position scales"

    def quantized(k, v):
        (kq, ks), (vq, vs) = quant.symmetric_int8(k, -1), \
            quant.symmetric_int8(v, -1)
        return kq, vq, dict(k_scale=ks, v_scale=vs)

    def counted(key, fn, shape):
        before = _build.LAUNCHES[key]
        out = fn()
        if _build.LAUNCHES[key] != before + 1:
            raise AssertionError(f"{shape}: not one launch under {key}")
        return out

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # K1 in B2's two serving modes at full width.
    k1 = {}
    for mode, sq, lens in (("chunk", 128, [512]),
                           ("slot_decode", 1, [17, 64, 200, 511])):
        b = len(lens)
        q, kk, vv = randn(b, hq, sq, dh), randn(b, hkv, buf, dh), \
            randn(b, hkv, buf, dh)
        kv = (lens[0] if b == 1
              else torch.tensor(lens, device=dev, dtype=torch.int32))
        kq, vq, sc = quantized(kk, vv)
        shape = (f"{mode} B={b} Sq={sq} kv_len={lens} buffer={buf} Hq={hq} "
                 f"Hkv={hkv} D={dh} float32 q, int8 K/V + f32 scales")
        got = counted("flash_attention_f32_i8kv", lambda: attention_df.
                      flash_attention(q, kq, vq, kv_len=kv, **sc), shape)
        err = check("flash_attention_f32_i8kv", got, ref.attention_ref(
            q, kq, vq, kv_len=kv, **sc), shape=shape, **f32_tol)
        pairs = sum(sq * n - sq * (sq - 1) // 2 for n in lens)
        bnd = bound(2 * sum(lens) * hkv * (dh + 4) + 2 * b * hq * sq * dh * 4,
                    4.0 * dh * pairs * hq, F32_FLOPS_PER_S)
        k1[mode] = dict(
            shape=shape, max_abs_err=err,
            ms=timer.ms(lambda: attention_df.flash_attention(
                q, kq, vq, kv_len=kv, **sc)),
            plain_ms=timer.ms(lambda: ref.attention_ref(q, kq, vq, kv_len=kv,
                                                        **sc)),
            library_ms=None, library_call=None, library_why=no_lib,
            f32_ms=timer.ms(lambda: attention_df.flash_attention(
                q, kk, vv, kv_len=kv)),
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=f32_tol)
        emit({"kernel_timing_detail": "flash_attention_f32_i8kv",
              **k1[mode]})

    # K1 and K2 over the small cases at d_head 16, 32 and 64 (and 128 for
    # K2), every mask: K1 against its plain version, K2 against K1.
    k1_errs, k2_launched = [], 0
    for d in (16, 32, 64, 128):
        for label, q, kk, vv, masks in _small_att_cases(torch, gen, d,
                                                        torch.float32):
            kq, vq, sc = quantized(kk, vv)
            shape = f"{label} float32 q, int8 K/V, {len(masks)} masks"
            got = torch.stack([counted(
                "flash_attention_f32_i8kv", lambda: attention_df.
                flash_attention(q, kq, vq, **m, **sc), shape)
                for m in masks])
            if d != 128:
                k1_errs.append(check(
                    "flash_attention_f32_i8kv", got, torch.stack([
                        ref.attention_ref(q, kq, vq, **m, **sc)
                        for m in masks]), shape=shape, **f32_tol))
            b7 = torch.stack([counted(
                "kv_stationary_f32_i8kv", lambda: attention_df.
                kv_stationary_attention(q, kq, vq, **m, **sc), shape)
                for m in masks])
            k2_launched += len(masks)
            _bitwise("kv_stationary_f32_i8kv_equals_flash_f32_i8kv_bitwise",
                     b7, got, shape)
    k1["slot_decode"]["small_d_heads"] = dict(
        d_heads=[16, 32, 64], cases=[list(c) for c in SMALL_ATT],
        masks=len(ATT_MASKS), max_abs_err=max(k1_errs))

    # K2 at prefill 512, full width.
    sq = 512
    q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, sq, dh), \
        randn(1, hkv, sq, dh)
    kq, vq, sc = quantized(kk, vv)
    shape = (f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal, float32 "
             f"q, int8 K/V + f32 scales")
    got = counted("kv_stationary_f32_i8kv", lambda: attention_df.
                  kv_stationary_attention(q, kq, vq, **sc), shape)
    k2_launched += 1
    err = check("kv_stationary_f32_i8kv", got,
                ref.attention_ref(q, kq, vq, **sc), shape=shape, **f32_tol)
    _bitwise("kv_stationary_f32_i8kv_equals_flash_f32_i8kv_bitwise", got,
             attention_df.flash_attention(q, kq, vq, **sc), shape)
    pairs = sq * (sq + 1) // 2
    bnd = bound(2 * sq * hkv * (dh + 4) + 2 * hq * sq * dh * 4,
                4.0 * dh * pairs * hq, F32_FLOPS_PER_S)
    k2 = dict(
        shape=shape, max_abs_err=err,
        ms=timer.ms(lambda: attention_df.kv_stationary_attention(
            q, kq, vq, **sc)),
        plain_ms=timer.ms(lambda: ref.attention_ref(q, kq, vq, **sc)),
        library_ms=None, library_call=None, library_why=no_lib,
        flash_ms=timer.ms(lambda: attention_df.flash_attention(q, kq, vq,
                                                               **sc)),
        f32_ms=timer.ms(lambda: attention_df.kv_stationary_attention(
            q, kk, vv)),
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=f32_tol,
        equals_flash_bitwise=True)

    # K3: d_head 16.  B2 (bf16, f32) and B7 (bf16 == B2; f32) over the
    # small cases, every mask.
    d16 = {"flash_attention": {}, "kv_stationary": {}, "paged_attention": {}}
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        t = tol if dt == torch.bfloat16 else f32_tol
        name = str(dt).replace("torch.", "")
        for label, q, kk, vv, masks in _small_att_cases(torch, gen, 16, dt):
            shape = f"{label} {name}, {len(masks)} masks"
            got = torch.stack([attention_df.flash_attention(q, kk, vv, **m)
                               for m in masks])
            want = torch.stack([ref.attention_ref(q, kk, vv, **m)
                                for m in masks])
            errs.setdefault(("flash_attention", name), []).append(
                check("flash_attention", got, want, shape=shape, **t))
            b7 = torch.stack([attention_df.kv_stationary_attention(
                q, kk, vv, **m) for m in masks])
            errs.setdefault(("kv_stationary", name), []).append(
                check("kv_stationary", b7, want, shape=shape, **t))
            if dt == torch.bfloat16:
                _bitwise("kv_stationary_equals_flash_bitwise", b7, got,
                         shape)

    # ... each timed at prefill 512 with qwen3-1.7b's heads at d_head 16.
    sq, d = 512, 16
    pairs = sq * (sq + 1) // 2
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        elt, rate = (2, BF16_FLOPS_PER_S) if dt == torch.bfloat16 else \
            (4, F32_FLOPS_PER_S)
        q, kk, vv = randn(1, hq, sq, d, dtype=dt), \
            randn(1, hkv, sq, d, dtype=dt), randn(1, hkv, sq, d, dtype=dt)
        bnd = bound((hq + 2 * hkv) * sq * d * elt + hq * sq * d * elt,
                    4.0 * d * pairs * hq, rate)
        sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=True, enable_gqa=True))
        for kernel, fn in (("flash_attention", attention_df.flash_attention),
                           ("kv_stationary",
                            attention_df.kv_stationary_attention)):
            d16[kernel][name] = dict(
                shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={d} causal "
                      f"{name}",
                max_abs_err=max(errs[(kernel, name)]),
                ms=timer.ms(lambda: fn(q, kk, vv)),
                plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv)),
                library_ms=sdpa,
                library_call="F.scaled_dot_product_attention(is_causal, "
                             "enable_gqa)",
                bound_ms=bnd[0], bound_by=bnd[1],
                small_cases=[list(c) for c in SMALL_ATT],
                tolerance=tol if dt == torch.bfloat16 else f32_tol)
            emit({"kernel_timing_detail": f"{kernel} d16",
                  **d16[kernel][name]})

    # B3 at d_head 16: the served decode shape (4 rows, kv_lens
    # 0/17/200/527, page 16, shuffled page ids), with and without a window.
    page, max_pages, rows = 16, 64, 4
    n_pages = rows * max_pages
    lens = torch.tensor([0, 17, 200, 527], device=dev, dtype=torch.int32)
    tables = torch.randperm(n_pages, generator=gen, device=dev).reshape(
        rows, max_pages).to(torch.int32).contiguous()
    keys = int(lens.sum())
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        t = tol if dt == torch.bfloat16 else f32_tol
        elt, rate = (2, BF16_FLOPS_PER_S) if dt == torch.bfloat16 else \
            (4, F32_FLOPS_PER_S)
        kp, vp = randn(hkv, n_pages + 1, page, d, dtype=dt), \
            randn(hkv, n_pages + 1, page, d, dtype=dt)
        q = randn(rows, hq, 1, d, dtype=dt)
        errs_b3 = [check(
            "paged_attention",
            attention_df.paged_flash_attention(q, kp, vp, tables, lens,
                                               window=window),
            ref.paged_attention_ref(q, kp, vp, tables, lens, window=window),
            shape=f"R={rows} page={page} D={d} kv_lens=[0,17,200,527] "
                  f"{name} window={window}", **t)
            for window in (None, 100)]
        bnd = bound(2 * keys * hkv * d * elt + 2 * rows * hq * d * elt
                    + tables.numel() * 4, 4.0 * d * keys * hq, rate)
        d16["paged_attention"][name] = dict(
            shape=f"decode R={rows} Hq={hq} Hkv={hkv} D={d} page={page} "
                  f"kv_lens=[0,17,200,527] {name}",
            max_abs_err=max(errs_b3),
            ms=timer.ms(lambda: attention_df.paged_flash_attention(
                q, kp, vp, tables, lens)),
            plain_ms=timer.ms(lambda: ref.paged_attention_ref(
                q, kp, vp, tables, lens)),
            library_ms=None, library_call=None,
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=t)
        emit({"kernel_timing_detail": "paged_attention d16",
              **d16["paged_attention"][name]})
    k1rec = dict(k1["slot_decode"], chunk=k1["chunk"])
    k2["kernels_phase_launches"] = k2_launched
    return k1rec, k2, d16


def _bitwise(name: str, got, want, shape: str) -> float:
    """Integer paths and exact epilogues: equal bit for bit.  Returns the
    max |got - want| it measured (0.0 when equal)."""
    same = (got.dtype == want.dtype and got.shape == want.shape
            and bool((got == want).all()))
    diff = (float((got.double() - want.double()).abs().max())
            if got.shape == want.shape and got.numel() else float("inf"))
    emit({"check": name, "shape": shape, "bitwise_equal": same,
          "max_abs_err": diff})
    if not same:
        raise AssertionError(f"{name} {shape}: differs from its plain "
                             f"version (max |diff| {diff})")
    return diff


def _refuses(name: str, fn, label: str) -> dict:
    """An anchor whose resident operand does not fit raises ValueError
    naming its bytes."""
    try:
        fn()
    except ValueError as err:
        if "bytes of shared memory" not in str(err):
            raise
        emit({"check": f"{name}_infeasible_raises", "shape": label,
              "why": str(err), "ok": True})
        return {"shape": label, "why": str(err)}
    raise AssertionError(f"{name} at {label} ran though it cannot fit")


def binary_checks(torch, cfg, timer, gen):
    """B9 against its plain version at every anchor and epilogue stage, at
    the served binary-MLP shapes (up: M x d_model/32 words -> d_ff,
    binarized; down: M x d_ff/32 -> d_model, float) at decode M = 4 and
    prefill M = 511, and at a ragged shape: exact integer dots and an
    epilogue rounded stage by stage on both sides, so equal bit for bit,
    every anchor equal to OS.  OS is the basic launch, on the binary
    tensor-core tiles (decode at M = 4, prefill at M = 511 and the ragged
    M = 37): each OS launch must count one launch of the tile its plan
    names.  Then the tiles timed at the served shapes beside the walks,
    the plain version, ``torch.matmul`` on the unpacked +-1 bf16 operands
    and their bounds."""
    from repro_torch.bench import common
    from repro_torch.core.dataflow import BinaryEpilogue, DataflowSpec, IS, OS, WS
    from repro_torch.kernels import _build, binary_mm, ref

    dev = "cuda"
    d, dff = cfg.d_model, cfg.d_ff
    specs = {name: DataflowSpec.basic(a, block=binary_mm.BLOCK)
             for name, a in (("os", OS), ("ws", WS), ("is", IS))}

    def signs(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(m, k, n):
        return (ref.pack_binary(signs(m, k), axis=1),
                ref.pack_binary(signs(k, n), axis=0))

    stages = {
        "raw": {},
        "scale(col)": dict(scale="col"),
        "scale(tensor)+bias": dict(scale="tensor", bias=True),
        "scale+bias+residual": dict(scale="col", bias=True, residual=True),
        "scale+bias+sign": dict(scale="col", bias=True, binarize=True),
        "residual+sign": dict(residual=True, binarize=True),
    }
    shapes = [(f"up M={m}", m, d, dff) for m in (4, 511)]
    shapes += [(f"down M={m}", m, dff, d) for m in (4, 511)]
    shapes += [("ragged", 37, 160, 50)]
    other_outs = {"raw": (torch.float32, torch.bfloat16),
                  "scale(tensor)+bias": (torch.bfloat16,),
                  "scale+bias+sign": (torch.int32, torch.float32,
                                      torch.bfloat16)}
    errs = []
    for label, m, k, n in shapes:
        a, b = operands(m, k, n)
        kp = a.shape[1]
        dot = ref.binary_matmul_ref(a, b, k)
        arrays = dict(scale=torch.rand((1, n), generator=gen, device=dev)
                      + 0.5,
                      bias=torch.randn((1, n), generator=gen, device=dev),
                      residual=torch.randn((m, n), generator=gen,
                                           device=dev))
        for stage, flags in stages.items():
            kw = {}
            if flags.get("scale") == "col":
                kw["scale"] = arrays["scale"] * k ** -0.5
            elif flags.get("scale") == "tensor":
                kw["scale"] = torch.full((1, 1), k ** -0.5, device=dev)
            for name in ("bias", "residual"):
                if flags.get(name):
                    kw[name] = arrays[name]
            binarize = flags.get("binarize", False)
            epi = BinaryEpilogue(scale="scale" in kw, bias="bias" in kw,
                                 residual="residual" in kw,
                                 binarize=binarize)
            # The ragged shape also takes every other output type the
            # kernel writes for this stage.
            outs = [None] + list(other_outs.get(stage, ())
                                 if label == "ragged" else ())
            for out_dtype in outs:
                if epi.is_noop:
                    want = dot if out_dtype is None else dot.to(out_dtype)
                else:
                    want = ref.binary_epilogue_ref(
                        dot, binarize=binarize, out_dtype=out_dtype, **kw)
                base = None
                for anchor, spec in specs.items():
                    tile = binary_mm.plan(spec, m, kp, n).tile_kernel
                    before = _build.LAUNCHES[tile] if tile else None
                    got = binary_mm.binary_mm_df(a, b, k, spec,
                                                 out_dtype=out_dtype,
                                                 epilogue=epi, **kw)
                    if tile and _build.LAUNCHES[tile] != before + 1:
                        raise AssertionError(f"binary {anchor} {label} did "
                                             f"not launch {tile} once")
                    errs.append(_bitwise(
                        f"binary_mm[{anchor}]", got, want,
                        f"{label} Kp={kp} N={n} {stage} -> {got.dtype}"))
                    if base is not None and not torch.equal(got, base):
                        raise AssertionError(f"binary {anchor} {label} "
                                             f"{stage} differs from OS")
                    base = got
    feasibility = [_refuses(
        "binary_mm", lambda spec=spec: binary_mm.binary_mm_df(
            torch.zeros((64, 1024), dtype=torch.int32, device=dev),
            torch.zeros((1024, 64), dtype=torch.int32, device=dev), 32768,
            spec), f"{anchor} M=64 Kp=1024 N=64")
        for anchor, spec in specs.items() if anchor != "os"]
    emit({"check": "binary_mm_all", "bitwise_checks": len(errs),
          "infeasible": len(feasibility)})

    # Timed: the served up projection at prefill M = 511, binarized (the
    # prefill tile; binary_mm's row in the kernels line), the down
    # projection at M = 511 and both at decode M = 4 (the decode tile).
    def operands_timed(m, k, n):
        return (ref.pack_binary(torch.randn((m, k), generator=timed,
                                            device=dev), axis=1),
                ref.pack_binary(torch.randn((k, n), generator=timed,
                                            device=dev), axis=0))

    timed = torch.Generator(device=dev).manual_seed(3)
    max_abs = max(errs)

    def b9_record(label, a, b, k, binarize):
        """The OS launch (a tile) timed beside its plain version,
        torch.matmul on the unpacked +-1 bf16 operands and its bound."""
        m, kp = a.shape
        n = b.shape[1]
        scale = torch.full((1, n), k ** -0.5, device=dev)
        bias = torch.zeros((1, n), device=dev)
        epi = BinaryEpilogue(scale=True, bias=True, binarize=binarize)
        a_pm = ref.unpack_binary(a, axis=1, dtype=torch.bfloat16)
        b_pm = ref.unpack_binary(b, axis=0, dtype=torch.bfloat16)
        # The card's fastest rate for a +-1 product: the binary tensor
        # cores' as measured (2*M*K*N operations, K in bits), or the int8
        # peak on the unpacked values if that is higher, against the
        # packed bytes; the CUDA cores' xor+popc word rate, which the
        # walks run at, is reported beside it.
        moved = (m * kp + kp * n) * 4 + m * n * (1 if binarize else 4) \
            + 2 * n * 4
        bnd = common.bound(moved, 2.0 * m * k * n,
                           max(common.B1_OPS_PER_S, common.INT8_OPS_PER_S))
        popc = common.bound(moved, float(m * kp * n),
                            common.POPC_WORDS_PER_S)
        out = "int8" if binarize else "f32"
        stage = "scale+bias+sign" if binarize else "scale+bias"
        return dict(
            shape=f"{label} M={m} Kp={kp} N={n} {stage} -> {out}",
            tile=binary_mm.plan(specs["os"], m, kp, n).tile_kernel,
            max_abs_err=max_abs,
            ms=timer.ms(lambda: binary_mm.binary_mm_df(
                a, b, k, specs["os"], epilogue=epi, scale=scale, bias=bias)),
            plain_ms=timer.ms(lambda: ref.binary_matmul_fused_ref(
                a, b, k, scale=scale, bias=bias, binarize=binarize)),
            library_ms=timer.ms(lambda: torch.matmul(a_pm, b_pm)),
            library_call="torch.matmul on the unpacked +-1 bf16 operands",
            bound_ms=bnd[0], bound_by=bnd[1],
            rate_for_bound="binary tensor cores, 10285.5 TOP/s (mma.sync "
                           "m16n8k256 .b1 .and.popc as bench/binary_sweep.cu "
                           "measured it; above int8's 1979)",
            popc_bound_ms=popc[0], popc_bound_by=popc[1],
            popc_rate="xor+popc word pairs at 16 popc/SM/clock, 132 SMs, "
                      "1.98 GHz", tolerance="bit for bit",
            walks_ms={anchor: timer.ms(lambda spec=specs[anchor]:
                                       binary_mm.binary_mm_df(
                                           a, b, k, spec, epilogue=epi,
                                           scale=scale, bias=bias))
                      for anchor in ("ws", "is")})

    a, b = operands(511, d, dff)      # drawn from gen, as the checks' are
    up = b9_record("served up", a, b, d, True)
    down = b9_record("served down", *operands_timed(511, dff, d), dff, False)
    up4 = b9_record("decode up", *operands_timed(4, d, dff), d, True)
    # drawn from gen too, in the order the checks have always drawn them,
    # so every later check keeps its inputs
    down4 = b9_record("decode down", *operands(4, dff, d), dff, False)
    for rec in (up, down, up4, down4):
        emit({"kernel_timing_detail": rec["tile"], **rec})
    return {"binary_mm": up, "binary_mm_prefill": dict(up, down=down),
            "binary_mm_decode": dict(up4, down=down4)}


def conv_checks(torch, timer, gen, tol):
    """B8 against its plain version on the ResNet-18 conv body (stride 1
    and 2) and a ragged-channel case: int8 with the fused dequant
    epilogue (scale, bias, relu, residual: exact on both sides) bit for
    bit at every anchor that fits; f32 and bf16 within B1's tolerance,
    every anchor equal to OS bit for bit; infeasible anchors raise."""
    from repro_torch.bench import common
    from repro_torch.bench.conv import ANCHORS, RESNET18
    from repro_torch.core.dataflow import ConvProblem
    from repro_torch.kernels import conv2d_df, ops, ref

    dev = "cuda"

    def operands(n, ih, iw, f, cin, cout, dtype, gen=gen):
        if dtype == torch.int8:
            x = torch.randint(-127, 128, (n, ih, iw, cin), generator=gen,
                              device=dev, dtype=torch.int8)
            w = torch.randint(-127, 128, (f, f, cin, cout), generator=gen,
                              device=dev, dtype=torch.int8)
            return x, w
        x = torch.randn((n, ih, iw, cin), generator=gen, device=dev)
        w = torch.randn((f, f, cin, cout), generator=gen,
                        device=dev) * (f * f * cin) ** -0.5
        return x.to(dtype), w.to(dtype)

    cases = [((1,) + (ih, iw, f, s, cin, cout), f"resnet18 {ih}x{iw}x{cin} "
              f"f{f} s{s} -> {cout}") for ih, iw, f, s, cin, cout, _ in
             RESNET18]
    cases.append(((2, 13, 12, 3, 2, 9, 70), "ragged 2x13x12x9 f3 s2 -> 70"))
    errs, float_errs, feasibility = [], [], []
    for (n, ih, iw, f, s, cin, cout), label in cases:
        conv = ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin,
                           cout=cout, n=n)
        residual = torch.randn((n, conv.oh, conv.ow, cout), generator=gen,
                               device=dev)
        bias = torch.randn((cout,), generator=gen, device=dev)
        for dtype in (torch.int8, torch.bfloat16, torch.float32):
            x, w = operands(n, ih, iw, f, cin, cout, dtype)
            if dtype == torch.int8:
                scale = torch.rand((cout,), generator=gen, device=dev) * 1e-4
                epi = dict(scale=scale, bias=bias, residual=residual,
                           activation="relu")
                runs = {"int8 dequant+bias+relu+res": (
                    lambda spec, out=None: ops.conv2d_fused(
                        x, w, s, spec=spec, out_dtype=out, **epi),
                    ref.conv2d_fused_ref(x, w, s, scale=scale.reshape(1, -1),
                                         bias=bias.reshape(1, -1),
                                         residual=residual,
                                         activation="relu"))}
                if label.startswith(("resnet18 56x56x64 f3 s1", "ragged")):
                    runs["int8 raw int32"] = (
                        lambda spec: ops.conv2d(x, w, s, spec=spec),
                        ref.conv2d_ref(x, w, s))
            else:
                epi = dict(scale=0.5, bias=bias, residual=residual,
                           activation="gelu")
                runs = {f"{dtype} scale+bias+gelu+res": (
                    lambda spec, out=None: ops.conv2d_fused(
                        x, w, s, spec=spec, out_dtype=out, **epi),
                    ref.conv2d_fused_ref(x, w, s,
                                         scale=torch.full((1, 1), 0.5,
                                                          device=dev),
                                         bias=bias.reshape(1, -1),
                                         residual=residual,
                                         activation="gelu"))}
            for what, (call, want) in runs.items():
                base = None
                for anchor, spec in ANCHORS.items():
                    shape = f"{label} {what} {anchor}"
                    try:
                        p = conv2d_df.plan(spec, conv, dtype)
                    except ValueError:
                        feasibility.append(_refuses(
                            "conv2d", lambda: call(spec), shape))
                        continue
                    got = call(spec)
                    if dtype == torch.int8:
                        errs.append(_bitwise(f"conv2d[{anchor}]", got, want,
                                             shape))
                    else:
                        float_errs.append(check(f"conv2d[{anchor}]", got,
                                                want, shape=shape, **tol))
                    if base is not None and not torch.equal(got, base):
                        raise AssertionError(f"conv {shape} differs from "
                                             f"OS ({p.walk})")
                    base = got
                if label.startswith("ragged") and base.is_floating_point():
                    # A bf16 output is the f32 result rounded once.
                    _bitwise("conv2d[os] bf16 out", call(
                        ANCHORS["os"], torch.bfloat16), base.to(
                        torch.bfloat16), f"{label} {what} -> bf16")
    xb, wb = operands(1, 56, 56, 3, 64, 64, torch.bfloat16)
    feasibility.append(_refuses(
        "conv2d", lambda: ops.conv2d(xb, wb, spec=ANCHORS["is"]),
        "resnet18 56x56x64 bf16 is (the image needs 401408 B)"))
    emit({"check": "conv2d_all", "checks": len(errs) + len(float_errs),
          "infeasible": len(feasibility),
          "infeasible_shapes": [f["shape"] for f in feasibility]})

    # Timed: ResNet-18 (56, 3, 1, 64 -> 64) at int8 with the fused dequant,
    # bf16 and f32 beside cuDNN, and each anchor's tensor-core walk.
    ih, f, s, cin, cout = 56, 3, 1, 64, 64
    conv = ConvProblem(ih=ih, iw=ih, fh=f, fw=f, s=s, cin=cin, cout=cout)
    xq, wq = operands(1, ih, ih, f, cin, cout, torch.int8)
    scale = torch.rand((1, cout), generator=gen, device=dev) * 1e-4
    bias = torch.randn((1, cout), generator=gen, device=dev)
    bnd = common.conv_bound(conv, 1, 4, common.INT8_OPS_PER_S)

    def int8_record(anchor):
        spec = ANCHORS[anchor]
        p = conv2d_df.plan(spec, conv, torch.int8)
        return dict(
            shape=f"resnet18 (56,3,1,64->64) int8, fused dequant (scale, "
                  f"bias), f32 out, {anchor.upper()}",
            tile=p.tile_kernel, ctas=p.ctas, split=p.split,
            max_abs_err=max(errs),
            ms=timer.ms(lambda: ops.conv2d_fused(xq, wq, s, scale=scale,
                                                 bias=bias, spec=spec)),
            plain_ms=timer.ms(lambda: ref.conv2d_fused_ref(
                xq, wq, s, scale=scale, bias=bias)),
            library_ms=None, library_call=None,
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=dict(
                int8="bit for bit", float=tol))

    records = {f"conv2d_{a}_i8": int8_record(a) for a in ANCHORS}
    for rec in records.values():
        emit({"kernel_timing_detail": rec["tile"], **rec})

    # operands no check before this slice drew: their own generator, so
    # every check keeps its inputs
    timed = torch.Generator(device=dev).manual_seed(3)

    def float_record(dtype, anchor, n_ih, n_cin, n_cout, err):
        x, w = operands(1, n_ih, n_ih, f, n_cin, n_cout, dtype, timed)
        layer = ConvProblem(ih=n_ih, iw=n_ih, fh=f, fw=f, s=s, cin=n_cin,
                            cout=n_cout)
        spec = ANCHORS[anchor]
        p = conv2d_df.plan(spec, layer, dtype)
        rate = (common.BF16_FLOPS_PER_S if dtype == torch.bfloat16
                else common.F32_FLOPS_PER_S)
        b = common.conv_bound(layer, dtype.itemsize, 4, rate)
        x_nchw = x.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        torch.backends.cudnn.allow_tf32 = False   # f32 in full f32
        return dict(
            shape=f"resnet18 ({n_ih},3,1,{n_cin}->{n_cout}) {dtype} -> f32, "
                  f"{anchor.upper()}",
            tile=p.tile_kernel, ctas=p.ctas, split=p.split, max_abs_err=err,
            ms=timer.ms(lambda: ops.conv2d(x, w, s, spec=spec)),
            plain_ms=timer.ms(lambda: ref.conv2d_ref(x, w, s)),
            library_ms=timer.ms(lambda: torch.nn.functional.conv2d(
                x_nchw, w_lib, stride=s)),
            library_call=f"F.conv2d (cuDNN, {dtype}, channels_last, "
                         f"no TF32)",
            bound_ms=b[0], bound_by=b[1], tolerance=tol)

    err = max(float_errs)
    records["conv2d_os_bf16"] = float_record(torch.bfloat16, "os", ih, cin,
                                             cout, err)
    records["conv2d_ws_bf16"] = float_record(torch.bfloat16, "ws", ih, cin,
                                             cout, err)
    # bf16 IS cannot hold this image (418816 B): the next layer's.
    records["conv2d_is_bf16"] = float_record(torch.bfloat16, "is", 28, 128,
                                             128, err)
    f32 = float_record(torch.float32, "os", ih, cin, cout, err)
    for rec in (records["conv2d_os_bf16"], records["conv2d_ws_bf16"],
                records["conv2d_is_bf16"], f32):
        emit({"kernel_timing_detail": rec["tile"] or "conv2d", **rec})
    records["conv2d"] = dict(records["conv2d_os_i8"], float32=f32)
    return records


def _every_spec(label, call, want, plan_of):
    """``call(spec)`` under each of the nine canonical GEMM specs: a spec
    whose resident operands fit launches the kernel its plan names once
    (and B6 once more when the planes are packed), equals ``want`` bit
    for bit and equals the OS result; one that does not fit raises
    naming its bytes."""
    from repro_torch.bench import common
    from repro_torch.kernels import _build

    base, ran, infeasible, errs, grew = None, [], [], [], {}
    for name, spec in common.NINE_SPECS.items():
        try:
            p = plan_of(spec)
        except ValueError:
            infeasible.append(_refuses(f"gemm[{name}]",
                                       lambda spec=spec: call(spec),
                                       f"{label} {name}")["shape"])
            continue
        before = dict(_build.LAUNCHES)
        got = call(spec)
        grew = {k: _build.LAUNCHES[k] - before[k] for k in before
                if _build.LAUNCHES[k] != before[k]}
        if grew.get(p.kernel) != 1 or (
                p.tile_kernel and grew.get(p.tile_kernel) != 1):
            raise AssertionError(f"{name} at {label} did not launch "
                                 f"{p.kernel} (tile {p.tile_kernel}) once: "
                                 f"{grew}")
        errs.append(_bitwise(f"{p.kernel}[{name}]", got, want, label))
        if base is not None and not got.equal(base):
            raise AssertionError(f"{name} at {label} differs from OS")
        base = got if base is None else base
        ran.append(name)
    emit({"check": "every_spec_bitwise", "shape": label, "ran": ran,
          "infeasible": infeasible})
    return errs, grew


def int8_packed_checks(torch, cfg, timer, gen, tol):
    """int8 operands in B1 (and B4, B5a, B5b) and packed int4/int5 planes
    decoded in them by B6, on the card against their plain versions
    (exact integer sums: float64 on the card), at qwen3-1.7b's MLP shapes
    (M = 4, 16 and 512; K x N = 2048 x 6144 and 6144 x 2048) and a ragged
    shape (K not a multiple of 32): int8 with int32 out and the fused
    dequant, and packed 4- and 5-bit with the dequant, under each of the
    nine canonical specs, bit for bit, every anchor equal to OS (the basic
    launch on B1's integer tensor-core tiles, the others on the integer
    walks), every infeasible spec raising with its bytes; the packed
    gate's silu within B1's tolerance.  Times int8 and packed 4-bit B1 on
    the tiles at M = 4 and 512 beside their plain versions, their bounds
    and ``torch._int_mm`` on the int8 weights (M > 16 only)."""
    from repro_torch.bench import common
    from repro_torch.kernels import _build, matmul_df, ops, pack, ref
    from repro_torch.models import layers

    dev = "cuda"
    d, dff = cfg.d_model, cfg.d_ff
    i8 = torch.int8

    def randint8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=i8)

    # M = 16 (the decode tile's largest M) last, so every earlier shape
    # keeps the inputs it had before it.
    mlp = ((d, dff), (dff, d))
    shapes = [(f"M={m} K={k} N={n}", m, k, n) for m in (4, 512)
              for k, n in mlp]
    shapes.append(("ragged M=37 K=100 N=50", 37, 100, 50))
    shapes += [(f"M=16 K={k} N={n}", 16, k, n) for k, n in mlp]
    errs, packed_launches = [], 0
    for label, m, k, n in shapes:
        aq, bq = randint8(m, k), randint8(k, n)
        a_scale = torch.tensor(0.02, device=dev)
        b_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
        scale = (a_scale * b_scale).reshape(1, n)
        bias = torch.randn((1, n), generator=gen, device=dev)
        residual = torch.randn((m, n), generator=gen, device=dev)
        e, _ = _every_spec(
            f"int8 {label} -> int32",
            lambda spec: ops.matmul(aq, bq, spec=spec),
            ref.matmul_ref(aq, bq),
            lambda spec: matmul_df.plan(spec, m, k, n, i8))
        errs += e
        e, _ = _every_spec(
            f"int8 {label} dequant+bias+residual",
            lambda spec: ops.int8_matmul_fused(aq, bq, a_scale, b_scale,
                                               bias=bias, residual=residual,
                                               spec=spec),
            ref.matmul_fused_ref(aq, bq, scale=scale, bias=bias,
                                 residual=residual),
            lambda spec: matmul_df.plan(spec, m, k, n, i8))
        errs += e
        if label.startswith("ragged"):   # per-row scales, bf16 output
            rows = torch.rand((m, 1), generator=gen, device=dev) * 1e-3
            errs.append(_bitwise(
                "matmul_os int8 per-row dequant -> bf16",
                ops.matmul_fused(aq, bq, scale=rows,
                                 out_dtype=torch.bfloat16),
                ref.matmul_fused_ref(aq, bq, scale=rows,
                                     out_dtype=torch.bfloat16), label))
        for bits in (4, 5):
            pw = layers.draw_packed(gen, k, n, bits, dev)
            r = int((pw.outlier_idx < pw.k_pad).sum())
            e, grew = _every_spec(
                f"packed {bits}-bit {label} (R={r} of "
                f"{pw.outlier_idx.shape[0]}) dequant",
                lambda spec: ops.matmul_packed(aq, pw, a_scale=a_scale,
                                               spec=spec),
                ref.matmul_packed_ref(aq, pw, a_scale=a_scale.reshape(1, 1)),
                lambda spec: matmul_df.plan(spec, m, k, n, i8, bits))
            errs += e
            if grew.get(_build.PACKED_DECODE) != 1:
                raise AssertionError(f"packed {label}: B6 not counted once "
                                     f"per launch: {grew}")
            packed_launches += 1
            want = ref.matmul_packed_ref(
                aq, pw, a_scale=a_scale.reshape(1, 1), bias=bias,
                residual=residual, activation="silu")
            check("matmul_os packed gate", ops.matmul_packed_fused(
                aq, pw, a_scale=a_scale, bias=bias, residual=residual,
                activation="silu"), want, shape=f"{bits}-bit {label} "
                "dequant+bias+silu+residual", **tol)
    emit({"check": "int8_packed_all", "bitwise_checks": len(errs)})

    # Timed on the tiles: int8 and packed 4-bit B1 (B6 decoding into the
    # mma fragments) at both MLP shapes, at a 512-token prefill (the
    # prefill tile) and at decode batch 4 (the decode tile), each with the
    # scale-only dequant -> f32, beside the plain version, the bound and
    # torch._int_mm on the int8 weight (int32 out; it takes M > 16 only).
    a_scale = torch.tensor(0.02, device=dev)
    timed = {}
    for m in (512, 4):
        for k, n in ((dff, d), (d, dff)):
            aq = randint8(m, k)
            pw = layers.draw_packed(gen, k, n, 4, dev)
            q, w_scale = pack.unpack_weights(pw)
            r = int((pw.outlier_idx < pw.k_pad).sum())
            lib_ms = timer.ms(lambda: torch._int_mm(aq, q)) if m > 16 \
                else None
            for kind, fn, plain, wbytes in (
                    ("packed 4-bit",
                     lambda: ops.matmul_packed(aq, pw, a_scale=a_scale,
                                               spec=matmul_df.BASIC_OS),
                     lambda: ref.matmul_packed_ref(
                         aq, pw, a_scale=a_scale.reshape(1, 1)),
                     common.packed_read_bytes(pw)),
                    ("int8", lambda: ops.int8_matmul_fused(
                        aq, q, a_scale, w_scale, spec=matmul_df.BASIC_OS),
                     lambda: ref.matmul_fused_ref(aq, q,
                                                  scale=a_scale * w_scale),
                     k * n)):
                bnd = common.bound(m * k + wbytes + m * n * 4,
                                   2.0 * m * k * n, common.INT8_OPS_PER_S)
                p = matmul_df.plan(matmul_df.BASIC_OS, m, k, n, i8,
                                   4 if kind != "int8" else None)
                rec = dict(
                    shape=f"{kind} {'prefill' if m > 16 else 'decode'} "
                          f"M={m} K={k} N={n} (R={r}), dequant -> f32, "
                          f"{p.tile_kernel}",
                    max_abs_err=max(errs), ms=timer.ms(fn),
                    plain_ms=timer.ms(plain), library_ms=lib_ms,
                    library_call="torch._int_mm on the unpacked int8 "
                                 "weight (int32 out)" if lib_ms else None,
                    bound_ms=bnd[0], bound_by=bnd[1],
                    tolerance="bit for bit")
                emit({"kernel_timing_detail": "matmul_os " + kind, **rec})
                timed[(kind, m, k)] = rec
    # The records: B6 and the prefill tile at the down projection of a
    # 512-token prefill (packed and int8), the decode tile at packed
    # 4-bit decode's down projection (serve_packed's slowest launch).
    return {_build.PACKED_DECODE: dict(timed[("packed 4-bit", 512, dff)],
                                       packed_checks=packed_launches),
            "matmul_os_i8_prefill": timed[("int8", 512, dff)],
            "matmul_os_i8_decode": timed[("packed 4-bit", 4, dff)]}


def packed_conv_checks(torch, timer, gen):
    """B8 with packed 4- and 5-bit filters (B6 decoding each step's
    filter block) on the ResNet-18 conv body and a ragged-channel case,
    against the dequantize-then-conv plain version: bit for bit with the
    dequant and with dequant + bias + relu + residual, every anchor that
    fits equal to OS, every other raising with its bytes."""
    from repro_torch.bench import common
    from repro_torch.bench.conv import ANCHORS, RESNET18
    from repro_torch.core.dataflow import ConvProblem
    from repro_torch.kernels import _build, conv2d_df, ops, pack, ref

    dev = "cuda"
    cases = [((1, ih, iw, f, s, cin, cout), f"resnet18 {ih}x{iw}x{cin} f{f} "
              f"s{s} -> {cout}") for ih, iw, f, s, cin, cout, _ in RESNET18]
    cases.append(((2, 13, 12, 3, 2, 9, 70), "ragged 2x13x12x9 f3 s2 -> 70"))
    checks, infeasible = 0, []
    for (n, ih, iw, f, s, cin, cout), label in cases:
        conv = ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin,
                           cout=cout, n=n)
        xq = torch.randint(-127, 128, (n, ih, iw, cin), generator=gen,
                           device=dev, dtype=torch.int8)
        x_scale = torch.tensor(0.02, device=dev)
        bias = torch.randn((cout,), generator=gen, device=dev)
        residual = torch.randn((n, conv.oh, conv.ow, cout), generator=gen,
                               device=dev)
        for bits in (4, 5):
            w = torch.randn((f, f, cin, cout), generator=gen, device=dev)
            w[0, 1, min(3, cin - 1), :] *= 30.0    # outlier rows
            pcw = pack.pack_conv_weights(w, bits)
            r = pcw.outlier_idx.shape[0]
            runs = {
                "dequant": (lambda spec: ops.conv2d_packed(
                    xq, pcw, s, x_scale=x_scale, spec=spec),
                    ref.conv2d_packed_ref(xq, pcw, s,
                                          x_scale=x_scale.reshape(1, 1))),
                "dequant+bias+relu+res": (
                    lambda spec: ops.conv2d_packed_fused(
                        xq, pcw, s, x_scale=x_scale, bias=bias,
                        residual=residual, activation="relu", spec=spec),
                    ref.conv2d_packed_ref(
                        xq, pcw, s, x_scale=x_scale.reshape(1, 1),
                        bias=bias.reshape(1, -1), residual=residual,
                        activation="relu"))}
            for what, (call, want) in runs.items():
                base = None
                for anchor, spec in ANCHORS.items():
                    shape = f"{label} {bits}-bit (R={r}) {what} {anchor}"
                    try:
                        conv2d_df.plan(spec, conv, torch.int8, bits)
                    except ValueError:
                        infeasible.append(_refuses(
                            "conv2d packed", lambda: call(spec),
                            shape)["shape"])
                        continue
                    before = _build.LAUNCHES[_build.PACKED_DECODE]
                    got = call(spec)
                    if _build.LAUNCHES[_build.PACKED_DECODE] != before + 1:
                        raise AssertionError(f"{shape}: B6 not counted")
                    _bitwise(f"conv2d packed[{anchor}]", got, want, shape)
                    checks += 1
                    if base is not None and not torch.equal(got, base):
                        raise AssertionError(f"packed conv {shape} differs "
                                             f"from OS")
                    base = got
    emit({"check": "conv2d_packed_all", "bitwise_checks": checks,
          "infeasible": infeasible})
    ih, f, s, cin, cout = 56, 3, 1, 64, 64
    conv = ConvProblem(ih=ih, iw=ih, fh=f, fw=f, s=s, cin=cin, cout=cout)
    xq = torch.randint(-127, 128, (1, ih, ih, cin), generator=gen,
                       device=dev, dtype=torch.int8)
    # MSR-coded weights, as the packed MLP draws them: 4-bit codes and
    # two outlier rows at +-127, which set every channel's int8 scale, so
    # the codes pack back exactly and the sidecar holds those two rows.
    q = torch.randint(-8, 8, (f, f, cin, cout), generator=gen, device=dev)
    q[0, 1, 3], q[2, 0, 5] = 127, -127
    pcw = pack.pack_conv_weights(q.float() * 0.01, 4)
    x_scale = torch.tensor(0.02, device=dev)
    moved = (ih * ih * cin + common.packed_read_bytes(pcw)
             + conv.oh * conv.ow * cout * 4)
    bnd = common.bound(moved, 2.0 * conv.oh * conv.ow * f * f * cin * cout,
                       common.INT8_OPS_PER_S)
    p = conv2d_df.plan(ANCHORS["os"], conv, torch.int8, 4)
    rec = {"shape": f"resnet18 (56,3,1,64->64), R={pcw.outlier_idx.shape[0]} "
                    "outlier rows, dequant, f32 out, OS",
           "tile": p.tile_kernel, "ctas": p.ctas, "split": p.split,
           "ms": timer.ms(lambda: ops.conv2d_packed(xq, pcw, s,
                                                    x_scale=x_scale,
                                                    spec=ANCHORS["os"])),
           "plain_ms": timer.ms(lambda: ref.conv2d_packed_ref(xq, pcw, s)),
           "library_ms": None, "bound_ms": bnd[0], "bound_by": bnd[1]}
    emit({"kernel_timing_detail": "conv2d packed 4-bit", **rec})
    return rec


# ---------------------------------------------------------------------------
# Phase 4: the bench twins of the paper's dataflow comparison.
# ---------------------------------------------------------------------------
DATAFLOW_PATH = ("matmul_os", "matmul_os_prefill", "matmul_os_decode",
                 "matmul_os_cluster", "matmul_rmw", "matmul_rmw_cluster",
                 "matmul_ws_stripe", "matmul_ws_stripe_cluster",
                 "matmul_is_stripe", "matmul_is_stripe_cluster",
                 "flash_attention", "kv_stationary", "kv_stationary_cluster")


def dataflows_phase(torch):
    from repro_torch.bench import (attention_anchors, basic_dataflows,
                                   extended_dataflows)
    from repro_torch.kernels import _build

    _build.reset_launches()
    t0 = time.monotonic()
    for bench in (basic_dataflows, extended_dataflows, attention_anchors):
        for row in bench.run("cuda"):
            emit({"phase": "dataflows", **row})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    emit({"phase": "dataflows", "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t0, "launches": launches})
    missing = [k for k in DATAFLOW_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dataflows "
                             f"path: {missing}")
    return {k: launches[k] for k in DATAFLOW_PATH}


# ---------------------------------------------------------------------------
# Phase 5: the bench twins of the quantized datapaths.
# ---------------------------------------------------------------------------
QUANTIZED_PATH = ("conv2d", "conv2d_os_i8", "conv2d_ws_i8", "conv2d_is_i8",
                  "conv2d_os_bf16", "conv2d_ws_bf16", "conv2d_is_bf16",
                  "binary_mm", "binary_mm_prefill", "matmul_os",
                  "unpack_block", "matmul_os_i8_prefill",
                  "matmul_os_i8_decode")


def quantized_phase(torch):
    """The bench twins' rows; the launches of their ``spec=None`` calls
    (Fig. 9's int8, bf16 and binary convs, the packed rows' B1) follow
    the autotuner's picks: every kernel key the picks imply is launched
    at least that often (the benches' pinned specs launch the rest)."""
    from repro_torch.bench import binary, conv, packed
    from repro_torch.kernels import _build, ops

    _build.reset_launches()
    ops.RESOLVED.clear()
    t0 = time.monotonic()
    for bench in (conv, binary, packed):
        for row in bench.run("cuda"):
            emit({"phase": "quantized", **row})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    picks = picks_since()
    implied = implied_launches(picks)
    short = {k: [launches[k], n] for k, n in implied.items()
             if launches[k] < n}
    emit({"phase": "quantized", "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t0, "launches": launches,
          "picks": {f"{type(p).__name__} {dataclasses.astuple(p)}":
                    [spec.name, n] for (p, spec), n in picks.items()},
          "implied_launches": implied})
    if short:
        raise AssertionError(f"quantized: launches below the autotuner's "
                             f"picks (launched, implied): {short}")
    missing = [k for k in QUANTIZED_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the quantized "
                             f"path: {missing}")
    return {k: launches[k] for k in QUANTIZED_PATH}


# ---------------------------------------------------------------------------
# The autotune phase: the explorer's analytical pick against the card.
# ---------------------------------------------------------------------------
# The serve phases' traffic: prompts of these lengths prefilled one at a
# time, decode at the scheduler's batch of 4 over a 1 024-key buffer, and
# serve_recovery's 128-token prefill chunks over it.
SERVE_LENS, SERVE_MAX_LEN, SERVE_BATCH, SERVE_CHUNK = (17, 64, 200, 511), \
    1024, 4, 128
# The analytical pick's measured time over the fastest candidate's, at
# most, on every serve hot problem.
PICK_RATIO = 1.15
# serve_audio: whisper-tiny whole; encoder frames a row (whisper's 30-second
# window after its stride-2 conv), the text context (max_len), the batch's
# prompt length, the long row's prompt length, greedy decode steps.
SERVE_AUDIO = "whisper-tiny"
SERVE_AUDIO_FRAMES, SERVE_AUDIO_MAX_LEN = 1500, 448
SERVE_AUDIO_PROMPT, SERVE_AUDIO_LONG, SERVE_AUDIO_STEPS = 64, 432, 16
SERVE_AUDIO_PATH = ("matmul_os", "matmul_os_prefill", "matmul_os_decode",
                    "flash_attention")


def serve_hot_problems(cfg):
    """(label, problem) of each distinct workload the serve phases hand
    the autotuner for qwen3-1.7b at full width: the MLP GEMMs at bf16,
    packed 4-bit and binary (every prefill length, and decode at batch
    4), the prefill, chunk and slot-decode attention over bf16 and int8
    K/V."""
    from repro_torch.core.dataflow import AttentionProblem
    from repro_torch.models import lm

    out = []
    for tag, mlp in (("bf16", {}),
                     ("packed4", {"packed_weights": True,
                                  "packed_weight_bits": 4}),
                     ("binary", {"binary_mlp": True})):
        c = dataclasses.replace(cfg, **mlp)
        for stage, batch, seq in ([("prefill", 1, n) for n in SERVE_LENS]
                                  + [("decode", SERVE_BATCH, 1)]):
            for p in (lm.hot_gemm_problems(c, batch, seq)
                      + lm.hot_binary_problems(c, batch, seq)):
                out.append((f"{tag} {stage} mlp", p))
    for kvd in ("auto", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kvd)
        if kvd == "auto":
            for n in SERVE_LENS:
                out.append(("attention prefill", lm.hot_attention_problems(
                    c, 1, n, SERVE_MAX_LEN)[0]))
        # the scheduler's slot cache decodes each row at its own index
        dec = lm.hot_attention_problems(c, SERVE_BATCH, 1, SERVE_MAX_LEN,
                                        rows=SERVE_BATCH)[1]
        out.append((f"attention slot decode {kvd}", dec))
        out.append((f"attention chunk {kvd}", dataclasses.replace(
            dec, bh=cfg.n_heads, sq=SERVE_CHUNK, rows=1)))
    return out


def heldout_problems(cfg):
    """(label, problem) of qwen3-1.7b at a second batch and prompt length,
    none of them in the cost model's fit: the MLP GEMMs at bf16, packed
    4-bit and binary for a 1 024-token prompt and decode at batch 16, and
    the attention of that prefill and of the slot-cache decode at batch
    16 over bf16 and int8 K/V."""
    from repro_torch.models import lm

    out = []
    for tag, mlp in (("bf16", {}),
                     ("packed4", {"packed_weights": True,
                                  "packed_weight_bits": 4}),
                     ("binary", {"binary_mlp": True})):
        c = dataclasses.replace(cfg, **mlp)
        for stage, batch, seq in (("prefill", 1, 1024), ("decode", 16, 1)):
            out += [(f"{tag} {stage} mlp", p)
                    for p in (lm.hot_gemm_problems(c, batch, seq)
                              + lm.hot_binary_problems(c, batch, seq))]
    out.append(("attention prefill",
                lm.hot_attention_problems(cfg, 1, 1024)[0]))
    for kvd in ("auto", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kvd)
        out.append((f"attention slot decode {kvd}", lm.hot_attention_problems(
            c, 16, 1, 2048, rows=16)[1]))
    return out


def paper_problems():
    """(label, problem) of the paper's 12-layer grid (bf16 GEMM view),
    qwen3-1.7b's MLP GEMMs of Fig. 2/7 and the conv layers of the
    quantized phase (ResNet-18's int8 body, Fig. 9's VGG layers at int8
    and bf16)."""
    from repro_torch.bench import binary as bench_binary, common
    from repro_torch.bench import conv as bench_conv
    from repro_torch.core.dataflow import ConvProblem, GemmProblem

    out = [(f"grid {layer}", GemmProblem(g.m, g.k, g.n))
           for layer in common.PAPER_LAYERS
           for g in [common.paper_gemm(layer)]]
    out += [("fig2/7 qwen3-1.7b mlp", GemmProblem(m, k, n))
            for m, k, n in common.QWEN_MLP]
    for ih, iw, f, s, cin, cout, _ in bench_conv.RESNET18:
        out.append(("resnet18 int8 conv", ConvProblem(
            ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=cout,
            out_dtype="float32")))
    for ih, iw, f, s, cin, cout in bench_binary.VGG_LAYERS:
        for dt in ("int8", "bfloat16"):
            out.append((f"fig9 {dt} conv", ConvProblem(
                ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=cout,
                in_dtype=dt, out_dtype="int32" if dt == "int8"
                else "float32")))
    return out


def f32_problems():
    """(label, problem) of the serve_f32 phase's smoke configs in float32:
    their MLP GEMMs at each prompt length and at decode batch 4, and the
    prefill, chunk and slot-decode attention over float and int8 K/V."""
    from repro_torch import configs
    from repro_torch.models import lm

    out = []
    for name in SERVE_F32:
        c = configs.get_smoke(name)
        for n in SERVE_F32_LENS:
            out += [(f"{name} f32 prefill mlp", p)
                    for p in lm.hot_gemm_problems(c, 1, n)]
            out.append((f"{name} f32 attention prefill",
                        lm.hot_attention_problems(c, 1, n)[0]))
        out += [(f"{name} f32 decode mlp", p)
                for p in lm.hot_gemm_problems(c, SERVE_BATCH, 1)]
        for kvd in ("auto", "int8"):
            dec = lm.hot_attention_problems(dataclasses.replace(
                c, kv_cache_dtype=kvd), SERVE_BATCH, 1, SERVE_F32_MAX_LEN,
                rows=SERVE_BATCH)[1]
            out.append((f"{name} f32 attention slot decode {kvd}", dec))
            out.append((f"{name} f32 attention chunk {kvd}",
                        dataclasses.replace(dec, bh=c.n_heads,
                                            sq=SERVE_F32_CHUNK, rows=1)))
    return out


def _base_spec(problem, specs):
    """The candidate every other one must equal bit for bit: basic OS
    (the OS anchor for a conv; B2 for attention)."""
    from repro_torch.core.dataflow import OS

    for spec in specs:
        if spec.anchor == OS and not [r for _, r in spec.aux
                                      if r.value != "streamed"]:
            return spec
    return next(s for s in specs if s.anchor == OS)


def _plan_summary(problem, spec) -> dict:
    from repro_torch.core import cost_model
    from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                           ConvProblem, OS)
    from repro_torch.kernels import binary_mm, conv2d_df, matmul_df

    if isinstance(problem, AttentionProblem):
        kvp = cost_model._kv_plan(problem) if spec.anchor != OS else None
        return {"kernel": "flash_attention" if spec.anchor == OS
                else "kv_stationary",
                "cluster": kvp.cluster if kvp else None,
                "ctas": kvp.ctas if kvp else None}
    if isinstance(problem, BinaryProblem):
        p = binary_mm.plan(spec, problem.m, problem.kp, problem.n)
    elif isinstance(problem, ConvProblem):
        p = conv2d_df.plan(spec, problem,
                           cost_model.TORCH_DTYPES[problem.in_dtype],
                           problem.weight_bits)
    else:
        p = matmul_df.plan(spec, problem.m, problem.k, problem.n,
                           cost_model.TORCH_DTYPES[problem.in_dtype],
                           problem.weight_bits)
    return {"kernel": p.kernel, "tile": p.tile_kernel, "ctas": p.ctas,
            "cluster": p.cluster}


# Every problem the autotune phase or a serve measured: problem -> its
# record (the pick's measured time over the fastest candidate's).
MEASURED = {}


def measure_problem(torch, group: str, label: str, problem, hw) -> dict:
    """The explorer's candidates of ``problem`` with their analytical
    estimates, each run on the card, held bit for bit against basic OS
    (B2 for attention) and timed (CUDA events after an L2 flush, median
    of 15); emits the record and keeps it in ``MEASURED``.  Raises if a
    candidate differs from basic OS."""
    from repro_torch.core import explorer

    cands = explorer.explore(problem, hw, top=99)
    specs = [c.spec for c in cands]
    base = _base_spec(problem, specs)
    calls = dict(explorer.candidate_calls(problem, specs, "cuda"))
    want = calls[base]()
    out, differ = [], []
    for c in cands:
        got = calls[c.spec]()
        same = bool(torch.equal(got, want))
        ms = explorer.measure(calls[c.spec], "cuda") * 1e3
        out.append({"spec": c.name, "est_ms": c.est_seconds * 1e3,
                    "ms": ms, "equal_basic_os": same,
                    **_plan_summary(problem, c.spec)})
        if not same:
            differ.append(c.name)
    del calls, want
    fastest = min(out, key=lambda r: r["ms"])
    ranked = sorted(out, key=lambda r: r["ms"])
    pick = out[0]
    rec = {"phase": "autotune", "group": group, "label": label,
           "problem": dataclasses.asdict(problem),
           "kind": type(problem).__name__, "pick": pick["spec"],
           "pick_est_ms": pick["est_ms"], "pick_ms": pick["ms"],
           "fastest": fastest["spec"], "fastest_ms": fastest["ms"],
           "ratio": pick["ms"] / fastest["ms"],
           "pick_measured_rank": ranked.index(pick) + 1, "candidates": out}
    emit(rec)
    MEASURED[problem] = rec
    if differ:
        raise AssertionError(f"{label} {problem}: {differ} != "
                             f"{base.name} bit for bit")
    return rec


def autotune_phase(torch):
    """Each serve hot problem (with whisper-tiny's two frontend convs,
    bf16 at batch 4 over 1 500 encoder frames), serve_f32's problems and
    the paper's problems through ``measure_problem``; gates that every candidate
    equals basic OS, that the autotuner serves the explorer's fresh pick
    of every serve and f32 problem, and that there the pick's time is
    within ``PICK_RATIO`` of the fastest candidate's.  The paper's
    problems' agreement and that of problems held out of the cost
    model's fit (``heldout_problems``) are reported."""
    from repro_torch import configs
    from repro_torch.core import autotune, cost_model
    from repro_torch.kernels import _build
    from repro_torch.models import lm

    cfg = configs.get("qwen3-1.7b")
    hw = cost_model.hardware_for("cuda")
    t0 = time.monotonic()
    emit({"phase": "autotune", "event": "hardware", "name": hw.name,
          "sms": hw.sms, "smem_block": hw.smem_block,
          "l2_bytes": hw.l2_bytes, "card": card_line(),
          "model": cost_model.model_digest(),
          "store": autotune.cache_path()})
    misses = []
    summary = {"serve": [], "paper": [], "f32": [], "held-out": []}
    rows = [("serve", label, p) for label, p in serve_hot_problems(cfg)] + \
        [("serve", "whisper frontend conv", p) for p in lm.hot_conv_problems(
            configs.get(SERVE_AUDIO), SERVE_BATCH, SERVE_AUDIO_FRAMES)] + \
        [("paper", label, p) for label, p in paper_problems()] + \
        [("f32", label, p) for label, p in dict.fromkeys(f32_problems())] + \
        [("held-out", label, p) for label, p in heldout_problems(cfg)]
    for group, label, problem in rows:
        try:
            rec = measure_problem(torch, group, label, problem, hw)
        except AssertionError as e:
            misses.append(str(e))
            continue
        summary[group].append(rec["ratio"])
        if group in ("paper", "held-out"):
            continue
        served = autotune.best_spec(problem, hw).name
        if served != rec["pick"]:
            misses.append(f"{label} {problem}: the autotuner serves "
                          f"{served}, the explorer picks {rec['pick']}")
        if rec["ratio"] > PICK_RATIO:
            misses.append(f"{label} {problem}: the pick {rec['pick']} "
                          f"{rec['pick_ms']:.4f} ms is {rec['ratio']:.3f}x "
                          f"the fastest {rec['fastest']} "
                          f"{rec['fastest_ms']:.4f}")
    torch.cuda.synchronize()
    emit({"phase": "autotune", "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t0,
          "agreement": _agreement(summary),
          "launches": {k: v for k, v in _build.LAUNCHES.items() if v}})
    if misses:
        raise AssertionError("autotune: " + "; ".join(misses))


def _agreement(summary) -> dict:
    return {g: {"problems": len(r), "pick_is_fastest": sum(
        x <= 1.0 for x in r), "within_ratio": sum(x <= PICK_RATIO for x in r),
        "worst_ratio": max(r)} for g, r in summary.items() if r}


def launch_keys(problem, spec):
    """The ``_build.LAUNCHES`` keys one op call adds one to when it runs
    ``spec`` on ``problem``: the kernel, the tile or walk it reports, B6
    for packed weights, the int8 K/V path's count."""
    from repro_torch.core import cost_model
    from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                           ConvProblem, OS)
    from repro_torch.kernels import _build, binary_mm, conv2d_df, matmul_df

    if isinstance(problem, AttentionProblem):
        bf16 = problem.dtype == "bfloat16"
        i8 = problem.kv_quantized
        if spec.anchor == OS:
            return ["flash_attention"] + (
                [] if not i8 else ["flash_attention_i8kv" if bf16
                                   else "flash_attention_f32_i8kv"])
        return ["kv_stationary"] + (["kv_stationary_cluster"] if bf16
                                    else []) + (
            [] if not i8 else ["kv_stationary_cluster_i8kv" if bf16
                               else "kv_stationary_f32_i8kv"])
    dtype = cost_model.TORCH_DTYPES.get(getattr(problem, "in_dtype", ""))
    if isinstance(problem, BinaryProblem):
        p = binary_mm.plan(spec, problem.m, problem.kp, problem.n)
    elif isinstance(problem, ConvProblem):
        p = conv2d_df.plan(spec, problem, dtype, problem.weight_bits)
    else:
        p = matmul_df.plan(spec, problem.m, problem.k, problem.n, dtype,
                           problem.weight_bits)
    return [p.kernel] + ([p.tile_kernel] if p.tile_kernel else []) + (
        [_build.PACKED_DECODE] if getattr(problem, "weight_bits", None)
        else [])


def picks_since(since=None):
    """The op calls the autotuner resolved on the card since the snapshot
    ``since`` of ``ops.RESOLVED``: {(problem, spec): calls}."""
    from repro_torch.core import autotune, cost_model
    from repro_torch.kernels import ops

    since = since or {}
    hw = cost_model.hardware_for("cuda")
    return {(p, autotune.best_spec(p, hw)): n - since.get(p, 0)
            for p, n in ops.RESOLVED.items() if n > since.get(p, 0)}


def implied_launches(picks):
    """The launches of each kernel key the picked plans imply."""
    out = {}
    for (problem, spec), n in picks.items():
        for key in launch_keys(problem, spec):
            out[key] = out.get(key, 0) + n
    return out


def _picks_gate(phase: str, launches, picks, group: str = "served") -> dict:
    """Each kernel's launches equal what the autotuner's picks imply
    (B3, which is not autotuned, aside), and each pick is the explorer's
    fresh ranking's first, or raise.  Each picked problem the autotune
    phase did not measure (and gate) is measured (``measure_problem``,
    under ``group``) and its agreement reported.  Returns the launches
    the picks imply."""
    import torch

    from repro_torch.core import cost_model, explorer

    hw = cost_model.hardware_for("cuda")
    implied = implied_launches(picks)
    keys = sorted((set(implied) | {k for k, v in launches.items() if v})
                  - {"paged_attention", "paged_attention_g16"})
    off = {k: [launches.get(k, 0), implied.get(k, 0)] for k in keys
           if launches.get(k, 0) != implied.get(k, 0)}
    by_kernel, stale, new = {}, [], []
    for (problem, spec), n in picks.items():
        name = f"{type(problem).__name__} {spec.name}"
        by_kernel[name] = by_kernel.get(name, 0) + n
        if explorer.explore(problem, hw, top=1)[0].spec != spec:
            stale.append(f"{problem}: {spec.name}")
        if problem not in MEASURED:
            new.append(measure_problem(torch, group, phase, problem,
                                       hw)["ratio"])
    emit({"phase": phase, "event": "picks", "calls_by_pick": by_kernel,
          "implied_launches": implied, "off": off, "problems": len(picks),
          "worst_ratio": max((MEASURED[p]["ratio"] for p, _ in picks),
                             default=None),
          group: _agreement({group: new}).get(group)})
    if off or stale:
        raise AssertionError(
            f"{phase}: launches off the autotuner's picks (launched, "
            f"implied): {off}; picks not the explorer's: {stale}")
    return implied


# ---------------------------------------------------------------------------
# Phases 6 and 7: serve full-width qwen3-1.7b, dense and binary MLP.
# ---------------------------------------------------------------------------
def _cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


SERVE_PATH = ("matmul_os", "matmul_os_prefill", "matmul_os_decode",
              "flash_attention", "paged_attention")
SERVE_BINARY_PATH = ("binary_mm", "binary_mm_prefill", "binary_mm_decode",
                     "flash_attention", "paged_attention")
SERVE_PACKED_PATH = ("unpack_block", "matmul_os", "matmul_os_i8_prefill",
                     "matmul_os_i8_decode", "flash_attention",
                     "paged_attention")
# The basic OS tiles of each serving path's MLP GEMMs (B1's, or B9's on
# the binary MLP: their only launches there), by the event that reports
# them: every launch of the library there takes one of them.
SERVE_TILES = {"serve": ("b1_tiles", "matmul_os", "matmul_os_prefill",
                         "matmul_os_decode"),
               "serve_binary": ("b9_tiles", "binary_mm", "binary_mm_prefill",
                                "binary_mm_decode"),
               "serve_packed": ("b1_tiles", "matmul_os",
                                "matmul_os_i8_prefill",
                                "matmul_os_i8_decode"),
               "serve_int8kv": ("b1_tiles", "matmul_os", "matmul_os_prefill",
                                "matmul_os_decode"),
               "serve_dense": ("b1_tiles", "matmul_os", "matmul_os_prefill",
                               "matmul_os_decode"),
               "serve_moe": ("b1_tiles", "matmul_os", "matmul_os_prefill",
                             "matmul_os_decode"),
               "serve_ssm": ("b1_tiles", "matmul_os", "matmul_os_prefill",
                             "matmul_os_decode"),
               "serve_audio": ("b1_tiles", "matmul_os", "matmul_os_prefill",
                               "matmul_os_decode")}


def _mlp_inputs(cfg, params, toks, max_len):
    """(params, input) of each MLP call of a two-layer prefill on the
    kernels."""
    from repro_torch.models import layers, lm

    sub = dataclasses.replace(cfg, n_layers=2)
    sub_params = dict(params, layers=_map(lambda t: t[:2], params["layers"]))
    seen = []
    plain_mlp = layers.mlp_apply

    def recording(p, x, cfg=None):
        seen.append((p, x))
        return plain_mlp(p, x, cfg)

    layers.mlp_apply = recording
    try:
        lm.prefill(sub_params, toks, sub, max_len=max_len)
    finally:
        layers.mlp_apply = plain_mlp
    if len(seen) != 2:
        raise AssertionError(f"recorded {len(seen)} MLP calls, want 2")
    return seen


def packed_mlp_bitwise(cfg, params, toks, max_len, phase, tol):
    """At every layer of a two-layer prefill on the kernels, the packed
    MLP's input is recorded and quantized to int8 as ``packed_mlp_apply``
    does; on those int8 inputs each projection on the kernels (B1 with
    B6) is held against its plain version: ``up`` and ``down`` (scale-only
    epilogues) bit for bit, ``gate`` (silu fused) within B1's
    tolerance."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops

    for i, (p, x) in enumerate(_mlp_inputs(cfg, params, toks, max_len)):
        xq, xs = quant.symmetric_int8(x.reshape(-1, x.shape[-1]))
        shape = f"layer {i} M={xq.shape[0]} d={xq.shape[1]}"
        gate = ops.matmul_packed_fused(xq, p["w1"], a_scale=xs,
                                       activation="silu")
        check(f"{phase} packed_mlp gate (silu)", gate,
              ops.matmul_packed_fused(xq, p["w1"], a_scale=xs,
                                      activation="silu", backend="torch"),
              shape=shape, **tol)
        up = ops.matmul_packed(xq, p["w3"], a_scale=xs)
        _bitwise(f"{phase} packed_mlp up", up, ops.matmul_packed(
            xq, p["w3"], a_scale=xs, backend="torch"), shape)
        hq, hs = quant.symmetric_int8(gate * up)
        _bitwise(f"{phase} packed_mlp down", ops.matmul_packed(
            hq, p["w2"], a_scale=hs), ops.matmul_packed(
            hq, p["w2"], a_scale=hs, backend="torch"), shape)


def binary_mlp_bitwise(cfg, params, toks, max_len, phase):
    """At every layer of a two-layer prefill on the kernels, the binary
    MLP's input is recorded, and the MLP on the kernels (B9) must equal
    its plain version on that input bit for bit: the hidden +-1 int8
    activations and the float output."""
    from repro_torch.models import layers

    for i, (p, x) in enumerate(_mlp_inputs(cfg, params, toks, max_len)):
        hidden = layers.binary_dense(p["up"], x)
        out = layers.binary_mlp_apply(p, x)
        with layers.forced_backend("torch"):
            hidden_plain = layers.binary_dense(p["up"], x)
            out_plain = layers.binary_mlp_apply(p, x)
        shape = f"layer {i} M={x.shape[0] * x.shape[1]} d={x.shape[-1]}"
        _bitwise(f"{phase} binary_mlp hidden (int8)", hidden, hidden_plain,
                 shape)
        _bitwise(f"{phase} binary_mlp out (f32)", out, out_plain, shape)


def serve_path(torch, cfg, args, phase, path):
    """Serve ``cfg`` (full width, random weights from ``--seed``) through
    ``Engine``: the gates of the ``serve`` phase, then throughput and the
    decode trace; returns the launches of ``path``'s kernels."""
    import numpy as np

    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import Engine, RequestState

    max_len, new_tokens, lens = SERVE_MAX_LEN, 16, SERVE_LENS
    t0 = time.monotonic()
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": phase, "event": "init_model", "layers": cfg.n_layers,
          "d_model": cfg.d_model, "binary_mlp": cfg.binary_mlp,
          "packed_weights": cfg.packed_weights,
          "packed_weight_bits": cfg.packed_weight_bits,
          "params_gib": sum(t.numel() * t.element_size()
                            for t in _leaves(params)) / 2 ** 30,
          "seconds": time.monotonic() - t0})
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    toks = torch.as_tensor(prompts[0][None], device="cuda")
    if cfg.binary_mlp:
        binary_mlp_bitwise(cfg, params, toks, max_len, phase)
    if cfg.packed_weights:
        packed_mlp_bitwise(cfg, params, toks, max_len, phase, B1_TOL)

    # The model on the kernels against its plain PyTorch path on a small
    # input (a 17-token prompt), at full width and two layers: bf16 rounds
    # at other places in the two paths, and random weights amplify that
    # with depth, so the check is a cosine >= 0.999 of the logits at two
    # layers; the full depth's cosine is reported beside it.
    for depth in (2, cfg.n_layers):
        sub = dataclasses.replace(cfg, n_layers=depth)
        sub_params = dict(params, layers=_map(lambda t: t[:depth],
                                              params["layers"]))
        logits_k, _ = lm.prefill(sub_params, toks, sub, max_len=max_len)
        with layers.forced_backend("torch"):
            logits_p, _ = lm.prefill(sub_params, toks, sub, max_len=max_len)
        cos = _cosine(logits_k, logits_p)
        finite = bool(torch.isfinite(logits_k).all())
        emit({"phase": phase, "event": "prefill_vs_plain", "layers": depth,
              "shape": list(logits_k.shape), "finite": finite, "cosine": cos,
              "max_abs_err": max_err(logits_k, logits_p),
              "argmax_equal": int(logits_k.argmax()) == int(
                  logits_p.argmax())})
        if not finite or tuple(logits_k.shape) != (1, cfg.padded_vocab) \
                or (depth == 2 and cos < 0.999):
            raise AssertionError(f"{depth}-layer prefill logits disagree "
                                 f"with the plain path (cosine {cos})")

    # The main path: counts zeroed just before, read just after.
    _build.reset_launches()
    ops.RESOLVED.clear()
    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(_build.LAUNCHES)
    implied = _picks_gate(phase, launches, picks_since())
    path = tuple(dict.fromkeys(path + tuple(k for k, v in implied.items()
                                            if v)))
    stats = eng.stats()
    bad = [(r.rid, r.state.value, r.error) for r in reqs
           if r.state != RequestState.DONE]
    step_ms = sorted(rec.seconds * 1e3 for rec in eng.monitor.records)
    emit({"phase": phase, "event": "drain", "prompt_lens": list(lens),
          "new_tokens": new_tokens, "wall_s": wall,
          "decode_steps": len(step_ms),
          "decode_ms_per_step_median": step_ms[len(step_ms) // 2],
          "demotions": stats["demotions"],
          "degraded_steps": stats["degraded_steps"],
          "not_done": bad, "launches": launches,
          "tokens": [r.out_tokens for r in reqs]})
    if bad or stats["demotions"] or stats["degraded_steps"]:
        raise AssertionError(f"serve run unhealthy: {bad}, {stats}")
    missing = [k for k in path if launches[k] <= 0
               and (k == "paged_attention" or implied.get(k))]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if phase in SERVE_TILES:
        _tiles_gate(phase, launches)

    # Mixed-length batch == each request served alone.  The packed MLP
    # quantizes its activations per tensor over the whole decode batch
    # (as the reference's does: ROADMAP C), so there a request's tokens
    # depend on the other rows: the tokens that differ are counted, not
    # gated.
    differ = 0
    for p, r in zip(prompts, reqs):
        alone = Engine(cfg, params, max_len=max_len, device="cuda")
        h = alone.submit(p, new_tokens)
        alone.drain()
        if h.state != RequestState.DONE:
            raise AssertionError(f"prompt of {len(p)} alone: {h.state}")
        differ += sum(a != b for a, b in zip(h.out_tokens, r.out_tokens))
        if not cfg.packed_weights and h.out_tokens != r.out_tokens:
            raise AssertionError(
                f"prompt of {len(p)}: alone {h.out_tokens} != batched "
                f"{r.out_tokens}")
    emit({"phase": phase, "event": "mixed_vs_sequential",
          "tokens_differing": differ,
          "gated": not cfg.packed_weights, "ok": True})
    if phase == "serve":
        serve_page128(torch, cfg, params, prompts, new_tokens, max_len)

    # Prefill throughput: the longest prompt, whole, by CUDA events.
    toks = torch.as_tensor(prompts[-1][None], device="cuda")
    lm.prefill(params, toks, cfg, max_len=max_len)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lm.prefill(params, toks, cfg, max_len=max_len)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    emit({"phase": phase, "event": "throughput", "card": card_line(),
          "prefill_tokens": len(prompts[-1]), "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": len(prompts[-1]) / prefill_ms * 1e3,
          "decode_batch": len(prompts),
          "decode_ms_per_step": step_ms[len(step_ms) // 2]})
    trace_prefill(torch, cfg, params, prompts[-1], max_len, phase)
    trace_decode(torch, cfg, params, prompts, max_len, phase)
    return {k: launches[k] for k in path}


# The page size and depth of the serve phase's page-size engine: pages over
# 32 keys, which B3 refused before its tiles became 32-key slices.
SERVE_BIG_PAGE, SERVE_BIG_PAGE_LAYERS = 128, 4


def serve_page128(torch, cfg, params, prompts, new_tokens, max_len):
    """The serve phase's prompts through ``Engine`` at ``SERVE_BIG_PAGE``
    keys a page, qwen3-1.7b at full width and ``SERVE_BIG_PAGE_LAYERS``
    layers: every request DONE with 0 demotions, B3 launched, the mixed
    batch == each request alone (gates); its tokens against the same
    depth's page-16 engine counted, not gated (B3 folds each row's keys
    in tiles cut by the page, so the summation order follows it)."""
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import SchedulerConfig

    phase, depth = "serve", SERVE_BIG_PAGE_LAYERS
    sub = dataclasses.replace(cfg, n_layers=depth)
    sub_params = dict(params, layers=_map(lambda t: t[:depth],
                                          params["layers"]))

    def drain(page, batch):
        eng = Engine(sub, sub_params, max_len=max_len, device="cuda",
                     scheduler_config=SchedulerConfig(page_size=page))
        reqs = [eng.submit(p, new_tokens) for p in batch]
        before = _build.LAUNCHES["paged_attention"]
        eng.drain()
        _healthy(phase, f"page {page}", reqs, eng)
        return ([list(r.out_tokens) for r in reqs], eng,
                _build.LAUNCHES["paged_attention"] - before)

    big, eng, b3 = drain(SERVE_BIG_PAGE, prompts)
    pages = eng.scheduler_report()["pages"]
    alone = [drain(SERVE_BIG_PAGE, [p])[0][0] for p in prompts]
    small, _, _ = drain(16, prompts)
    first = next(((i, j) for i, (x, y) in enumerate(zip(big, alone))
                  for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
    emit({"phase": phase, "event": "page_size", "page_size": SERVE_BIG_PAGE,
          "layers": depth, "prompt_lens": [len(p) for p in prompts],
          "b3_launches": b3, "pages": pages,
          "decode_ms_per_step_median": _step_ms(eng),
          "mixed_equals_alone": first is None,
          "tokens_differing_from_page16": sum(
              a != b for x, y in zip(big, small) for a, b in zip(x, y)),
          "tokens": big})
    if first is not None or not b3:
        raise AssertionError(f"page {SERVE_BIG_PAGE}: mixed batch differs "
                             f"from alone at {first}, or B3 launched {b3}")


# ---------------------------------------------------------------------------
# Phase 9: the serving invariants — chunked prefill, pool pressure, the
# slot-cache serve() and crash recovery.
# ---------------------------------------------------------------------------
# The crash drills: full width at 2 layers, one process killed by the
# fault plan, a second restoring and finishing; each within DRILL_TIMEOUT.
DRILL_LAYERS, DRILL_TIMEOUT = 2, 180
# Timed repeats of each 511-token prefill, whole and chunked.
PREFILL_REPEATS = 7
DRILLS = {
    # (a) a ragged continuous drain, killed in its decode loop
    "ragged": dict(lens=[17, 64, 200, 511], new_tokens=8,
                   plan="serve.decode_step:3:kill", warm=False),
    # (b) the batch-synchronous loop with snapshots every 2 steps, killed
    # at step 3, after the step-2 snapshot
    "batch": dict(lens=[64, 64, 64, 64], new_tokens=6, snapshot_every=2,
                  plan="serve.decode_step:2:kill", warm=True),
}


def _healthy(phase: str, event: str, reqs, eng) -> None:
    from repro_torch.serve.engine import RequestState

    stats = eng.stats()
    bad = [(r.rid, r.state.value, r.error) for r in reqs
           if r.state != RequestState.DONE]
    if bad or stats["demotions"] or stats["degraded_steps"] \
            or stats["failed"] or stats["replay_divergence"]:
        raise AssertionError(f"{phase} {event}: {bad}, {stats}")


def _step_ms(eng) -> float:
    ms = sorted(rec.seconds * 1e3 for rec in eng.monitor.records)
    return ms[len(ms) // 2]


def _prompts(cfg, seed: int, lens):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def drill_main(mode: str, jdir: str, out: str, case_json: str) -> int:
    """One process of a crash drill (``chip_smoke.py --drill``): serve the
    case's prompts with a journal (``mode`` "run"), or restore and finish
    them ("resume"); the result goes to ``out`` as JSON.  A kill fault in
    ``REPRO_FAULT_PLAN`` ends the run process with SIGKILL."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    case = json.loads(case_json)
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"),
                              n_layers=DRILL_LAYERS)
    params = lm.init_model(cfg, seed=case["seed"], device="cuda")
    eng = Engine(cfg, params, max_len=1024, device="cuda", journal_dir=jdir,
                 snapshot_every=case.get("snapshot_every"))
    if mode == "resume":
        reqs = eng.restore()
        eng.serve(reqs)
    else:
        reqs = [eng.submit(p, case["new_tokens"])
                for p in _prompts(cfg, case["seed"], case["lens"])]
        eng.serve(reqs)
    torch.cuda.synchronize()
    stats = eng.stats()
    with open(out, "w") as f:
        json.dump({"tokens": {str(r.rid): r.out_tokens for r in reqs},
                   "states": {str(r.rid): r.state.value for r in reqs},
                   "stats": {k: v for k, v in stats.items()
                             if isinstance(v, int)},
                   "snapshots": stats.get("snapshots"),
                   "restores": [e.detail for e in
                                eng.monitor.events_of("restore")],
                   "launches": {k: v for k, v in _build.LAUNCHES.items()
                                if v}}, f)
    return 0


def crash_drill(name: str, case: dict, seed: int, workdir: str):
    """Drill ``name``: the uninterrupted run in this process, then a
    process killed by ``case["plan"]`` and a process that restores and
    finishes; its tokens must be the uninterrupted run's, every
    journaled request recovered once, none FAILED, no replay
    divergence."""
    import subprocess

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.journal import RequestJournal

    cfg = dataclasses.replace(configs.get("qwen3-1.7b"),
                              n_layers=DRILL_LAYERS)
    case = dict(case, seed=seed)
    params = lm.init_model(cfg, seed=seed, device="cuda")
    eng = Engine(cfg, params, max_len=1024, device="cuda")
    reqs = [eng.submit(p, case["new_tokens"])
            for p in _prompts(cfg, seed, case["lens"])]
    eng.serve(reqs)
    _healthy("serve_recovery", f"drill {name} baseline", reqs, eng)
    base = {str(r.rid): r.out_tokens for r in reqs}
    del eng, params
    jdir = os.path.join(workdir, name)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_JOURNAL_DIR", None)
    env.pop("REPRO_SNAPSHOT_EVERY", None)
    runs = {}
    for mode, plan in (("run", case["plan"]), ("resume", None)):
        out = os.path.join(workdir, f"{name}_{mode}.json")
        env.pop("REPRO_FAULT_PLAN", None)
        if plan:
            env["REPRO_FAULT_PLAN"] = plan
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--drill", mode,
             jdir, out, json.dumps(case)], env=env, cwd=ROOT,
            timeout=DRILL_TIMEOUT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        runs[mode] = (proc, out, time.monotonic() - t0)
    killed, _, kill_s = runs["run"]
    if killed.returncode != -9 or os.path.exists(runs["run"][1]):
        raise AssertionError(f"drill {name}: the run was not killed "
                             f"(rc {killed.returncode}): "
                             f"{killed.stderr.decode()[-2000:]}")
    owed = sorted(r["rid"] for r in RequestJournal(jdir).scan()
                  if r["kind"] == "submit")
    proc, out, resume_s = runs["resume"]
    if proc.returncode != 0:
        raise AssertionError(f"drill {name}: resume failed (rc "
                             f"{proc.returncode}): "
                             f"{proc.stderr.decode()[-2000:]}")
    with open(out) as f:
        result = json.load(f)
    got = {int(rid): toks for rid, toks in result["tokens"].items()}
    restore = result["restores"][-1] if result["restores"] else ""
    ok = (sorted(got) == owed == sorted(int(r) for r in base)
          and all(result["states"][str(r)] == "done" for r in owed)
          and all(got[r] == base[str(r)] for r in owed)
          and result["stats"]["failed"] == 0
          and result["stats"]["replay_divergence"] == 0
          and ("warm resume" if case["warm"] else "cold resume") in restore)
    emit({"phase": "serve_recovery", "event": f"drill_{name}",
          "layers": DRILL_LAYERS, "prompt_lens": case["lens"],
          "new_tokens": case["new_tokens"], "plan": case["plan"],
          "killed_rc": killed.returncode, "owed": owed, "restore": restore,
          "recovered": result["stats"]["recovered"],
          "replayed_steps": result["stats"]["replayed_steps"],
          "snapshots_saved_after_restore": result["stats"][
              "snapshots_saved"],
          "snapshots": result["snapshots"],
          "kill_run_s": kill_s, "resume_run_s": resume_s,
          "resume_launches": result["launches"], "ok": ok})
    if not ok:
        raise AssertionError(f"drill {name}: recovered {result} against "
                             f"the uninterrupted {base}")


def serve_recovery_phase(torch, cfg, args):
    """Full-width qwen3-1.7b (random weights from ``--seed``, depth
    ``--layers``) through ``Engine`` in the modes the serving loop adds,
    each gated: chunked prefill against whole prompts, the pressure
    ladder against an unconstrained pool, the batch-synchronous
    ``serve()`` on the slot cache, and two crash drills in subprocesses.
    Returns the launches of the path's kernels over the in-process
    serving (the drills run in their own processes)."""
    import shutil
    import tempfile

    from repro_torch.kernels import _build, ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import SchedulerConfig

    phase, max_len = "serve_recovery", 1024
    t_phase = time.monotonic()
    params = lm.init_model(cfg, seed=args.seed, device="cuda")

    def drain(prompts, new_tokens, event, **sc):
        eng = Engine(cfg, params, max_len=max_len, device="cuda",
                     scheduler_config=SchedulerConfig(**sc) if sc else None)
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng.drain()
        torch.cuda.synchronize()
        _healthy(phase, event, reqs, eng)
        return [r.out_tokens for r in reqs], eng, time.monotonic() - t0

    def launched(since):
        """The path's launches since the counts ``since``."""
        return {k: _build.LAUNCHES[k] - since.get(k, 0)
                for k in SERVE_PATH}

    # The main path: counts zeroed just before, read just after.
    _build.reset_launches()
    ops.RESOLVED.clear()
    # Chunked prefill: every prompt longer than a chunk streams through
    # lm.prefill_chunk 128 tokens a step (B2 at Sq = 128 over the filled
    # cache), interleaved with decode.
    chunk_lens = (17, 64, 200, 511)
    chunk_prompts = _prompts(cfg, args.seed, chunk_lens)
    whole, _, whole_s = drain(chunk_prompts, 16, "whole")
    chunked, _, chunked_s = drain(chunk_prompts, 16, "chunked",
                                  prefill_chunk=128)
    launches_drains = launched({})
    differ = sum(a != b for w, c in zip(whole, chunked)
                 for a, b in zip(w, c))
    if differ:
        raise AssertionError(f"chunked prefill tokens {chunked} != whole "
                             f"prompt tokens {whole}")

    # Pool pressure: reaches of 11 + 12 + 8 + 13 = 44 pages in a pool of
    # 24 (each within it): admission defers, decode growth spills and
    # preempts, and the tokens stay those of an unconstrained pool.
    lens = (100, 120, 60, 140)
    prompts = _prompts(cfg, args.seed + 1, lens)
    sc = dict(max_batch=4, page_size=16)
    since = dict(_build.LAUNCHES)
    free, _, free_s = drain(prompts, 64, "pressure_unconstrained", **sc)
    tight, eng, tight_s = drain(prompts, 64, "pressure", n_pages=24, **sc)
    stats = eng.stats()
    ladder = {k: stats[k] for k in ("spills", "spilled_pages", "unspills",
                                    "preemptions", "backpressure",
                                    "replay_divergence", "failed")}
    emit({"phase": phase, "event": "pool_pressure", "prompt_lens": list(lens),
          "new_tokens": 64, "n_pages": 24, "page_size": 16,
          "reach_pages": [-(-(n + 64) // 16) for n in lens], **ladder,
          "tokens_equal": tight == free,
          "decode_ms_per_step_median": _step_ms(eng),
          "drain_s": {"unconstrained": free_s, "n_pages=24": tight_s},
          "launches": launched(since)})
    if tight != free or not ladder["spills"] + ladder["preemptions"]:
        raise AssertionError(f"pressure run: tokens equal {tight == free}, "
                             f"ladder {ladder}")

    # The batch-synchronous serve() on the slot cache (B2 at Sq = 1)
    # beside the paged drain of the same requests (B3).
    prompts = _prompts(cfg, args.seed + 2, (64, 64, 64, 64))
    paged, peng, _ = drain(prompts, 16, "paged_drain")
    since = dict(_build.LAUNCHES)
    seng = Engine(cfg, params, max_len=max_len, device="cuda")
    reqs = [seng.submit(p, 16) for p in prompts]
    seng.serve(reqs)
    torch.cuda.synchronize()
    _healthy(phase, "slot_serve", reqs, seng)
    slot = [r.out_tokens for r in reqs]
    emit({"phase": phase, "event": "slot_cache_serve",
          "prompt_lens": [64] * 4, "new_tokens": 16,
          "scheduler_ran": seng.scheduler_report() is not None,
          "tokens_differing_from_paged": sum(
              a != b for s, p in zip(slot, paged) for a, b in zip(s, p)),
          "decode_ms_per_step_median": {"slot_serve": _step_ms(seng),
                                        "paged_drain": _step_ms(peng)},
          "launches_slot_serve": launched(since)})
    launches = dict(_build.LAUNCHES)
    implied = _picks_gate(phase, launches, picks_since())
    path = tuple(dict.fromkeys(SERVE_PATH + tuple(
        k for k, v in implied.items() if v)))
    missing = [k for k in path if launches[k] <= 0
               and (k == "paged_attention" or implied.get(k))]
    emit({"phase": phase, "event": "launches", "launches": launches,
          "missing": missing})
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # Off the main path (after its counts were read): the 511-token prompt
    # prefilled whole and in chunks of 128 outside Engine, for the first
    # token's logits and the time of each, repeats alternating.
    toks = torch.as_tensor(chunk_prompts[-1][None], device="cuda")

    def whole_prefill():
        return lm.prefill(params, toks, cfg, max_len=max_len)[0]

    def chunked_prefill():
        cache = lm.init_cache(cfg, 1, max_len, cfg.act_dtype, "cuda")
        for pos in range(0, toks.shape[1], 128):
            logits, cache = lm.prefill_chunk(params, cache,
                                             toks[:, pos:pos + 128], cfg,
                                             pos)
        return logits

    fns = {"whole": whole_prefill, "chunked": chunked_prefill}
    first = {name: fn() for name, fn in fns.items()}
    prefill_ms = {name: [] for name in fns}
    for _ in range(PREFILL_REPEATS):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            prefill_ms[name].append(start.elapsed_time(end))
    emit({"phase": phase, "event": "chunked_prefill", "card": card_line(),
          "prompt_lens": list(chunk_lens), "new_tokens": 16,
          "prefill_chunk": 128,
          "tokens_differing": differ,
          "first_token_max_abs_logit_diff": max_err(first["chunked"],
                                                    first["whole"]),
          "first_token_argmax_equal": int(first["chunked"].argmax())
          == int(first["whole"].argmax()),
          "prefill_511_ms": {name: {"median": sorted(ms)[len(ms) // 2],
                                    "min": min(ms), "max": max(ms),
                                    "samples": ms}
                             for name, ms in prefill_ms.items()},
          "drain_s": {"whole": whole_s, "chunked": chunked_s},
          "launches_drains": launches_drains})
    del params, eng, peng, seng
    torch.cuda.empty_cache()

    workdir = tempfile.mkdtemp(prefix=".serve_recovery_", dir=ROOT)
    try:
        for name, case in DRILLS.items():
            crash_drill(name, case, args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": phase, "event": "done",
          "seconds": time.monotonic() - t_phase})
    return {k: launches[k] for k in path}


# ---------------------------------------------------------------------------
# Phase 10: the int8 KV cache.
# ---------------------------------------------------------------------------
SERVE_INT8KV_PATH = ("matmul_os", "matmul_os_prefill", "matmul_os_decode",
                     "flash_attention", "flash_attention_i8kv")
# B2's and B7's launch counts: the attention launches of a serve are
# gated on their sum (one a layer a prompt, step or chunk) and each on
# the autotuner's picks (``_picks_gate``).
ATTENTION_KEYS = ("flash_attention", "kv_stationary", "flash_attention_i8kv",
                  "kv_stationary_cluster_i8kv", "flash_attention_f32_i8kv",
                  "kv_stationary_f32_i8kv")


def _attention(launches, i8: bool = False, f32: bool = False) -> int:
    """B2's and B7's launches together: all, over int8 K/V under bf16
    queries (``i8``), or under float32 queries (``f32``)."""
    keys = (("flash_attention_f32_i8kv", "kv_stationary_f32_i8kv") if f32
            else ("flash_attention_i8kv", "kv_stationary_cluster_i8kv") if i8
            else ("flash_attention", "kv_stationary"))
    return sum(launches.get(k, 0) for k in keys)
# The reference's bound on the int8 cache's first decode logits against
# the bf16 cache's (max |diff| over max |bf16 logit|), gated at 2 layers.
INT8KV_REL_TOL = 0.05


def _cache_bytes(cache) -> int:
    return sum(cache[k].numel() * cache[k].element_size()
               for k in ("k", "v", "k_scale", "v_scale") if k in cache)


def serve_int8kv_phase(torch, cfg, args):
    """Full-width qwen3-1.7b (random weights from ``--seed``, depth
    ``--layers``) with ``kv_cache_dtype="int8"`` through ``Engine``'s
    continuous scheduler: the slot cache holds int8 codes and f32
    per-position scales, every decode step and prefill chunk attends over
    them through B2's int8 path, a whole prompt's prefill over its float
    K/V.  Gates: every request DONE, 0 demotions; mixed batch == each
    request alone; no page pool and no paged launch; B2's int8 launches
    exactly the decode steps' and chunks' (one a layer) and its float
    launches the whole prompts'; the int8 cache's bytes under 0.6x a bf16
    cache's; a run with ``prefill_chunk=128`` DONE (its tokens that differ
    from the whole prompts' counted: a whole prefill attends over float
    K/V, a chunk over the int8 cache); the first decode logits within
    ``INT8KV_REL_TOL`` of the bf16 cache's at 2 layers (the full depth's
    reported).  Returns the launches of the path's kernels over the main
    drain."""
    import numpy as np

    from repro_torch.kernels import _build, ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, RequestState
    from repro_torch.serve.scheduler import SchedulerConfig

    phase, max_len, new_tokens = "serve_int8kv", 1024, 16
    lens = (17, 64, 200, 511)
    t_phase = time.monotonic()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    prompts = _prompts(cfg, args.seed, lens)

    def drain(ps, event, **sc):
        eng = Engine(cfg8, params, max_len=max_len, device="cuda",
                     scheduler_config=SchedulerConfig(**sc) if sc else None)
        reqs = [eng.submit(p, new_tokens) for p in ps]
        since, rsince = dict(_build.LAUNCHES), dict(ops.RESOLVED)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        _healthy(phase, event, reqs, eng)
        rep = eng.scheduler_report()
        if rep["paged_decode"] or "pages" in rep \
                or eng._scheduler.paged is not None:
            raise AssertionError(f"{event}: an int8 cache decoded off or "
                                 f"mirrored into a page pool: {rep}")
        launched = {k: _build.LAUNCHES[k] - since.get(k, 0)
                    for k in _build.LAUNCHES}
        implied = _picks_gate(f"{phase} {event}", launched,
                              picks_since(rsince))
        keys = dict.fromkeys((*(k for k in SERVE_INT8KV_PATH
                                if implied.get(k)), "paged_attention",
                              *ATTENTION_KEYS,
                              *(k for k, v in implied.items() if v)))
        return ([r.out_tokens for r in reqs], eng, wall,
                {k: launched[k] for k in keys})

    # The main path: counts zeroed just before, read just after.
    _build.reset_launches()
    tokens, eng, wall, launches = drain(prompts, "drain")
    cache = eng._scheduler.cache
    steps = len(eng.monitor.records)
    want_i8 = steps * cfg.n_layers
    want_float = len(lens) * cfg.n_layers
    bytes8 = _cache_bytes(cache)
    bytes16 = cache["k"].numel() * 2 * 2
    emit({"phase": phase, "event": "drain", "prompt_lens": list(lens),
          "new_tokens": new_tokens, "wall_s": wall, "decode_steps": steps,
          "decode_ms_per_step_median": _step_ms(eng),
          "cache_dtype": str(cache["k"].dtype),
          "cache_bytes": bytes8, "bf16_cache_bytes": bytes16,
          "cache_bytes_ratio": bytes8 / bytes16, "launches": launches,
          "want_flash_i8kv": want_i8,
          "want_flash_float": want_float, "tokens": tokens})
    missing = [k for k in launches if launches[k] <= 0
               and k not in ATTENTION_KEYS and k != "paged_attention"]
    missing += [] if _attention(launches) else ["flash_attention"]
    if missing or launches["paged_attention"]:
        raise AssertionError(f"int8 serve launches: missing {missing}, "
                             f"paged {launches['paged_attention']}")
    if _attention(launches, i8=True) != want_i8 or \
            _attention(launches) != want_i8 + want_float:
        raise AssertionError(
            f"B2/B7's int8 launches {_attention(launches, i8=True)} (want "
            f"{want_i8}: {steps} decode steps x {cfg.n_layers} layers), all "
            f"{_attention(launches)} (want {want_i8 + want_float})")
    _tiles_gate(phase, launches)
    if cache["k"].dtype != torch.int8 or bytes8 >= 0.6 * bytes16:
        raise AssertionError(f"int8 cache {cache['k'].dtype}, {bytes8} "
                             f"bytes against bf16's {bytes16}")

    # Mixed-length batch == each request alone: per-position scales keep
    # the rows independent.
    for p, t in zip(prompts, tokens):
        alone = Engine(cfg8, params, max_len=max_len, device="cuda")
        h = alone.submit(p, new_tokens)
        alone.drain()
        if h.state != RequestState.DONE or h.out_tokens != t:
            raise AssertionError(f"prompt of {len(p)} alone: {h.state} "
                                 f"{h.out_tokens} != batched {t}")
    emit({"phase": phase, "event": "mixed_vs_sequential",
          "tokens_differing": 0, "gated": True, "ok": True})

    # Chunked prefill over the int8 cache: the 200- and 511-token prompts
    # in chunks of 128 (2 + 4), each chunk's B2 launches int8 too.
    chunked, ceng, chunked_s, claunch = drain(prompts, "chunked",
                                              prefill_chunk=128)
    chunks = sum(-(-n // 128) for n in lens if n > 128)
    csteps = len(ceng.monitor.records)
    whole_prompts = sum(n <= 128 for n in lens)
    emit({"phase": phase, "event": "chunked", "prefill_chunk": 128,
          "chunks": chunks, "decode_steps": csteps, "wall_s": chunked_s,
          "launches": claunch,
          "tokens_differing_from_whole": sum(
              a != b for w, c in zip(tokens, chunked) for a, b in zip(w, c))})
    if _attention(claunch, i8=True) != (csteps + chunks) * cfg.n_layers \
            or _attention(claunch) != _attention(claunch, i8=True) \
            + whole_prompts * cfg.n_layers:
        raise AssertionError(f"chunked run's B2/B7 launches {claunch}: want "
                             f"{(csteps + chunks) * cfg.n_layers} int8")

    # The first decode logits off the int8 cache against the bf16 cache's,
    # prompt by prompt (the reference's own check, at 2 layers and at the
    # full depth).
    for depth in (2, cfg.n_layers):
        sub = dataclasses.replace(cfg, n_layers=depth)
        sub8 = dataclasses.replace(cfg8, n_layers=depth)
        sub_params = dict(params, layers=_map(lambda t: t[:depth],
                                              params["layers"]))
        rel = []
        for p in prompts:
            toks = torch.as_tensor(p[None], device="cuda")
            first, c16 = lm.prefill(sub_params, toks, sub, max_len=max_len)
            _, c8 = lm.prefill(sub_params, toks, sub8, max_len=max_len)
            nxt = first.argmax(-1, keepdim=True)
            d16, _ = lm.decode_step(sub_params, c16, nxt, sub)
            d8, _ = lm.decode_step(sub_params, c8, nxt, sub8)
            if not bool(torch.isfinite(d8[..., :cfg.vocab_size]).all()):
                raise AssertionError(f"{depth} layers: int8 decode logits "
                                     f"not finite")
            valid = d16[..., :cfg.vocab_size].float()
            rel.append(float((d8[..., :cfg.vocab_size].float() - valid)
                             .abs().max() / (valid.abs().max() + 1e-9)))
        gated = depth == 2
        emit({"phase": phase, "event": "int8_vs_bf16_first_decode",
              "layers": depth, "prompt_lens": list(lens),
              "rel_max_err": rel, "bound": INT8KV_REL_TOL, "gated": gated})
        if gated and max(rel) >= INT8KV_REL_TOL:
            raise AssertionError(f"2-layer int8 decode logits off the bf16 "
                                 f"cache's by {max(rel)}")
    trace_decode(torch, cfg8, params, prompts, max_len, phase)
    emit({"phase": phase, "event": "done",
          "seconds": time.monotonic() - t_phase,
          "launches_by_path": launches})
    return {k: v for k, v in launches.items()
            if k != "paged_attention" and v}


# ---------------------------------------------------------------------------
# Phases 11 and 12: the other dense decoders, at full width and at their
# float32 smoke sizes.
# ---------------------------------------------------------------------------
# (config, layers served): minicpm-2b whole; the others cut to 4 layers for
# the script's time (their weights at full depth would fit the card).
SERVE_DENSE = (("minicpm-2b", None), ("mistral-nemo-12b", 4),
               ("minitron-8b", 4), ("chameleon-34b", 4))
# The five dense smoke configs served in float32 (as the serve examples
# serve them), each from the float cache and from an int8 KV cache.
SERVE_F32 = ("qwen3-1.7b", "minicpm-2b", "mistral-nemo-12b", "minitron-8b",
             "chameleon-34b")
SERVE_F32_LENS, SERVE_F32_MAX_LEN, SERVE_F32_CHUNK = (5, 17, 40, 100), 256, 32
# B1's f32 walk, B2 (f32 over float K/V at whole prompts; K1 over the int8
# cache at every decode step and chunk), B3 (f32, the float cache).
SERVE_F32_PATH = ("matmul_os", "flash_attention", "flash_attention_f32_i8kv",
                  "paged_attention")


def _tiles_gate(phase: str, launches) -> None:
    """Every launch of the phase's MLP GEMM library is one of its tiles'
    (``SERVE_TILES``), or raise."""
    event, lib, prefill, decode = SERVE_TILES[phase]
    split = {lib: launches.get(lib, 0),
             "prefill_tile": launches.get(prefill, 0),
             "decode_tile": launches.get(decode, 0)}
    emit({"phase": phase, "event": event, **split,
          "tiles": [prefill, decode]})
    if split["prefill_tile"] + split["decode_tile"] != split[lib]:
        raise AssertionError(f"{phase}: {lib} launches off its tiles: "
                             f"{split}")


def _first_decode(torch, cfg, params, prompt, max_len, nxt=None,
                  enc_frames=None):
    """The first decode step's logits after ``lm.prefill`` of ``prompt``
    (an encoder-decoder's over ``enc_frames``): off a page pool filled
    from the prefill's cache (page 16, B3) for a float cache, off the slot
    cache (B2; K1 under float32 queries) for an int8 one or a config with
    SSM state or a cross cache; ``nxt`` (the token fed, default the
    prefill's greedy one over the first ``vocab_size`` logits).  Returns
    (logits, nxt)."""
    from repro_torch.models import lm

    toks = torch.as_tensor(prompt[None], device="cuda")
    kw = {} if enc_frames is None else {"enc_frames": enc_frames}
    first, cache = lm.prefill(params, toks, cfg, max_len=max_len, **kw)
    if nxt is None:
        nxt = first[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    if not lm.supports_paged_decode(cfg):
        logits, _ = lm.decode_step(params, cache, nxt, cfg)
        return logits, nxt
    page, n = 16, len(prompt)
    n_layers, _, hkv, _, dh = cache["k"].shape

    def pool(buf):
        p = buf[:, 0].reshape(n_layers, hkv, max_len // page, page, dh)
        return torch.cat([p, torch.zeros_like(p[:, :, :1])], 2).contiguous()

    i32 = dict(dtype=torch.int32, device="cuda")
    logits, _ = lm.paged_decode_step(
        params, pool(cache["k"]), pool(cache["v"]), nxt,
        torch.arange(max_len // page, **i32)[None],
        torch.tensor([n], **i32), torch.tensor([n // page], **i32),
        torch.tensor([n % page], **i32), cfg)
    return logits, nxt


def serve_dense_phase(torch, args):
    """minicpm-2b at full width and full depth (40 layers), then
    mistral-nemo-12b, minitron-8b and chameleon-34b at full width with 4
    layers each (the cut printed), bf16, random weights from ``--seed``,
    served through ``Engine`` on the paged path with the serve cell's
    prompts (17/64/200/511 tokens, 16 new each).  Gates per config: B1's
    tile at the down projection (K = d_ff; minicpm's 5 760 is no multiple
    of the decode tile's 256-deep step) within B1's tolerance; the first
    decode step's logits over the first ``vocab_size`` columns finite, at
    cosine >= 0.999 of the plain path's on the card at 2 layers (the
    served depth's reported); every request DONE, 0 demotions; no token
    >= ``vocab_size``; every B1 launch on its tiles; B2 launches = layers
    x prompts, B3 = layers x decode steps.  minicpm-2b's decode step is
    traced.  Returns the path's launches, summed over the four drains
    (counts set to 0 at the phase's start, each drain's read just
    before and after it)."""
    from repro_torch import configs
    from repro_torch.kernels import _build, matmul_df, ops, ref
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import Engine

    phase, max_len, new_tokens = "serve_dense", 1024, 16
    lens = (17, 64, 200, 511)
    t_phase = time.monotonic()
    _build.reset_launches()
    total = {k: 0 for k in SERVE_PATH}
    implied_total = {}
    per_config = {}
    for name, depth in SERVE_DENSE:
        t0 = time.monotonic()
        full = configs.get(name)
        cfg = full if depth is None else dataclasses.replace(full,
                                                             n_layers=depth)
        params = lm.init_model(cfg, seed=args.seed, device="cuda")
        torch.cuda.synchronize()
        weights = sum(t.numel() * t.element_size() for t in _leaves(params))
        emit({"phase": phase, "config": name, "event": "init_model",
              "layers": cfg.n_layers, "published_layers": full.n_layers,
              "depth_cut": None if depth is None else
              f"{full.n_layers} -> {depth} layers (the script's time)",
              "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
              "d_head": cfg.d_head, "q_dim": cfg.q_dim, "d_ff": cfg.d_ff,
              "vocab": [cfg.vocab_size, cfg.padded_vocab],
              "tied": cfg.tie_embeddings, "qk_norm": cfg.qk_norm,
              "weights_bytes": weights, "weights_gb": weights / 1e9,
              "seconds": time.monotonic() - t0})
        prompts = _prompts(cfg, args.seed, lens)

        # B1 at the down projection (K = d_ff), decode and prefill tiles.
        w2 = params["layers"]["mlp"]["w2"][0]
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        for m in (4, 511):
            a = torch.randn((m, cfg.d_ff), generator=gen,
                            device="cuda").to(torch.bfloat16)
            tile = ("matmul_os_decode" if m <= matmul_df.DECODE_M
                    else "matmul_os_prefill")
            check(tile, matmul_df.matmul_os(a, w2), ref.matmul_fused_ref(
                a, w2), shape=f"{name} down M={m} K={cfg.d_ff} N={cfg.d_model}",
                **B1_TOL)

        # The first decode step on the kernels against the plain path, the
        # same token fed to both.
        for sub_depth in sorted({2, cfg.n_layers}):
            sub = dataclasses.replace(cfg, n_layers=sub_depth)
            sub_params = dict(params, layers=_map(lambda t: t[:sub_depth],
                                                  params["layers"]))
            got, nxt = _first_decode(torch, sub, sub_params, prompts[0],
                                     max_len)
            with layers.forced_backend("torch"):
                want, _ = _first_decode(torch, sub, sub_params, prompts[0],
                                        max_len, nxt)
            got, want = (x[..., :cfg.vocab_size] for x in (got, want))
            cos = _cosine(got, want)
            finite = bool(torch.isfinite(got).all())
            emit({"phase": phase, "config": name,
                  "event": "first_decode_vs_plain", "layers": sub_depth,
                  "finite": finite, "cosine": cos,
                  "max_abs_err": max_err(got, want), "gated": sub_depth == 2,
                  "argmax_equal": int(got.argmax()) == int(want.argmax())})
            if not finite or (sub_depth == 2 and cos < 0.999):
                raise AssertionError(f"{name}: {sub_depth}-layer first decode "
                                     f"logits off the plain path (cosine "
                                     f"{cos}, finite {finite})")

        # The main path.
        eng = Engine(cfg, params, max_len=max_len, device="cuda")
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        since, rsince = dict(_build.LAUNCHES), dict(ops.RESOLVED)
        torch.cuda.synchronize()
        t_drain = time.monotonic()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.monotonic() - t_drain
        launches = {k: _build.LAUNCHES[k] - since[k] for k in _build.LAUNCHES}
        # the other decoders' widths: held out of the cost model's fit
        implied = _picks_gate(f"{phase} {name}", launches,
                              picks_since(rsince), group="held-out")
        _healthy(phase, name, reqs, eng)
        steps = len(eng.monitor.records)
        tokens = [r.out_tokens for r in reqs]
        emit({"phase": phase, "config": name, "event": "drain",
              "layers": cfg.n_layers, "prompt_lens": list(lens),
              "new_tokens": new_tokens, "wall_s": wall,
              "decode_steps": steps,
              "decode_ms_per_step_median": _step_ms(eng),
              "launches": {k: launches[k] for k in
                           (*SERVE_PATH, "flash_attention_i8kv")},
              "tokens": tokens})
        over = [t for ts in tokens for t in ts if t >= cfg.vocab_size]
        if over:
            raise AssertionError(f"{name}: tokens past vocab_size {over}")
        _tiles_gate(phase, launches)
        want_b2, want_b3 = cfg.n_layers * len(lens), cfg.n_layers * steps
        if _attention(launches) != want_b2 or \
                launches["paged_attention"] != want_b3:
            raise AssertionError(
                f"{name}: B2/B7 launches {_attention(launches)} (want "
                f"{want_b2}), B3 {launches['paged_attention']} (want "
                f"{want_b3})")
        for k in dict.fromkeys((*SERVE_PATH, *implied)):
            total[k] = total.get(k, 0) + launches[k]
            implied_total[k] = implied_total.get(k, 0) + implied.get(k, 0)
        if depth is None:
            trace_decode(torch, cfg, params, prompts, max_len,
                         f"{phase} {name}")
        per_config[name] = dict(layers=cfg.n_layers, weights_bytes=weights,
                                decode_steps=steps,
                                decode_ms_per_step=_step_ms(eng),
                                seconds=time.monotonic() - t0)
        del params, eng
        torch.cuda.empty_cache()
    missing = [k for k in total if total[k] <= 0
               and (k == "paged_attention" or implied_total.get(k))]
    if missing:
        raise AssertionError(f"kernels never launched on {phase}: {missing}")
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase, "configs": per_config,
          "launches_by_path": total})
    return total


def serve_f32_phase(torch, args):
    """The five dense smoke configs (qwen3-1.7b's, minicpm-2b's at d_head
    16, mistral-nemo-12b's, minitron-8b's, chameleon-34b's), float32, on
    the card through ``Engine``, as the serve examples serve them: from the
    float cache (the paged path: B1's f32 walk, B2 f32, B3 f32) and from an
    int8 KV cache (``kv_cache_dtype="int8"``: the slot cache, K1 at every
    decode step and chunk), whole prompts and with ``prefill_chunk=32``;
    then mamba2-smoke (no kernel: its float cache is the SSM state alone,
    whole prompts and chunked) and hymba-smoke (float cache off the slot
    cache, B2 f32 at every prefill and decode step; int8 cache as the
    dense ones).
    Gates per config and cache: the first decode logits within B2's f32
    tolerance of the plain path on the card; every request DONE, 0
    demotions; B2 launches = layers x whole prompts, B3 = layers x decode
    steps (float cache; off the slot cache B2 = layers x (prompts + decode
    steps) and no B3), K1 = layers x (decode steps + chunks) and none of
    B3 (int8 cache).  The int8 runs' tokens that differ from the float
    cache's and the chunked run's that differ from the whole prompts' are
    counted, not gated (greedy ties at random weights).  Returns the
    path's launches over the drains."""
    from repro_torch import configs
    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import SchedulerConfig

    phase, new_tokens = "serve_f32", 8
    max_len, chunk, lens = SERVE_F32_MAX_LEN, SERVE_F32_CHUNK, SERVE_F32_LENS
    t_phase = time.monotonic()
    _build.reset_launches()
    total = {k: 0 for k in SERVE_F32_PATH}
    implied_total = {}

    def drain(cfg, params, prompts, event, **sc):
        eng = Engine(cfg, params, max_len=max_len, device="cuda",
                     scheduler_config=SchedulerConfig(**sc) if sc else None)
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        since, rsince = dict(_build.LAUNCHES), dict(ops.RESOLVED)
        eng.drain()
        torch.cuda.synchronize()
        launches = {k: _build.LAUNCHES[k] - since[k] for k in _build.LAUNCHES}
        _healthy(phase, event, reqs, eng)
        implied = _picks_gate(f"{phase} {event}", launches,
                              picks_since(rsince))
        for k in dict.fromkeys((*SERVE_F32_PATH, *implied)):
            total[k] = total.get(k, 0) + launches[k]
            implied_total[k] = implied_total.get(k, 0) + implied.get(k, 0)
        return [r.out_tokens for r in reqs], len(eng.monitor.records), \
            launches

    for name in SERVE_F32 + SERVE_SSM:
        t0 = time.monotonic()
        cfg = configs.get_smoke(name)
        cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        # an attention-free config has no KV cache to make int8
        caches = (cfg, cfg8) if cfg.has_attention else (cfg,)
        params = lm.init_model(cfg, seed=args.seed, device="cuda")
        prompts = _prompts(cfg, args.seed, lens)
        for c in caches:
            got, nxt = _first_decode(torch, c, params, prompts[2], max_len)
            with layers.forced_backend("torch"):
                want, _ = _first_decode(torch, c, params, prompts[2],
                                        max_len, nxt)
            check(f"{phase} {name} first decode logits", got[
                ..., :cfg.vocab_size], want[..., :cfg.vocab_size],
                shape=f"{cfg.name} {c.kv_cache_dtype} cache d_head "
                      f"{cfg.d_head}", **F32_TOL)
        # layers with attention; the float cache decodes off the page pool
        # (B3) where the paged step takes the config, else off the slot
        # cache (B2 at every decode step)
        L = cfg.n_layers if cfg.has_attention else 0
        paged = lm.supports_paged_decode(cfg)
        tokens, steps, la = drain(cfg, params, prompts, f"{name} float")
        if _attention(la) != L * (len(lens) + (0 if paged else steps)) or \
                la["paged_attention"] != (L * steps if paged else 0) or \
                _attention(la, f32=True):
            raise AssertionError(f"{name} float cache launches {la}")
        runs = {"float": (tokens, steps, la)}
        chunks = sum(-(-n // chunk) for n in lens if n > chunk)
        whole = sum(n <= chunk for n in lens)
        if cfg.has_attention:
            tokens8, steps8, l8 = drain(cfg8, params, prompts,
                                        f"{name} int8")
            if _attention(l8, f32=True) != L * steps8 or \
                    _attention(l8) != L * (steps8 + len(lens)) or \
                    l8["paged_attention"]:
                raise AssertionError(f"{name} int8 cache launches {l8}: "
                                     f"K1/K2 want {L * steps8}")
            runs["int8"] = (tokens8, steps8, l8)
        chunked, csteps, lc = drain(caches[-1], params, prompts,
                                    f"{name} chunked", prefill_chunk=chunk)
        if _attention(lc, f32=True) != L * (csteps + chunks) or \
                _attention(lc) != L * (csteps + chunks + whole):
            raise AssertionError(f"{name} chunked launches {lc}: K1/K2 "
                                 f"want {L * (csteps + chunks)}")
        runs[f"{caches[-1].kv_cache_dtype}_chunked"] = (chunked, csteps, lc)
        if not cfg.has_attention and any(v for v in lc.values()):
            raise AssertionError(f"{name} reached a kernel: {lc}")
        emit({"phase": phase, "config": cfg.name, "d_head": cfg.d_head,
              "heads": [cfg.n_heads, cfg.n_kv_heads], "layers": L,
              "decode_steps": {k: v[1] for k, v in runs.items()},
              "chunks": chunks,
              "launches": {k: {n: v[2][n] for n in SERVE_F32_PATH}
                           for k, v in runs.items()},
              "int8_tokens_differing_from_float": sum(
                  a != b for x, y in zip(tokens, runs["int8"][0])
                  for a, b in zip(x, y)) if "int8" in runs else None,
              "chunked_tokens_differing_from_whole": sum(
                  a != b for x, y in zip(
                      runs["int8" if cfg.has_attention else "float"][0],
                      chunked)
                  for a, b in zip(x, y)),
              "seconds": time.monotonic() - t0})
    _serve_f32_audio(torch, args, total, implied_total)
    missing = [k for k in total if total[k] <= 0
               and (k == "paged_attention" or implied_total.get(k))]
    if missing:
        raise AssertionError(f"kernels never launched on {phase}: {missing}")
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase, "launches_by_path": total})
    return total


# Encoder frames a row of serve_f32's whisper-smoke.
SERVE_F32_FRAMES = 30


def _serve_f32_audio(torch, args, total, implied_total):
    """serve_f32 for whisper-smoke (2 encoder and 2 decoder layers, d_head
    16), float32, from the float cache and from an int8 KV cache (its
    cross K/V float either way), through ``lm.prefill(enc_frames=)`` and
    ``lm.decode_step``, one row a prompt of ``SERVE_F32_LENS`` with 8
    greedy steps each (the engine passes no frames, as the JAX engine
    passes none).  Gates per cache: the first decode logits within B2's
    f32 tolerance of the plain path; B2 f32 = decoder layers x (prompts +
    decode steps) from the float cache, B2 f32 = layers x prompts and K1 =
    layers x decode steps from the int8 one; the launches equal to the
    picks'; no token past ``vocab_size`` from a decode step."""
    from repro_torch import configs
    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers, lm

    phase, steps = "serve_f32", 8
    t0 = time.monotonic()
    cfg = configs.get_smoke(SERVE_AUDIO)
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    frames = torch.randn((1, SERVE_F32_FRAMES, cfg.d_model), generator=gen,
                         device="cuda")
    prompts = _prompts(cfg, args.seed, SERVE_F32_LENS)
    L = cfg.n_layers
    runs = {}
    for c in (cfg, dataclasses.replace(cfg, kv_cache_dtype="int8")):
        tag = c.kv_cache_dtype
        got, nxt = _first_decode(torch, c, params, prompts[2],
                                 SERVE_F32_MAX_LEN, enc_frames=frames)
        with layers.forced_backend("torch"):
            want, _ = _first_decode(torch, c, params, prompts[2],
                                    SERVE_F32_MAX_LEN, nxt,
                                    enc_frames=frames)
        check(f"{phase} {cfg.name} first decode logits",
              got[..., :cfg.vocab_size], want[..., :cfg.vocab_size],
              shape=f"{cfg.name} {tag} cache d_head {cfg.d_head}",
              **F32_TOL)
        since, rsince = dict(_build.LAUNCHES), dict(ops.RESOLVED)
        tokens = []
        for p in prompts:
            logits, cache = lm.prefill(
                params, torch.as_tensor(p[None], device="cuda"), c,
                max_len=SERVE_F32_MAX_LEN, enc_frames=frames)
            out = []
            for _ in range(steps):
                nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
                out.append(int(nxt))
                logits, cache = lm.decode_step(params, cache, nxt, c)
            tokens.append(out + [int(logits.argmax())])
        torch.cuda.synchronize()
        la = {k: _build.LAUNCHES[k] - since[k] for k in _build.LAUNCHES}
        implied = _picks_gate(f"{phase} {cfg.name} {tag}", la,
                              picks_since(rsince))
        n_steps = steps * len(prompts)
        want_k1 = L * n_steps if tag == "int8" else 0
        if _attention(la) != L * (len(prompts) + n_steps) or \
                _attention(la, f32=True) != want_k1 or la["paged_attention"] \
                or any(t >= cfg.vocab_size for ts in tokens for t in ts[1:]):
            raise AssertionError(f"{cfg.name} {tag} cache launches {la} "
                                 f"(K1 want {want_k1}) or tokens {tokens}")
        for k in dict.fromkeys((*SERVE_F32_PATH, *implied)):
            total[k] = total.get(k, 0) + la[k]
            implied_total[k] = implied_total.get(k, 0) + implied.get(k, 0)
        runs[tag] = tokens
    emit({"phase": phase, "config": cfg.name, "d_head": cfg.d_head,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "layers": L,
          "enc_layers": cfg.n_enc_layers, "enc_frames": SERVE_F32_FRAMES,
          "int8_tokens_differing_from_float": sum(
              a != b for x, y in zip(runs["auto"], runs["int8"])
              for a, b in zip(x, y)),
          "seconds": time.monotonic() - t0})


# ---------------------------------------------------------------------------
# Phase 14: the MoE decoders at full width.
# ---------------------------------------------------------------------------
# (config, layers served): moonshot-v1-16b-a3b whole (57.8 GB of bf16
# weights); qwen3-moe-235b-a22b at 4 of its 94 layers (470 GB whole).
SERVE_MOE = (("moonshot-v1-16b-a3b", None), ("qwen3-moe-235b-a22b", 4))
# B1's bf16 tiles (moonshot's shared experts), B2, B3 and B3's 16-warp
# kernel (qwen3-moe's group of 16).
SERVE_MOE_PATH = SERVE_PATH + ("paged_attention_g16",)
# A routing flip between the kernels and the plain path at a margin (the
# plain path's k-th minus (k+1)-th probability) above this fails the phase.
FLIP_MARGIN = 1e-3
# The float32 router logits on the card against float64, relative to the
# largest: full float32 sums (TF32 would be ~1e-3 off).
ROUTER_RTOL = 1e-5


@contextlib.contextmanager
def _wrapped(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` for the duration."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _recording_routes(records):
    """``moe._route`` recording, call by call (a layer of a forward), the
    experts it picked (T, k) and each token's margin, the k-th minus the
    (k+1)-th routing probability (device tensors, read after the run)."""
    import torch

    from repro_torch.models import moe

    def wrap(orig):
        def route(x_flat, router, top_k):
            out = orig(x_flat, router, top_k)
            probs = torch.softmax(moe.router_logits(x_flat, router), -1)
            top = torch.topk(probs, top_k + 1, dim=-1).values
            records.append((out[1], top[:, top_k - 1] - top[:, top_k]))
            return out
        return route
    return _wrapped(moe, "_route", wrap)


def _recording_drops(records):
    """``moe._dispatch_indices`` recording, call by call, (tokens routed,
    assignments dropped) (the count a device tensor, read after the
    run)."""
    from repro_torch.models import moe

    def wrap(orig):
        def dispatch(top_e, top_k, n_experts, cap):
            out = orig(top_e, top_k, n_experts, cap)
            records.append((top_e.shape[0], (~out[4]).sum()))
            return out
        return dispatch
    return _wrapped(moe, "_dispatch_indices", wrap)


def _drops_by_forward(records, n_layers: int, decode_rows: int):
    """Dropped assignments summed over each forward's layers: (prefills,
    decode steps), a decode step being a forward of ``decode_rows``
    tokens (no served prompt has that many)."""
    prefill, decode = [], []
    for i in range(0, len(records), n_layers):
        part = records[i:i + n_layers]
        n = int(sum(d for _, d in part))
        (decode if part[0][0] == decode_rows else prefill).append(n)
    return prefill, decode


def _route_flips(label: str, got, want, n_layers: int, gated: bool):
    """The kernels' routes against the plain path's, forward by forward
    (a prefill's layers, then the decode step's): per layer the tokens
    whose expert set differs and the plain path's margin at each.  The
    first layer with a flip is gated when ``gated`` (every flip there at
    a margin <= FLIP_MARGIN): the layers after it see inputs that already
    differ by a discrete choice, so they are reported only.  Returns
    whether any route flipped."""
    rows, first = [], None
    for i, ((ge, _), (we, wm)) in enumerate(zip(got, want)):
        flip = (ge.sort(-1).values != we.sort(-1).values).any(-1)
        margins = [float(m) for m in wm[flip]]
        row = {"stage": "prefill" if i < n_layers else "decode",
               "layer": i % n_layers, "flips": len(margins),
               "flip_margins": margins,
               "least_margin": float(wm.min())}
        if i >= n_layers:
            row["top_k_kernels"] = ge[0].tolist()
            row["top_k_plain"] = we[0].tolist()
        if margins and first is None:
            first, row["first_flip"] = i, True
        rows.append(row)
    emit({"phase": "serve_moe", "config": label, "event": "routes",
          "layers": n_layers, "forwards": len(got) // n_layers,
          "flips": sum(r["flips"] for r in rows),
          "layers_with_flips": [[r["stage"], r["layer"]] for r in rows
                                if r["flips"]],
          "first_flip_gated": gated and first is not None,
          "per_layer": rows})
    if gated and first is not None \
            and max(rows[first]["flip_margins"]) > FLIP_MARGIN:
        raise AssertionError(f"{label}: a route flipped at margin "
                             f"{max(rows[first]['flip_margins'])} > "
                             f"{FLIP_MARGIN}: {rows[first]}")
    return first is not None


def serve_moe_phase(torch, args):
    """moonshot-v1-16b-a3b at full width and full depth (48 layers, 64
    experts top-6 and 2 shared experts), then qwen3-moe-235b-a22b at full
    width with 4 of its 94 layers (128 experts top-8, 64 q heads over 4 kv
    heads: B3's group of 16; the cut printed), bf16, random weights from
    ``--seed``, served through ``Engine`` on the paged path with the serve
    cell's prompts (17/64/200/511 tokens, 16 new each, decode batch 4).
    Printed per config: weights' bytes, layers, experts, top-k, capacity
    at each prefill and at decode, the assignments each prefill and each
    decode step dropped (summed over the layers; counted by a wrapper of
    ``moe._dispatch_indices`` in the drain, one reduction a layer), decode
    ms/step.  Gates per config: the float32 router logits within
    ROUTER_RTOL of float64; the first decode step's logits over the first
    ``vocab_size`` columns finite and, at 2 layers, at cosine >= 0.999 of
    the plain path's (the served depth reported), each layer's top-k on
    both paths printed and the first flip at 2 layers at a margin <=
    FLIP_MARGIN (after a flip the cosine is reported, not gated); every
    request DONE, 0 demotions; no decode token >= ``vocab_size`` (a first
    token comes from the prefill's logits, which the reference leaves
    unmasked: counted, not gated); every B1 launch
    on its tiles; B2/B7 launches = layers x prompts, B3 = layers x decode
    steps, all of qwen3-moe's on B3's 16-warp kernel and none of
    moonshot's; the mixed batch's tokens == each request's alone wherever
    no decode step dropped an assignment (prefill drops are the
    reference's semantics: counted, not gated).  moonshot's decode step
    is traced, with the expert GEMMs' (``aten::bmm``) device time; one
    layer's ``_expert_ffn`` at the decode capacity is timed apart.
    Returns the path's launches, summed over the two drains."""
    import gc

    from repro_torch.kernels import _build

    phase = "serve_moe"
    t_phase = time.monotonic()
    _build.reset_launches()
    total = {k: 0 for k in SERVE_MOE_PATH}
    implied_total = {}
    per_config = {}
    for name, depth in SERVE_MOE:
        # An engine and its request handles refer to each other, so the
        # weights of an earlier phase's or config's engine go only with a
        # collection: moonshot's 57.8 GB leave little room beside them.
        gc.collect()
        torch.cuda.empty_cache()
        per_config[name] = _serve_moe_config(torch, args, name, depth,
                                             total, implied_total)
    missing = [k for k in total if total[k] <= 0
               and (k in ("paged_attention", "paged_attention_g16")
                    or implied_total.get(k))]
    if missing:
        raise AssertionError(f"kernels never launched on {phase}: {missing}")
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase, "configs": per_config,
          "launches_by_path": total})
    return total


def _serve_moe_config(torch, args, name: str, depth, total, implied_total):
    """``serve_moe`` for one config (``depth`` layers, or all): its
    gates, its launches added into ``total`` and the launches its picks
    imply into ``implied_total``.  Returns its summary."""
    from repro_torch import configs
    from repro_torch.bench.common import HBM_BYTES_PER_S, Timer
    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers, lm, moe
    from repro_torch.serve.engine import Engine

    import gc

    phase, max_len, new_tokens = "serve_moe", SERVE_MAX_LEN, 16
    lens, batch = SERVE_LENS, SERVE_BATCH
    t0 = time.monotonic()
    full = configs.get(name)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         n_layers=depth)
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    caps = {"prefill": {n: moe.capacity(cfg, n) for n in lens},
            "decode": moe.capacity(cfg, batch)}
    emit({"phase": phase, "config": name, "event": "init_model",
          "layers": cfg.n_layers, "published_layers": full.n_layers,
          "depth_cut": None if depth is None else
          f"{full.n_layers} -> {depth} layers (the card's memory: "
          f"{full.n_layers} layers are ~470 GB)",
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "gqa_group": cfg.n_heads // cfg.n_kv_heads,
          "d_head": cfg.d_head, "expert_d_ff": cfg.d_ff,
          "experts": cfg.n_experts, "top_k": cfg.top_k,
          "shared_experts": cfg.n_shared_experts,
          "capacity_factor": cfg.capacity_factor, "capacity": caps,
          "vocab": [cfg.vocab_size, cfg.padded_vocab],
          "weights_bytes": weights, "weights_gb": weights / 1e9,
          "device_memory_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.monotonic() - t0})
    prompts = _prompts(cfg, args.seed, lens)

    # The router in full float32: layer 0's logits of the 511-token
    # prompt's normed embeddings against float64.
    h = layers.rmsnorm(params["layers"]["ln2"][0], layers.embed(
        params["embed"]["table"], torch.as_tensor(
            prompts[-1], device="cuda")).to(torch.bfloat16),
        cfg.norm_eps)
    router = params["layers"]["moe"]["router"][0]
    want64 = h.double() @ router.double()
    rel = float((moe.router_logits(h, router).double() - want64).abs()
                .max() / want64.abs().max())
    emit({"phase": phase, "config": name, "event": "router_precision",
          "tokens": h.shape[0], "max_rel_err_vs_float64": rel,
          "limit": ROUTER_RTOL,
          "tf32": torch.backends.cuda.matmul.allow_tf32})
    if rel > ROUTER_RTOL:
        raise AssertionError(f"{name}: router logits {rel} off float64")

    # The first decode step on the kernels against the plain path, the
    # same token fed to both, each layer's routes beside each other.
    for sub_depth in sorted({2, cfg.n_layers}):
        sub = dataclasses.replace(cfg, n_layers=sub_depth)
        sub_params = dict(params, layers=_map(lambda t: t[:sub_depth],
                                              params["layers"]))
        got_routes, want_routes = [], []
        with _recording_routes(got_routes):
            got, nxt = _first_decode(torch, sub, sub_params, prompts[0],
                                     max_len)
        with _recording_routes(want_routes), \
                layers.forced_backend("torch"):
            want, _ = _first_decode(torch, sub, sub_params, prompts[0],
                                    max_len, nxt)
        flipped = _route_flips(f"{name} {sub_depth} layers", got_routes,
                               want_routes, sub_depth,
                               gated=sub_depth == 2)
        got, want = (x[..., :cfg.vocab_size] for x in (got, want))
        cos = _cosine(got, want)
        finite = bool(torch.isfinite(got).all())
        gated = sub_depth == 2 and not flipped
        emit({"phase": phase, "config": name,
              "event": "first_decode_vs_plain", "layers": sub_depth,
              "finite": finite, "cosine": cos,
              "max_abs_err": max_err(got, want), "routes_flipped": flipped,
              "gated": gated,
              "argmax_equal": int(got.argmax()) == int(want.argmax())})
        if not finite or (gated and cos < 0.999):
            raise AssertionError(f"{name}: {sub_depth}-layer first decode "
                                 f"logits off the plain path (cosine "
                                 f"{cos}, finite {finite})")
        del sub_params

    # The main path.
    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    drops = []
    since, rsince = dict(_build.LAUNCHES), dict(ops.RESOLVED)
    torch.cuda.synchronize()
    t_drain = time.monotonic()
    with _recording_drops(drops):
        eng.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t_drain
    launches = {k: _build.LAUNCHES[k] - since[k] for k in _build.LAUNCHES}
    # the MoE decoders' widths: held out of the cost model's fit
    implied = _picks_gate(f"{phase} {name}", launches,
                          picks_since(rsince), group="held-out")
    _healthy(phase, name, reqs, eng)
    steps = len(eng.monitor.records)
    tokens = [list(r.out_tokens) for r in reqs]
    prefill_drops, decode_drops = _drops_by_forward(drops, cfg.n_layers,
                                                    batch)
    emit({"phase": phase, "config": name, "event": "drain",
          "layers": cfg.n_layers, "prompt_lens": list(lens),
          "new_tokens": new_tokens, "wall_s": wall,
          "decode_steps": steps,
          "decode_ms_per_step_median": _step_ms(eng),
          "dropped_per_prefill": prefill_drops,
          "dropped_per_decode_step": decode_drops,
          "launches": {k: launches[k] for k in SERVE_MOE_PATH},
          "tokens": tokens})
    # Decode masks the padded vocab; a first token comes from the
    # prefill's unmasked logits, as in the reference (ROADMAP C), so it is
    # counted, not gated.
    over = [t for ts in tokens for t in ts[1:] if t >= cfg.vocab_size]
    emit({"phase": phase, "config": name, "event": "vocab",
          "decode_tokens_past_vocab": len(over),
          "first_tokens_past_vocab": [ts[0] for ts in tokens
                                      if ts[0] >= cfg.vocab_size],
          "vocab": [cfg.vocab_size, cfg.padded_vocab]})
    if over:
        raise AssertionError(f"{name}: decode tokens past vocab_size "
                             f"{over}")
    _tiles_gate(phase, launches)
    want_b2, want_b3 = cfg.n_layers * len(lens), cfg.n_layers * steps
    want_g16 = want_b3 if cfg.n_heads // cfg.n_kv_heads > 8 else 0
    if _attention(launches) != want_b2 or \
            launches["paged_attention"] != want_b3 or \
            launches["paged_attention_g16"] != want_g16:
        raise AssertionError(
            f"{name}: B2/B7 launches {_attention(launches)} (want "
            f"{want_b2}), B3 {launches['paged_attention']} (want "
            f"{want_b3}), on its 16-warp kernel "
            f"{launches['paged_attention_g16']} (want {want_g16})")
    for k in dict.fromkeys((*SERVE_MOE_PATH, *implied)):
        total[k] = total.get(k, 0) + launches[k]
        implied_total[k] = implied_total.get(k, 0) + implied.get(k, 0)

    # Each request alone, after the path's counts are read.
    alone, alone_drops = [], []
    for p in prompts:
        one = Engine(cfg, params, max_len=max_len, device="cuda")
        r = one.submit(p, new_tokens)
        with _recording_drops(alone_drops):
            one.drain()
        _healthy(phase, f"{name} alone", [r], one)
        alone.append(list(r.out_tokens))
        del one, r          # and its page pool, before the next engine's
        gc.collect()
    alone_decode_drops = _drops_by_forward(alone_drops, cfg.n_layers,
                                           batch)[1]
    no_decode_drops = not any(decode_drops) and not any(
        alone_decode_drops)
    differing = sum(a != b for x, y in zip(tokens, alone)
                    for a, b in zip(x, y))
    emit({"phase": phase, "config": name, "event": "mixed_vs_alone",
          "decode_drops_mixed": sum(decode_drops),
          "decode_drops_alone": sum(alone_decode_drops),
          "tokens_differing": differing, "gated": no_decode_drops})
    if no_decode_drops and tokens != alone:
        raise AssertionError(f"{name}: mixed-batch tokens {tokens} != "
                             f"each request alone {alone}")

    # Where a decode step's time goes (moonshot whole), and the routed
    # experts' GEMMs alone: one layer's _expert_ffn at the decode
    # capacity, every expert's weights read.
    trace = None
    if depth is None:
        trace = trace_decode(torch, cfg, params, prompts, max_len,
                             f"{phase} {name}")
    lp = {k: params["layers"]["moe"][k][0] for k in ("w1", "w3", "w2")}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    buf = torch.randn((cfg.n_experts, caps["decode"], cfg.d_model),
                      generator=gen, device="cuda").to(torch.bfloat16)
    ffn_ms = Timer("cuda").ms(lambda: moe._expert_ffn(lp, buf))
    expert_bytes = sum(t.numel() * t.element_size() for t in lp.values())
    ffn = {"expert_ffn_ms_per_layer": ffn_ms,
           "expert_ffn_ms_per_step": ffn_ms * cfg.n_layers,
           "expert_bytes_per_layer": expert_bytes,
           "bound_ms_per_layer": expert_bytes / HBM_BYTES_PER_S * 1e3}
    if trace is not None:
        bmm = trace.get("op_device_ms", {}).get("aten::bmm")
        ffn.update(traced_bmm_ms_per_step=bmm,
                   traced_bmm_share_of_busy=(
                       bmm / trace["device_busy_ms"]
                       if bmm and trace["device_busy_ms"] else None),
                   port_kernels_ms_per_step=trace["port_kernels_ms"],
                   device_busy_ms_per_step=trace["device_busy_ms"],
                   device_idle_share=trace["device_idle_share"])
    emit({"phase": phase, "config": name, "event": "expert_gemms",
          "card": card_line(), **ffn})
    return dict(layers=cfg.n_layers, weights_bytes=weights,
                experts=cfg.n_experts, top_k=cfg.top_k, capacity=caps,
                decode_steps=steps, dropped_per_prefill=prefill_drops,
                decode_drops=sum(decode_drops),
                decode_ms_per_step=_step_ms(eng),
                mixed_equals_alone=tokens == alone,
                seconds=time.monotonic() - t0, **ffn)


# ---------------------------------------------------------------------------
# Phase 15: the SSM and hybrid decoders whole.
# ---------------------------------------------------------------------------
# mamba2-780m (1.6 GB of bf16 weights) and hymba-1.5b (3.2 GB), whole.
SERVE_SSM = ("mamba2-780m", "hymba-1.5b")
# The serve cell's prompts, and for hymba one of 1 536 tokens, so its
# window (1 024 keys) binds at prefill and at every decode step.
SERVE_SSM_LENS = {"mamba2-780m": SERVE_LENS,
                  "hymba-1.5b": SERVE_LENS + (1536,)}
SERVE_SSM_MAX_LEN = 2048
# B1's bf16 tiles (hymba's MLP) and B2 (hymba's attention); mamba2's
# layers reach no kernel of the port (its block is plain PyTorch, as the
# reference's is plain jnp).
SERVE_SSM_PATH = ("matmul_os", "matmul_os_prefill", "matmul_os_decode",
                  "flash_attention")
# Layer 0's final SSM state after a 511-token prefill, the chunked SSD
# against the per-token recurrence on the same bf16 inputs, over the
# state's largest magnitude: both sum in float32, in other orders.
SSD_STATE_RTOL = 1e-3


def serve_ssm_phase(torch, args):
    """mamba2-780m (48 attention-free layers of a Mamba2 block, state 128,
    48 heads of 64) and hymba-1.5b (32 layers of attention, 25 q heads
    over 5 kv heads, beside a Mamba2 block of state 16; a 1 024-key window
    on all but layers 0, 16 and 31; SwiGLU MLP of 5 504), each whole at
    full width in bf16, random weights from ``--seed``, through ``Engine``
    on the slot cache (its SSM state per row beside the K/V), decode batch
    4, 16 new tokens, ``max_len`` 2 048, the serve cell's prompts plus one
    of 1 536 tokens for hymba; one config after the other, with a
    collection between them.  Per config, gates: the first decode logits
    at 2 layers at cosine >= 0.999 of the plain path's (the full depth's
    reported); at 2 layers the chunked SSD prefill's layer-0 state within
    ``SSD_STATE_RTOL`` of the per-token recurrence's and its logits at
    cosine >= 0.999; every request DONE, 0 demotions; no decode token past
    ``vocab_size``; every B1 launch on its tiles; B2/B7 launches equal to
    the autotuner's picks (``_picks_gate``), the full-attention and the
    windowed layers' calls counted apart, each layers x (prompts + decode
    steps), and no B3; the mixed batch's tokens equal each request's
    alone; a ``prefill_chunk=128`` run DONE, its tokens that differ from
    the whole prompts' counted.  Reported: weights' and SSM state's
    bytes, prefill tokens/s (one row at the longest prompts, four rows of
    511), decode ms/step, the decode step traced with the Mamba2 blocks'
    device time.  Returns the path's launches over the two drains."""
    import gc

    from repro_torch.kernels import _build

    phase = "serve_ssm"
    t_phase = time.monotonic()
    _build.reset_launches()
    total = {k: 0 for k in SERVE_SSM_PATH}
    implied_total = {}
    per_config = {}
    for name in SERVE_SSM:
        # an engine and its handles refer to each other: the earlier
        # config's weights go only with a collection
        gc.collect()
        torch.cuda.empty_cache()
        per_config[name] = _serve_ssm_config(torch, args, name, total,
                                             implied_total)
    missing = [k for k in total if total[k] <= 0 and implied_total.get(k)]
    if missing or not total["matmul_os"] or not _attention(total):
        raise AssertionError(f"kernels never launched on {phase}: "
                             f"{missing or total}")
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase, "configs": per_config,
          "launches_by_path": total})
    return total


def _ssm_ranges():
    """Each ``ssm.mamba_apply`` call inside a profiler range named
    ``ssm.mamba_apply`` (``TRACED_OPS``), for the duration."""
    from torch.profiler import record_function

    from repro_torch.models import ssm

    def wrap(orig):
        def apply(*args, **kwargs):
            with record_function("ssm.mamba_apply"):
                return orig(*args, **kwargs)
        return apply
    return _wrapped(ssm, "mamba_apply", wrap)


def _ssd_vs_recurrence(torch, cfg, params, prompt, max_len, phase):
    """At full width and 2 layers, bf16: ``lm.prefill`` of ``prompt`` with
    the port's chunked SSD, and with every chunked call replaced by the
    per-token recurrence from the same state (what the reference serves).
    Layer 0's SSD sees the same inputs on both: its final state must lie
    within ``SSD_STATE_RTOL`` of the recurrence's largest magnitude; layer
    1's inputs differ by bf16 roundings of layer 0's output (the chunked
    form rounds each chunk's output to bf16, as the reference's does), so
    its state is reported and the logits gated at cosine >= 0.999."""
    from repro_torch.models import lm, ssm

    sub = dataclasses.replace(cfg, n_layers=2)
    sub_params = dict(params, layers=_map(lambda t: t[:2], params["layers"]))
    toks = torch.as_tensor(prompt[None], device="cuda")
    got, cache = lm.prefill(sub_params, toks, sub, max_len=max_len)

    def wrap(orig):
        # a prefill always hands the block its (zero) state
        def recurrent(xh, dt, a, bmat, cmat, chunk, s0):
            return ssm._ssd_recurrent(xh, dt, a, bmat, cmat, s0)
        return recurrent

    with _wrapped(ssm, "_ssd_chunked", wrap):
        want, rcache = lm.prefill(sub_params, toks, sub, max_len=max_len)
    rel = [float((cache["ssm"][i] - rcache["ssm"][i]).abs().max()
                 / rcache["ssm"][i].abs().max()) for i in range(2)]
    got, want = (x[..., :cfg.vocab_size] for x in (got, want))
    cos = _cosine(got, want)
    emit({"phase": phase, "config": cfg.name,
          "event": "chunked_ssd_vs_recurrence", "layers": 2,
          "prompt_tokens": len(prompt), "chunk": cfg.ssm_chunk,
          "state_max_rel_err": rel, "state_rtol_layer0": SSD_STATE_RTOL,
          "layer0_conv_tail_equal": bool(torch.equal(cache["conv"][0],
                                                     rcache["conv"][0])),
          "logits_cosine": cos, "logits_max_abs_err": max_err(got, want),
          "argmax_equal": int(got.argmax()) == int(want.argmax())})
    if rel[0] > SSD_STATE_RTOL or cos < 0.999 \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name}: the chunked SSD prefill is off "
                             f"the per-token recurrence (state {rel}, "
                             f"logits cosine {cos})")


def _serve_ssm_config(torch, args, name: str, total, implied_total):
    """``serve_ssm`` for one config, whole: its gates, its launches added
    into ``total`` and the launches its picks imply into
    ``implied_total``.  Returns its summary."""
    import gc

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.dataflow import AttentionProblem
    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import SchedulerConfig

    phase, max_len, new_tokens = "serve_ssm", SERVE_SSM_MAX_LEN, 16
    lens, batch = SERVE_SSM_LENS[name], SERVE_BATCH
    t0 = time.monotonic()
    cfg = configs.get(name)
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    state_row = cfg.n_layers * cfg.ssm_heads * cfg.ssm_state \
        * cfg.ssm_headdim * 4
    conv_row = cfg.n_layers * (cfg.ssm_conv - 1) \
        * (cfg.d_inner + 2 * cfg.ssm_state) * 4
    windows = [cfg.layer_window(i) for i in range(cfg.n_layers)]
    full = [i for i, w in enumerate(windows) if w is None] \
        if cfg.has_attention else []
    windowed = len(windows) - len(full) if cfg.has_attention else 0
    emit({"phase": phase, "config": name, "event": "init_model",
          "family": cfg.family, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "d_head": cfg.d_head, "d_ff": cfg.d_ff, "d_inner": cfg.d_inner,
          "ssm_heads": cfg.ssm_heads, "ssm_state": cfg.ssm_state,
          "ssm_headdim": cfg.ssm_headdim, "ssm_chunk": cfg.ssm_chunk,
          "window": cfg.attn_window, "full_attention_layers": full,
          "vocab": [cfg.vocab_size, cfg.padded_vocab],
          "tied": cfg.tie_embeddings, "weights_bytes": weights,
          "weights_gb": weights / 1e9,
          "ssm_state_bytes_per_row": state_row,
          "ssm_state_bytes_at_batch": state_row * batch,
          "conv_tail_bytes_per_row": conv_row,
          "seconds": time.monotonic() - t0})
    prompts = _prompts(cfg, args.seed, lens)

    # The first decode step on the kernels against the plain path, the
    # same token fed to both.
    for sub_depth in sorted({2, cfg.n_layers}):
        sub = dataclasses.replace(cfg, n_layers=sub_depth)
        sub_params = dict(params, layers=_map(lambda t: t[:sub_depth],
                                              params["layers"]))
        got, nxt = _first_decode(torch, sub, sub_params, prompts[0],
                                 max_len)
        with layers.forced_backend("torch"):
            want, _ = _first_decode(torch, sub, sub_params, prompts[0],
                                    max_len, nxt)
        got, want = (x[..., :cfg.vocab_size] for x in (got, want))
        cos = _cosine(got, want)
        finite = bool(torch.isfinite(got).all())
        emit({"phase": phase, "config": name,
              "event": "first_decode_vs_plain", "layers": sub_depth,
              "finite": finite, "cosine": cos,
              "max_abs_err": max_err(got, want), "gated": sub_depth == 2,
              "argmax_equal": int(got.argmax()) == int(want.argmax())})
        if not finite or (sub_depth == 2 and cos < 0.999):
            raise AssertionError(f"{name}: {sub_depth}-layer first decode "
                                 f"logits off the plain path (cosine "
                                 f"{cos}, finite {finite})")
        del sub_params
    _ssd_vs_recurrence(torch, cfg, params, prompts[SERVE_LENS.index(511)],
                       max_len, phase)

    # The main path.
    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    since, rsince = dict(_build.LAUNCHES), dict(ops.RESOLVED)
    torch.cuda.synchronize()
    t_drain = time.monotonic()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t_drain
    launches = {k: _build.LAUNCHES[k] - since[k] for k in _build.LAUNCHES}
    picks = picks_since(rsince)
    # the SSM configs' widths: held out of the cost model's fit
    implied = _picks_gate(f"{phase} {name}", launches, picks,
                          group="held-out")
    _healthy(phase, name, reqs, eng)
    steps = len(eng.monitor.records)
    tokens = [list(r.out_tokens) for r in reqs]
    slot = eng._scheduler.cache
    emit({"phase": phase, "config": name, "event": "drain",
          "layers": cfg.n_layers, "prompt_lens": list(lens),
          "new_tokens": new_tokens, "decode_batch": batch,
          "wall_s": wall, "decode_steps": steps,
          "decode_ms_per_step_median": _step_ms(eng),
          "slot_cache_bytes": {k: slot[k].numel() * slot[k].element_size()
                               for k in lm.CACHE_KEYS if k in slot},
          "launches": {k: launches[k] for k in (*SERVE_SSM_PATH,
                                                "kv_stationary",
                                                "paged_attention")},
          "tokens": tokens})
    # decode masks the padded vocab; a first token comes from the
    # prefill's unmasked logits, as in the reference: counted, not gated
    over = [t for ts in tokens for t in ts[1:] if t >= cfg.vocab_size]
    emit({"phase": phase, "config": name, "event": "vocab",
          "decode_tokens_past_vocab": len(over),
          "first_tokens_past_vocab": [ts[0] for ts in tokens
                                      if ts[0] >= cfg.vocab_size]})
    if over:
        raise AssertionError(f"{name}: decode tokens past vocab_size "
                             f"{over}")
    _tiles_gate(phase, launches)
    # attention calls by window, from the picks: every whole prompt's
    # prefill and every decode step runs each layer's attention once
    calls = {}
    for (problem, _), n in picks.items():
        if isinstance(problem, AttentionProblem):
            key = str(problem.window)
            calls[key] = calls.get(key, 0) + n
    forwards = len(lens) + steps
    want = {str(w): n * forwards for w, n in (
        (None, len(full)), (cfg.attn_window, windowed)) if n}
    emit({"phase": phase, "config": name, "event": "attention_by_window",
          "calls": calls, "want": want, "full_layers": len(full),
          "windowed_layers": windowed,
          "forwards": forwards, "b2_b7_launches": _attention(launches),
          "paged_attention": launches["paged_attention"]})
    if calls != want or _attention(launches) != sum(want.values()) \
            or launches["paged_attention"]:
        raise AssertionError(f"{name}: attention calls by window {calls} "
                             f"(want {want}), B2/B7 launches "
                             f"{_attention(launches)}, B3 "
                             f"{launches['paged_attention']}")
    for k in dict.fromkeys((*SERVE_SSM_PATH, *implied)):
        total[k] = total.get(k, 0) + launches[k]
        implied_total[k] = implied_total.get(k, 0) + implied.get(k, 0)

    # Each request alone, after the path's counts are read.  Alone and
    # mixed give every kernel and every torch.matmul the same shapes (a
    # prefill is one row, a decode step the slot cache's max_batch rows),
    # so a difference is one row's result depending on another's.
    alone = []
    for p in prompts:
        one = Engine(cfg, params, max_len=max_len, device="cuda")
        r = one.submit(p, new_tokens)
        one.drain()
        _healthy(phase, f"{name} alone", [r], one)
        alone.append(list(r.out_tokens))
        del one, r
        gc.collect()
    first = next(((i, j, a, b) for i, (x, y) in enumerate(zip(tokens, alone))
                  for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
    emit({"phase": phase, "config": name, "event": "mixed_vs_alone",
          "tokens_differing": sum(a != b for x, y in zip(tokens, alone)
                                  for a, b in zip(x, y)),
          "first_difference": first, "gated": True})
    if first is not None:
        raise AssertionError(
            f"{name}: request {first[0]}'s token {first[1]} is {first[2]} "
            f"mixed and {first[3]} alone, at the same shapes")

    # Chunked prefill: 128-token chunks through lm.prefill_chunk.
    ceng = Engine(cfg, params, max_len=max_len, device="cuda",
                  scheduler_config=SchedulerConfig(prefill_chunk=SERVE_CHUNK))
    creqs = [ceng.submit(p, new_tokens) for p in prompts]
    ceng.drain()
    _healthy(phase, f"{name} chunked", creqs, ceng)
    chunked = [list(r.out_tokens) for r in creqs]
    # the chunked SSD passes the state at other boundaries (and rounds
    # each chunk's output to bf16 at others): counted, not gated; the
    # first differing token of each request says where greedy decode
    # left the whole prompt's path
    emit({"phase": phase, "config": name, "event": "chunked",
          "prefill_chunk": SERVE_CHUNK,
          "chunks": sum(-(-n // SERVE_CHUNK) for n in lens
                        if n > SERVE_CHUNK),
          "tokens_differing_from_whole": sum(
              a != b for x, y in zip(tokens, chunked) for a, b in zip(x, y)),
          "first_difference_by_request": [
              next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
              for x, y in zip(tokens, chunked)],
          "decode_ms_per_step_median": _step_ms(ceng)})
    del ceng, creqs
    gc.collect()

    # Prefill throughput by CUDA events (median of 3 after one warm-up):
    # one row at the two longest prompts, as the scheduler prefills, and
    # four rows of 511 tokens.
    prefill = {}
    for rows, n in ([(1, len(p)) for p in prompts[-2:]]
                    + [(batch, SERVE_LENS[-1])]):
        toks = torch.as_tensor(np.stack(_prompts(cfg, args.seed + rows,
                                                 [n] * rows)), device="cuda")
        lm.prefill(params, toks, cfg, max_len=max_len)
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lm.prefill(params, toks, cfg, max_len=max_len)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[1]
        prefill[f"{rows}x{n}"] = {"ms": ms,
                                  "tokens_per_s": rows * n / ms * 1e3}
    emit({"phase": phase, "config": name, "event": "throughput",
          "card": card_line(), "prefill": prefill,
          "decode_batch": batch,
          "decode_ms_per_step_median": _step_ms(eng)})

    # Where a decode step's time goes, the Mamba2 blocks' device time
    # apart (batch 4: the longest prompts).
    with _ssm_ranges():
        trace = trace_decode(torch, cfg, params, prompts[-batch:], max_len,
                             f"{phase} {name}")
    ssm_ms = trace.get("op_device_ms", {}).get("ssm.mamba_apply")
    busy = trace["device_busy_ms"]
    emit({"phase": phase, "config": name, "event": "ssm_share",
          "card": card_line(), "ssm_device_ms_per_step": ssm_ms,
          "device_busy_ms_per_step": busy,
          "ssm_share_of_busy": ssm_ms / busy if ssm_ms and busy else None,
          "device_idle_share": trace["device_idle_share"],
          "port_kernels_ms_per_step": trace["port_kernels_ms"]})
    return dict(layers=cfg.n_layers, weights_bytes=weights,
                ssm_state_bytes_per_row=state_row, decode_steps=steps,
                decode_ms_per_step=_step_ms(eng), prefill=prefill,
                device_busy_ms_per_step=busy,
                device_idle_share=trace["device_idle_share"],
                ssm_device_ms_per_step=ssm_ms,
                mixed_equals_alone=True,
                seconds=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# Phase 16: the audio encoder-decoder, whole.
# ---------------------------------------------------------------------------
def _audio_sub(params, depth: int):
    """whisper's parameters cut to ``depth`` encoder and decoder layers."""
    return dict(params, layers=_map(lambda t: t[:depth], params["layers"]),
                encoder=dict(params["encoder"], layers=_map(
                    lambda t: t[:depth], params["encoder"]["layers"])))


def _greedy(torch, params, cfg, toks, frames, steps: int):
    """``lm.prefill`` of ``toks`` over ``frames``, then ``steps`` greedy
    ``lm.decode_step``s, synchronized after each, on the host clock.
    Returns (tokens per row, prefill ms, decode ms per step, cache)."""
    from repro_torch.models import lm

    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = lm.prefill(params, toks, cfg,
                               max_len=SERVE_AUDIO_MAX_LEN,
                               enc_frames=frames)
    nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    out, step_ms = [nxt], []
    for _ in range(steps):
        t0 = time.monotonic()
        logits, cache = lm.decode_step(params, cache, out[-1], cfg)
        if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            raise AssertionError(f"{cfg.name}: non-finite decode logits")
        out.append(logits.argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    tokens = torch.cat(out, dim=1).tolist()
    return tokens, prefill_ms, sorted(step_ms)[len(step_ms) // 2], cache


def serve_audio_phase(torch, args):
    """whisper-tiny whole (4 encoder and 4 decoder layers, d_model 384, 6
    heads of 64, SwiGLU MLP of 1 536, vocab 51 865 padded to 51 968), bf16,
    random weights from ``--seed``, through the model's entry points (the
    engine passes no encoder frames, as the JAX engine passes none):
    ``lm.prefill(..., enc_frames=)`` of 4 rows of 64 tokens over 1 500
    encoder frames a row (whisper's 30-second window after its stride-2
    conv; drawn from the seed), 16 greedy ``lm.decode_step``s off the slot
    cache and its cross K/V; then one row of 432 tokens and 16 steps, to
    ``max_len`` 448 (whisper's text context).  The encoder's
    self-attention and the cross attention are plain PyTorch (the
    reference's are jnp einsums); its MLPs and the decoder's run on B1,
    the decoder's self-attention on B2.  Gates: the first decode logits
    against the plain path at cosine >= 0.999 with 2 encoder and 2
    decoder layers (4 + 4 reported); ``lm.forward``'s logits at the last
    prompt position against ``prefill`` + ``decode_step``'s at cosine >=
    0.999 (port against port, whole); the launches equal to the picks'
    (``_picks_gate``), every B1 launch on its tiles; B1 and B2 (or B7)
    launched; no decode token past ``vocab_size``.  Reported: weights'
    and cross cache's bytes, the encoder's ms for 4 x 1 500 frames,
    prefill ms and decode ms/step on the host clock, the decode step
    traced (device busy and idle share).  Returns the path's launches."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers, lm

    phase, max_len = "serve_audio", SERVE_AUDIO_MAX_LEN
    t_phase = time.monotonic()
    cfg = configs.get(SERVE_AUDIO)
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    frames = torch.randn((SERVE_BATCH, SERVE_AUDIO_FRAMES, cfg.d_model),
                         generator=gen, device="cuda").to(torch.bfloat16)
    rows = np.stack(_prompts(cfg, args.seed,
                             [SERVE_AUDIO_PROMPT] * SERVE_BATCH))
    toks = torch.as_tensor(rows, device="cuda")
    long_toks = torch.as_tensor(
        _prompts(cfg, args.seed + 1, [SERVE_AUDIO_LONG])[0][None],
        device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    cross_bytes = 2 * cfg.n_layers * SERVE_BATCH * cfg.n_kv_heads \
        * SERVE_AUDIO_FRAMES * cfg.d_head * 2
    emit({"phase": phase, "event": "init_model", "family": cfg.family,
          "enc_layers": cfg.n_enc_layers, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "d_head": cfg.d_head, "d_ff": cfg.d_ff,
          "vocab": [cfg.vocab_size, cfg.padded_vocab],
          "params": sum(t.numel() for t in leaves),
          "weights_bytes": sum(t.numel() * t.element_size() for t in leaves),
          "enc_frames": SERVE_AUDIO_FRAMES, "max_len": max_len,
          "cross_cache_bytes_at_batch": cross_bytes,
          "encoder_logits_bytes": SERVE_BATCH * cfg.n_heads
          * SERVE_AUDIO_FRAMES ** 2 * 4,
          "seconds": time.monotonic() - t_phase})

    # The first decode step on the kernels against the plain path, the
    # same token fed to both, one row over its frames.
    for depth in (2, cfg.n_layers):
        sub = dataclasses.replace(cfg, n_layers=depth, n_enc_layers=depth)
        sub_params = _audio_sub(params, depth)
        got, nxt = _first_decode(torch, sub, sub_params, rows[0], max_len,
                                 enc_frames=frames[:1])
        with layers.forced_backend("torch"):
            want, _ = _first_decode(torch, sub, sub_params, rows[0], max_len,
                                    nxt, enc_frames=frames[:1])
        got, want = (x[..., :cfg.vocab_size] for x in (got, want))
        cos = _cosine(got, want)
        finite = bool(torch.isfinite(got).all())
        emit({"phase": phase, "event": "first_decode_vs_plain",
              "layers": [depth, depth], "finite": finite, "cosine": cos,
              "max_abs_err": max_err(got, want), "gated": depth == 2,
              "argmax_equal": int(got.argmax()) == int(want.argmax())})
        if not finite or (depth == 2 and cos < 0.999):
            raise AssertionError(f"{depth}+{depth}-layer first decode "
                                 f"logits off the plain path (cosine {cos})")
        del sub_params

    # The teacher-forced forward against prefill + one decode step, whole.
    fwd, _ = lm.forward(params, toks, cfg, enc_frames=frames)
    _, cache = lm.prefill(params, toks[:, :-1], cfg, max_len=max_len,
                          enc_frames=frames)
    dec, _ = lm.decode_step(params, cache, toks[:, -1:], cfg)
    a, b = fwd[:, -1, :cfg.vocab_size], dec[:, :cfg.vocab_size]
    cos = _cosine(a, b)
    emit({"phase": phase, "event": "forward_vs_decode", "rows": SERVE_BATCH,
          "prompt_tokens": SERVE_AUDIO_PROMPT, "cosine": cos,
          "max_abs_err": max_err(a, b),
          "argmax_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1)))})
    if cos < 0.999 or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"forward's last-position logits off prefill "
                             f"+ decode_step's (cosine {cos})")
    del fwd, cache, dec

    # The main path: counts zeroed just before, read just after.
    _build.reset_launches()
    rsince = dict(ops.RESOLVED)
    batch, pre_ms, dec_ms, cache = _greedy(torch, params, cfg, toks,
                                           frames, SERVE_AUDIO_STEPS)
    long, long_pre_ms, long_dec_ms, lcache = _greedy(
        torch, params, cfg, long_toks, frames[:1], SERVE_AUDIO_STEPS)
    launches = dict(_build.LAUNCHES)
    implied = _picks_gate(phase, launches, picks_since(rsince),
                          group="held-out")
    _tiles_gate(phase, launches)
    path = tuple(dict.fromkeys(SERVE_AUDIO_PATH + tuple(
        k for k, v in implied.items() if v)))
    over = [t for ts in batch + long for t in ts[1:] if t >= cfg.vocab_size]
    emit({"phase": phase, "event": "main_path", "card": card_line(),
          "batch": [SERVE_BATCH, SERVE_AUDIO_PROMPT],
          "long_row": [1, SERVE_AUDIO_LONG], "decode_steps":
          SERVE_AUDIO_STEPS, "prefill_ms_host": pre_ms,
          "decode_ms_per_step_host_median": dec_ms,
          "long_prefill_ms_host": long_pre_ms,
          "long_decode_ms_per_step_host_median": long_dec_ms,
          "long_row_kv_len": int(lcache["index"]),
          "cross_cache_bytes": sum(cache[k].numel() * cache[k].element_size()
                                   for k in lm.CROSS_KEYS),
          "launches": {k: launches[k] for k in path},
          "decode_tokens_past_vocab": len(over),
          "tokens": batch + long})
    missing = [k for k in path if launches[k] <= 0 and implied.get(k)]
    if over or missing or not launches["matmul_os"] \
            or not _attention(launches) or launches["paged_attention"] \
            or int(lcache["index"]) != max_len:
        raise AssertionError(f"{phase}: tokens past vocab {over}, kernels "
                             f"not launched {missing}, or launches "
                             f"{launches} (long row at "
                             f"{int(lcache['index'])} of {max_len})")
    del cache, lcache

    # The encoder alone and the prefill, by CUDA events (median of 3
    # after one warm-up), and a second host-clock pass, now that every
    # lookup is a hit.
    def events_ms(fn):
        fn()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[1]

    enc_ms = events_ms(lambda: lm.encode(params, frames, cfg))
    pre_ev = events_ms(lambda: lm.prefill(params, toks, cfg, max_len=max_len,
                                          enc_frames=frames))
    _, pre2, dec2, cache = _greedy(torch, params, cfg, toks, frames,
                                   SERVE_AUDIO_STEPS)
    emit({"phase": phase, "event": "throughput", "card": card_line(),
          "encoder_ms_events": enc_ms,
          "encoder_frames": [SERVE_BATCH, SERVE_AUDIO_FRAMES],
          "prefill_ms_events": pre_ev, "prefill_ms_host_warm": pre2,
          "decode_ms_per_step_host_warm": dec2,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_AUDIO_PROMPT
          / pre_ev * 1e3})

    # Where a decode step's time goes: steps at batch 4 off the cache
    # (each rewrites the same position, so every call is the same step).
    tok = toks[:, -1:]
    rec = _device_trace(torch, lambda: lm.decode_step(params, cache, tok,
                                                      cfg), 6)
    emit({"phase": phase, "event": "decode_trace",
          "decode_batch": SERVE_BATCH, "steps": 6, **rec})
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase,
          "launches_by_path": {k: launches[k] for k in path}})
    return {k: launches[k] for k in path}


# ---------------------------------------------------------------------------
# Phase 17: train.
# ---------------------------------------------------------------------------
TRAIN = "qwen3-1.7b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 8, 1e-3
TRAIN_CHECK_LAYERS = 2
# The loss on the kernels against the plain path at 2 layers of full width,
# bf16 (B1's and B2's roundings against cuBLAS's and the plain
# attention's), relative; every gradient tensor at cosine >= TRAIN_COSINE.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_COSINE = 0.999
# The libraries B1's launches and the dataflows the autotuner may pick for
# a forward GEMM count under (B1's basic OS and residencies, B4, B5a, B5b);
# B2's and B7's.
GEMM_LIBRARIES = ("matmul_os", "matmul_rmw", "matmul_ws_stripe",
                  "matmul_is_stripe")
ATTENTION_LIBRARIES = ("flash_attention", "kv_stationary")
# B1's basic OS and its prefill tile (every GEMM of a 2 048-token step, the
# backward's included, has over 16 rows); B2 or B7, as picked.
TRAIN_PATH = ("matmul_os", "matmul_os_prefill")
# B1's and B2's autograd ops, their backward nodes and the optimizer's
# range, whose device time a traced step sums apart.
_EVALUATE = "autograd::engine::evaluate_function: GeneratedBackwardFor_"
TRAIN_TRACED_OPS = ("repro_torch::matmul_fused", "repro_torch::attention",
                    _EVALUATE + "repro_torch_matmul_fused_defaultBackward",
                    _EVALUATE + "repro_torch_attention_defaultBackward",
                    "train.adamw")
TRAIN_DRILL = dict(steps=10, global_batch=4, seq_len=128, lr=3e-3,
                   ckpt_every=4, remat="dots")
TRAIN_DRILL_CRASH = 6


def _launched(keys) -> int:
    from repro_torch.kernels import _build

    return sum(_build.LAUNCHES[k] for k in keys)


def _train_batch(cfg, batch: int, seq: int, seed: int, step: int = 0):
    from repro_torch.data.pipeline import SyntheticLMDataset

    return SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, with_enc_frames=cfg.is_encoder_decoder,
        d_model=cfg.d_model, enc_seq_ratio=cfg.enc_seq_ratio).batch(
        step, "cuda")


def _grads_vs_plain(torch, cfg, params, batch, remat: str):
    """The loss and every gradient on the kernels and on the plain path
    (``forced_backend("torch")``), with the kernels' launches of B1 (every
    GEMM library) and B2/B7: forward from an eval pass, backward as the
    rest of the gradient's.  Returns (loss, plain loss, grads, plain
    grads, launches {"b1"/"b2": (forward, backward)}, every library's
    launches of the gradient's pass)."""
    from repro_torch.kernels import _build
    from repro_torch.models import layers, lm
    from repro_torch.train import step as tstep

    loss_fn = tstep.make_loss_fn(cfg, remat)
    _build.reset_launches()
    with torch.no_grad():
        lm.loss_fn(params, batch, cfg, remat="none")
    fwd = (_launched(GEMM_LIBRARIES), _launched(ATTENTION_LIBRARIES))
    _build.reset_launches()
    loss, _, grads = tstep.value_and_grad(loss_fn, params, batch)
    torch.cuda.synchronize()
    every = dict(_build.LAUNCHES)
    counts = {"b1": (fwd[0], _launched(GEMM_LIBRARIES) - fwd[0]),
              "b2": (fwd[1], _launched(ATTENTION_LIBRARIES) - fwd[1])}
    with layers.forced_backend("torch"):
        ploss, _, pgrads = tstep.value_and_grad(loss_fn, params, batch)
    return loss, ploss, grads, pgrads, counts, every


def _grad_agreement(torch, grads, pgrads, f32_tol=None) -> dict:
    """Per tensor: cosine (the lowest, and where), the largest |error|
    relative to the plain gradient's largest |value|; with ``f32_tol``,
    whether every element is within atol + rtol |plain|."""
    from repro_torch.optim.adamw import leaves

    plain = dict(leaves(pgrads))
    worst_cos, worst_rel, within = (1.0, None), (0.0, None), True
    for path, g in leaves(grads):
        p = plain[path]
        name = ".".join(path)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient {name}")
        cos = _cosine(g, p) if float(p.float().norm()) > 0 else 1.0
        if cos < worst_cos[0]:
            worst_cos = (cos, name)
        err = (g.float() - p.float()).abs()
        rel = float(err.max()) / max(float(p.float().abs().max()), 1e-30)
        if rel > worst_rel[0]:
            worst_rel = (rel, name)
        if f32_tol is not None:
            within &= bool((err <= f32_tol["atol"] + f32_tol["rtol"]
                            * p.float().abs()).all())
    return {"min_cosine": worst_cos[0], "min_cosine_at": worst_cos[1],
            "max_rel_err": worst_rel[0], "max_rel_err_at": worst_rel[1],
            "tensors": len(plain),
            **({"within_f32_tol": within} if f32_tol is not None else {})}


def b1_backward_rows(torch, timer, cfg, tokens: int) -> dict:
    """B1 at the backward's shapes of qwen3-1.7b's MLP over ``tokens``
    rows, as ``kernels/autograd.py`` launches them (basic OS, bf16 in and
    out): dX = dU W^T (M tokens, K d_ff -> N d_model for the gate and up
    projections; K d_model -> N d_ff for the down projection) and dW =
    X^T dU (M d_model, K tokens, N d_ff; M d_ff, K tokens, N d_model).
    Each held against its plain version (B1's tolerance plus one bf16 ulp
    an element, a row within one bf16 ulp of its norm: a bf16 output) and
    timed beside it and ``torch.matmul``, with its bound; and the bytes
    the backward's transposed copies write a step."""
    from repro_torch.bench.common import bound
    from repro_torch.kernels import matmul_df, ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    d, dff, t = cfg.d_model, cfg.d_ff, tokens
    rows = {}
    for label, (m, k, n) in (("dX gate/up", (t, dff, d)),
                             ("dX down", (t, d, dff)),
                             ("dW gate/up", (d, t, dff)),
                             ("dW down", (dff, t, d))):
        a = (torch.randn((m, k), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(
            torch.bfloat16)

        def run():
            return matmul_df.matmul_df(a, b, matmul_df.BASIC_OS,
                                       out_dtype=torch.bfloat16)

        # bf16 outputs: each element within B1's bound plus one bf16 ulp;
        # a row may hold several such roundings, so its error norm is
        # held to one bf16 ulp (2^-8) of its norm
        tol = dict(B1_TOL, row_rtol=2.0 ** -8)
        err = check("matmul_os", run(), ref.matmul_ref(a, b, torch.bfloat16),
                    shape=f"backward {label} M={m} K={k} N={n}",
                    plus_bf16_ulp=True, **tol)
        bnd = bound((m * k + k * n + m * n) * 2, 2.0 * m * k * n)
        rows[label] = dict(
            shape=f"M={m} K={k} N={n} bf16 -> bf16", max_abs_err=err,
            ms=timer.ms(run), plain_ms=timer.ms(
                lambda: ref.matmul_ref(a, b, torch.bfloat16)),
            library_ms=timer.ms(lambda: torch.matmul(a, b)),
            library_call="torch.matmul (bf16 out)", bound_ms=bnd[0],
            bound_by=bnd[1], tolerance=tol)
        emit({"kernel_timing_detail": "matmul_os", "backward": label,
              "card": card_line(), **rows[label]})
    # per layer: W^T of w1, w3, w2 and X^T of x (twice: gate and up) and of
    # the hidden h, each written once and read once by its GEMM
    per_layer = (3 * d * dff + 2 * t * d + t * dff) * 2
    rows["transposed_copy_bytes_per_step"] = per_layer * cfg.n_layers
    return rows


class _RangedOptimizer:
    """An optimizer whose ``update`` runs inside a profiler range
    (``train.adamw``)."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, *args):
        from torch.profiler import record_function

        with record_function("train.adamw"):
            return self.opt.update(*args)


def _train_whole(torch, cfg, args, remat: str) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` + AdamW (cosine
    schedule) on the whole model from its seed's weights, each on its
    step's batch of the synthetic dataset: the losses, step ms by CUDA
    events (median after the first), peak allocated bytes, and B1's and
    B2's launches of the first step and every kernel's of the run (the
    counts zeroed just before it)."""
    import gc

    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, schedules
    from repro_torch.train import step as tstep

    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    opt = AdamW(lr_fn=lambda s: schedules.cosine(s, 1, TRAIN_STEPS,
                                                 TRAIN_LR))
    state = opt.init(params)
    step_fn = tstep.make_train_step(cfg, opt, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches = [], [], None
    _build.reset_launches()
    for step in range(TRAIN_STEPS):
        batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed, step)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step_fn(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        if launches is None:
            launches = {"b1": _launched(GEMM_LIBRARIES),
                        "b2": _launched(ATTENTION_LIBRARIES),
                        "b1_tiles": {k: _build.LAUNCHES[k] for k in (
                            "matmul_os_prefill", "matmul_os_decode")}}
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    every = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    moments = sum(t.numel() * t.element_size()
                  for tree in (state.m, state.v) for t in _leaves(tree))
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    del params, state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    return {"remat": remat, "losses": losses, "step_ms": ms,
            "step_ms_median": step_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
            "peak_allocated_bytes": peak, "weights_bytes": weights,
            "moments_bytes": moments, "launches_first_step": launches,
            "launches": every}


def train_phase(torch, args):
    """Training on the card (ROADMAP A13): ``lm.loss_fn`` under autograd,
    B1 and B2 carrying gradients (``kernels/autograd.py``), AdamW in place,
    the fault-tolerant driver.  Gates, each raising:

    1. qwen3-1.7b at full width and 2 layers, bf16, batch 4 x 512 from the
       synthetic dataset: the loss on the kernels within
       ``TRAIN_LOSS_RTOL`` of ``forced_backend("torch")``'s on the card,
       every gradient tensor at cosine >= ``TRAIN_COSINE``; the 28-layer
       figures reported, not gated.
    2. One step's loss and gradients of each of the ten smoke configs
       (float32: B1's f32 walk, B2's f32 kernel, hymba's windows) against
       the plain path within B2's f32 tolerance, under ``remat="dots"``;
       B1 launched in forward and backward where the config has an MLP
       (backward exactly 7/3 of forward: dX and dW of each projection and
       the gate's pre-activation), B2 (or B7) in forward and, recomputed
       under "dots", as often in backward where it has attention (mamba2
       has neither).
    3. qwen3-1.7b whole (28 layers, bf16, tied embeddings): ``TRAIN_STEPS``
       steps of ``make_train_step`` + AdamW (cosine) at batch 4 x 512 for
       each of remat "none", "dots" and "full": losses finite, the mean of
       the last 3 below the first 3's; step ms (CUDA events), tokens/s,
       peak allocated; B1's launches a step split into forward, backward
       and recompute against 3, 7 and (full) 3 a layer, and B2's.
    4. One traced step (remat "none"): busy and idle share, device time
       by B1 forward, B1 backward, B2 forward, the plain attention
       backward and AdamW; the loss's forward and backward timed apart.
    5. The crash drill: ``TrainDriver`` (its steps under deterministic
       algorithms) on qwen3-1.7b's smoke config in bf16 on the kernels (a
       checkpoint of a few MB), ``REPRO_FAIL_AT_STEP`` at step 6, resumed:
       parameters, moments and the last loss equal an uninterrupted run's
       bit for bit.

    The kernels phase's B1 rows gain the backward's shapes
    (``b1_backward_rows``).  Returns (the path's launches, the B1
    backward rows)."""
    import gc

    from repro_torch import configs
    from repro_torch.bench.common import Timer
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import health
    from repro_torch.runtime.driver import TrainDriver, TrainJobConfig
    from repro_torch.train import step as tstep

    phase = "train"
    t_phase = time.monotonic()
    cfg = configs.get(TRAIN)

    # 1. The gradients against the plain path, 2 layers then all 28.
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed)
    for depth in (TRAIN_CHECK_LAYERS, cfg.n_layers):
        sub = dataclasses.replace(cfg, n_layers=depth)
        sub_params = dict(params, layers=_map(lambda t: t[:depth],
                                              params["layers"]))
        loss, ploss, grads, pgrads, counts, every = _grads_vs_plain(
            torch, sub, sub_params, batch, "none")
        rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
        agree = _grad_agreement(torch, grads, pgrads)
        gated = depth == TRAIN_CHECK_LAYERS
        emit({"phase": phase, "event": "grads_vs_plain", "layers": depth,
              "batch": [TRAIN_BATCH, TRAIN_SEQ], "loss": float(loss),
              "plain_loss": float(ploss), "loss_rel_err": rel,
              "gated": gated, "launches": counts, **agree})
        if gated and (rel > TRAIN_LOSS_RTOL or not math.isfinite(rel)
                      or agree["min_cosine"] < TRAIN_COSINE):
            raise AssertionError(
                f"{depth}-layer loss or gradients off the plain path: "
                f"loss rel {rel}, {agree}")
        del sub_params, grads, pgrads
        gc.collect()
        torch.cuda.empty_cache()
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 2. Every family trains a step (float32 smoke configs).
    for arch in configs.ARCH_NAMES:
        scfg = configs.get_smoke(arch)
        sp = lm.init_model(scfg, seed=args.seed, device="cuda")
        sb = _train_batch(scfg, 2, 64, args.seed)
        loss, ploss, grads, pgrads, counts, every = _grads_vs_plain(
            torch, scfg, sp, sb, "dots")
        agree = _grad_agreement(torch, grads, pgrads, F32_TOL)
        loss_ok = abs(float(loss) - float(ploss)) <= F32_TOL["atol"] \
            + F32_TOL["rtol"] * abs(float(ploss))
        has_mlp = bool(scfg.d_ff) and scfg.family != "ssm" and (
            not scfg.n_experts or scfg.n_shared_experts)
        (b1f, b1b), (b2f, b2b) = counts["b1"], counts["b2"]
        launch_ok = ((b1f > 0) == has_mlp and 3 * b1b == 7 * b1f
                     and (b2f > 0) == scfg.has_attention and b2b == b2f)
        emit({"phase": phase, "event": "family_step", "config": scfg.name,
              "family": scfg.family, "dtype": scfg.param_dtype,
              "loss": float(loss), "plain_loss": float(ploss),
              "loss_within_f32_tol": loss_ok, "launches": counts,
              "launches_ok": launch_ok, **agree})
        if not (loss_ok and agree["within_f32_tol"] and launch_ok):
            raise AssertionError(f"{scfg.name}: a train step off the plain "
                                 f"path or launches {counts}: {agree}")
        del sp, grads, pgrads
    gc.collect()
    torch.cuda.empty_cache()

    # 3. The whole model, every remat mode.
    timer = Timer("cuda")
    backward_rows = b1_backward_rows(torch, timer, cfg,
                                     TRAIN_BATCH * TRAIN_SEQ)
    del timer
    runs = {}
    for remat in lm.REMAT:
        rec = _train_whole(torch, cfg, args, remat)
        runs[remat] = rec
        if remat == "none":      # the main path: its run's launches
            path = rec["launches"]
        emit({"phase": phase, "event": "whole", "config": cfg.name,
              "layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
              "card": card_line(), **rec})
        losses = rec["losses"]
        if not all(math.isfinite(x) for x in losses) \
                or sum(losses[-3:]) >= sum(losses[:3]):
            raise AssertionError(f"remat {remat}: losses {losses} not "
                                 f"finite or not falling")
    n = cfg.n_layers
    fwd = 3 * n
    split = {"forward": fwd,
             "backward": runs["none"]["launches_first_step"]["b1"] - fwd,
             "recompute": runs["full"]["launches_first_step"]["b1"]
             - runs["none"]["launches_first_step"]["b1"]}
    implied = {"forward": 3 * n, "backward": 7 * n, "recompute": 3 * n}
    b2 = {r: runs[r]["launches_first_step"]["b2"] for r in runs}
    emit({"phase": phase, "event": "b1_launches_per_step", "split": split,
          "implied": implied, "b2_by_remat": b2,
          "b2_implied": {"none": n, "dots": 2 * n, "full": 2 * n},
          "b1_by_remat": {r: runs[r]["launches_first_step"]["b1"]
                          for r in runs},
          "losses_equal_across_remat": runs["none"]["losses"]
          == runs["dots"]["losses"] == runs["full"]["losses"]})
    missing = [k for k in TRAIN_PATH if not path.get(k)] + (
        [] if any(path.get(k) for k in ATTENTION_LIBRARIES)
        else ["attention"])
    if split != implied or b2 != {"none": n, "dots": 2 * n, "full": 2 * n} \
            or runs["dots"]["launches_first_step"]["b1"] \
            != runs["none"]["launches_first_step"]["b1"] or missing:
        raise AssertionError(f"B1/B2 launches a step {split}, {b2} against "
                             f"{implied}; not launched: {missing}")

    # 4. One traced step, and the loss and AdamW timed apart.
    params = lm.init_model(cfg, seed=args.seed, device="cuda")
    opt = _RangedOptimizer(AdamW(lr_fn=lambda s: TRAIN_LR))
    state = [opt.init(params)]
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed)
    step_fn = tstep.make_train_step(cfg, opt, remat="none")

    def one_step():
        _, state[0], _ = step_fn(params, state[0], batch)

    one_step()
    rec = _device_trace(torch, one_step, 2, ops=TRAIN_TRACED_OPS)
    with torch.no_grad():
        hidden, _ = lm.forward_hidden(params, batch["tokens"], cfg)
    table = params["embed"]["table"]

    def loss_pass():
        x = hidden.detach().requires_grad_()
        w = table.detach().requires_grad_()
        lm.chunked_cross_entropy(x, w, batch["targets"], cfg).backward()

    times = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss_pass()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    emit({"phase": phase, "event": "train_trace", "config": cfg.name,
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": "none", "steps": 2,
          "loss_fwd_bwd_ms_events": sorted(times[1:])[1], **rec})
    del params, state, hidden, table
    gc.collect()
    torch.cuda.empty_cache()

    # 5. The crash drill.
    dcfg = dataclasses.replace(configs.get_smoke(TRAIN),
                               param_dtype="bfloat16", act_dtype="bfloat16")
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def job(name):
            return TrainJobConfig(arch=dcfg, seed=args.seed,
                                  ckpt_dir=os.path.join(work, name),
                                  **TRAIN_DRILL)

        _build.reset_launches()
        clean = TrainDriver(job("clean")).run()
        drill_launches = {"b1": _launched(GEMM_LIBRARIES),
                          "b2": _launched(ATTENTION_LIBRARIES)}
        os.environ["REPRO_FAIL_AT_STEP"] = str(TRAIN_DRILL_CRASH)
        try:
            TrainDriver(job("crashed")).run()
            raise AssertionError("the armed crash did not fire")
        except health.SimulatedFailure:
            pass
        finally:
            os.environ.pop("REPRO_FAIL_AT_STEP", None)
        driver = TrainDriver(job("crashed"))
        resumed_from = driver.ckpt.latest_step()
        resumed = driver.run(resume=True)
        same = resumed.step == clean.step and \
            resumed.last_loss == clean.last_loss and all(
                torch.equal(a, b) for ta, tb in (
                    (clean.params, resumed.params),
                    (clean.opt_state.m, resumed.opt_state.m),
                    (clean.opt_state.v, resumed.opt_state.v))
                for (_, a), (_, b) in zip(leaves(ta), leaves(tb)))
        ckpt_bytes = sum(
            os.path.getsize(os.path.join(root, f))
            for root, _, files in os.walk(os.path.join(work, "clean"))
            for f in files if f == "arrays.npz") // max(
            len(driver.ckpt.steps()), 1)
        emit({"phase": phase, "event": "crash_drill", "config": dcfg.name,
              "dtype": dcfg.param_dtype, **TRAIN_DRILL,
              "crash_at": TRAIN_DRILL_CRASH, "resumed_from": resumed_from,
              "final_step": resumed.step, "last_loss": resumed.last_loss,
              "clean_last_loss": clean.last_loss, "bit_identical": same,
              "checkpoint_bytes": ckpt_bytes, "launches_clean_run":
              drill_launches, "health": driver.health_report()})
        if not same or not drill_launches["b1"] or not drill_launches["b2"]:
            raise AssertionError("the resumed run's parameters differ from "
                                 "the uninterrupted run's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase, "launches_by_path": path})
    return path, backward_rows


# Device kernels of the serving paths, by the name of their __global__
# function (B1's bf16 basic OS is gemm_tc.cuh's two tiles; its int8 and
# packed basic OS is gemm_tc_i8.cuh's two; every other B1 launch is
# gemm_common.cuh's walk_kernel, or a cluster walk of gemm_cluster.cuh,
# as the autotuned B5a and B5b at some prefill down projections are;
# B9's basic OS is binary_mm.cu's two tiles, its WS/IS walks
# binary_kernel; B2's bf16 kernel is flash_tc_kernel, B7's
# kv_cluster_kernel; B3's chunks and their merge are one paged_kernel).
KERNEL_FUNCTIONS = {"tc_prefill_kernel": "matmul_os_prefill",
                    "tc_decode_kernel": "matmul_os_decode",
                    "i8_prefill_kernel": "matmul_os_i8_prefill",
                    "i8_decode_kernel": "matmul_os_i8_decode",
                    "walk_kernel": "matmul_os",
                    "ws_stripe_cluster_kernel": "matmul_ws_stripe_cluster",
                    "is_stripe_cluster_kernel": "matmul_is_stripe_cluster",
                    "walk_cluster_kernel": "matmul_os_cluster|rmw_cluster",
                    "walk_tma_kernel": "matmul_os_cluster|rmw_cluster",
                    "kv_cluster_kernel": "kv_stationary_cluster",
                    "bin_prefill_kernel": "binary_mm_prefill",
                    "bin_decode_kernel": "binary_mm_decode",
                    "binary_kernel": "binary_mm",
                    "flash_tc_kernel": "flash_attention",
                    "paged_kernel": "paged_attention"}


# aten ops (and ranges) whose device time a trace sums apart: the MoE
# layer's routed expert GEMMs (no other op on the port's kernel path calls
# bmm); the Mamba2 blocks, where ``_ssm_ranges`` marks them.
TRACED_OPS = ("aten::bmm", "ssm.mamba_apply")


def _device_trace(torch, run, repeats: int, ops=TRACED_OPS) -> dict:
    """A ``torch.profiler`` trace of ``repeats`` calls of ``run``: the
    device is busy for the union of its kernel and copy intervals, idle
    for the rest of the calls' host-clock time.  Kernel time per call is
    summed by the port's kernels and by the other kernels' names, and by
    the ``ops`` (op or range names) that ran, each counted where no op of
    its name encloses it.  The trace's own host cost is in the traced
    ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(repeats):
            run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        # a range's own device-side marker is no kernel
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.name in ops:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    def outermost(ev):
        parent = ev.cpu_parent
        while parent is not None:
            if parent.name == ev.name:
                return False
            parent = parent.cpu_parent
        return True

    # the device time of each of ``ops`` (its kernels, by the profiler's
    # op -> launch links), per call of ``run``
    op_us = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU \
                and ev.name in ops and outermost(ev):
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            op_us[ev.name] = op_us.get(ev.name, 0.0) + us
    port, other = {}, {}
    for name, us in by_name.items():
        key = next((k for f, k in KERNEL_FUNCTIONS.items() if f in name),
                   None)
        bucket, key = (port, key) if key else (other, name[:80])
        bucket[key] = bucket.get(key, 0.0) + us / repeats / 1e3
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:8])
    return {"card": card_line(), "device_events": len(spans),
            "traced_ms": wall_us / repeats / 1e3,
            "device_busy_ms": busy_us / repeats / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if spans else None,
            "port_kernels_ms": port,
            "other_device_ms": sum(other.values()),
            "top_other_ms": top,
            **({"op_device_ms": {k: us / repeats / 1e3
                                 for k, us in op_us.items()}}
               if op_us else {})}


def trace_decode(torch, cfg, params, prompts, max_len, phase: str,
                 steps: int = 6):
    """Where a decode step's time goes: ``steps`` decode steps at batch
    ``len(prompts)`` (after every prompt is admitted), traced; every ms is
    per step.  Returns the trace's record."""
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    for p in prompts:
        eng.submit(p, 2 * steps + len(prompts) + 2)
    for _ in prompts:        # one admission per tick
        eng.step()
    rec = _device_trace(torch, eng.step, steps)
    emit({"phase": phase, "event": "decode_trace",
          "decode_batch": len(prompts), "steps": steps, **rec})
    return rec


def trace_prefill(torch, cfg, params, prompt, max_len, phase: str,
                  repeats: int = 2, top: int = 12):
    """Where a prefill's time goes: ``lm.prefill`` of ``prompt`` (after one
    untraced call), traced on the device; then one prefill under
    ``cProfile``, whose ``top`` functions by own host time (the wait for
    the card included, as ``synchronize``; cProfile's own cost inflates
    every Python call) say what the host spends it on.  Every ms is per
    prefill."""
    import cProfile
    import pstats

    from repro_torch.models import lm

    toks = torch.as_tensor(prompt[None], device="cuda")

    def run():
        lm.prefill(params, toks, cfg, max_len=max_len)

    run()
    rec = _device_trace(torch, run, repeats)
    prof = cProfile.Profile()
    t0 = time.monotonic()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    profiled_ms = (time.monotonic() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    emit({"phase": phase, "event": "prefill_trace",
          "prefill_tokens": len(prompt), "repeats": repeats, **rec,
          "host_profiled_ms": profiled_ms,
          "host_top_own_ms": {
              f"{os.path.basename(f)}:{line} {fn}": [tt * 1e3, calls]
              for (f, line, fn), (_, calls, tt, _, _) in own}})


def _map(fn, tree):
    """``fn`` on every tensor leaf (a ``PackedWeights`` maps its own)."""
    return {k: _map(fn, v) if isinstance(v, dict)
            else v.map(fn) if hasattr(v, "LEAVES") else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif hasattr(v, "LEAVES"):
            yield from (getattr(v, f) for f in v.LEAVES
                        if getattr(v, f) is not None)
        else:
            yield v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--layers", type=int, default=28,
                    help="decoder depth (qwen3-1.7b has 28)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drill", nargs=4, default=None,
                    metavar=("MODE", "JOURNAL_DIR", "OUT", "CASE"),
                    help="one process of a serve_recovery crash drill")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    if args.drill:
        return drill_main(*args.drill)
    # the autotuner's store: this run's own (its drills share it), never
    # one that earlier runs left under the home directory
    store = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    atexit.register(shutil.rmtree, store, True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(store, "autotune.json")
    # float32 references run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs
    from repro_torch.bench.common import Timer
    from repro_torch.kernels import _build
    from repro_torch.core.dataflow import registered_kernels

    t_start = time.monotonic()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    cfg = configs.get("qwen3-1.7b")

    if "build" in phases:
        t0 = time.monotonic()
        built = _build.build_all()
        emit({"phase": "build", "seconds": time.monotonic() - t0,
              "per_kernel_seconds": built})
        for name, log in _build.BUILD_LOGS.items():
            emit({"ptxas": name, "log": log.strip().splitlines()[-12:]})
        tensor_core_check()

    records = {}
    if "kernels" in phases:
        records = kernel_phase(torch, cfg, Timer("cuda"))

    paths = {}
    if "autotune" in phases:
        autotune_phase(torch)
    if "dataflows" in phases:
        paths["dataflows"] = dataflows_phase(torch)
    if "quantized" in phases:
        paths["quantized"] = quantized_phase(torch)
    for phase, path, mlp in (
            ("serve", SERVE_PATH, {}),
            ("serve_binary", SERVE_BINARY_PATH, {"binary_mlp": True}),
            ("serve_packed", SERVE_PACKED_PATH, {"packed_weights": True,
                                                 "packed_weight_bits": 4})):
        if phase in phases:
            paths[phase] = serve_path(torch, dataclasses.replace(
                cfg, n_layers=args.layers, **mlp), args, phase, path)
    if "serve_recovery" in phases:
        paths["serve_recovery"] = serve_recovery_phase(
            torch, dataclasses.replace(cfg, n_layers=args.layers), args)
    if "serve_int8kv" in phases:
        paths["serve_int8kv"] = serve_int8kv_phase(
            torch, dataclasses.replace(cfg, n_layers=args.layers), args)
    if "serve_dense" in phases:
        paths["serve_dense"] = serve_dense_phase(torch, args)
    if "serve_f32" in phases:
        paths["serve_f32"] = serve_f32_phase(torch, args)
    if "serve_moe" in phases:
        paths["serve_moe"] = serve_moe_phase(torch, args)
    if "serve_ssm" in phases:
        paths["serve_ssm"] = serve_ssm_phase(torch, args)
    if "serve_audio" in phases:
        paths["serve_audio"] = serve_audio_phase(torch, args)
    if "train" in phases:
        paths["train"], backward = train_phase(torch, args)
        records.setdefault("matmul_os", {})["backward"] = backward

    kernels = []
    for name, reg in registered_kernels().items():
        rec = records.get(name, {})
        # A kernel's own path: the first of these that runs it.
        own = next((p for p in ("serve", "serve_binary", "serve_packed",
                                "serve_recovery", "serve_int8kv",
                                "serve_dense", "serve_f32", "serve_moe",
                                "serve_ssm", "serve_audio",
                                "dataflows", "quantized", "train")
                    if paths.get(p, {}).get(name)), None)
        if own is None and "kernels_phase_launches" in rec:
            # on no serving path (B7's int8 paths, as in the reference):
            # its launches in the kernels phase's checks
            own, paths.setdefault("kernels", {})[name] = \
                "kernels", rec["kernels_phase_launches"]
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        kernels.append({   # every kernel of the port is CUDA C++ so far
            "name": name, "route": "cuda", "source": reg.source,
            "replaces": reg.replaces,
            "launches": paths.get(own, {}).get(name), "path": own,
            "launches_by_path": by_path,
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "plain_ms": rec.get("plain_ms"), "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"), "shape": rec.get("shape"),
            **{k: rec[k] for k in ("float32", "long_row", "down", "tile",
                                   "cluster", "ctas", "is_walk", "sq2048",
                                   "split", "packed4", "chunk",
                                   "slot_decode", "bf16_ms", "flash_ms",
                                   "f32_ms", "library_why", "d16", "group5",
                                   "hymba", "pages", "whisper", "backward")
               if k in rec},
        })
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.monotonic() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
