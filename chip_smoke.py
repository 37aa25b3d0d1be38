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
   window, timed at both.  B2 over the int8 KV cache's K/V (int8 codes
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

The ``kernels`` record gives each kernel's launches on its path (serve:
B1 with its bf16 prefill and decode tiles, B2, B3; serve_binary: B9 with
its prefill and decode tiles, B2, B3; serve_packed: B6, B1 with its int8
prefill and decode tiles, B2, B3; serve_recovery: B1 with its bf16
prefill and decode tiles, B2 (at chunks and slot-cache decode too), B3,
counted over its in-process ``Engine`` runs; serve_int8kv: B1 with its
bf16 tiles, B2 and its int8 path; serve_dense: B1 with its bf16 tiles,
B2, B3, over its four configs; serve_f32: B1's f32 walk, B2, K1, B3;
B7's int8 paths (K2 among them), on no serving path, their launches in
the kernels phase; dataflows: B1 and its bf16 tiles, B2,
B4, B5a, B5b (B1's residencies, B4, B5a and B5b on their cluster walks),
B7 (on its cluster kernel);
quantized: B8 with its int8 and bf16 OS tiles and WS/IS walks, B9 and
its prefill tile, B1 and its int8 tiles, B6); on serve, serve_packed,
serve_int8kv and serve_dense every B1 launch, and on serve_binary every
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
import dataclasses
import json
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
              "serve_int8kv", "serve_dense", "serve_f32")


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
    """Each serve hot problem, serve_f32's problems and the paper's
    problems through ``measure_problem``; gates that every candidate
    equals basic OS, that the autotuner serves the explorer's fresh pick
    of every serve and f32 problem, and that there the pick's time is
    within ``PICK_RATIO`` of the fastest candidate's.  The paper's
    problems' agreement and that of problems held out of the cost
    model's fit (``heldout_problems``) are reported."""
    from repro_torch import configs
    from repro_torch.core import autotune, cost_model
    from repro_torch.kernels import _build

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
                  - {"paged_attention"})
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


def _first_decode(torch, cfg, params, prompt, max_len, nxt=None):
    """The first decode step's logits after ``lm.prefill`` of ``prompt``:
    off a page pool filled from the prefill's cache (page 16, B3) for a
    float cache, off the slot cache (B2; K1 under float32 queries) for an
    int8 one; ``nxt`` (the token fed, default the prefill's greedy one
    over the first ``vocab_size`` logits).  Returns (logits, nxt)."""
    from repro_torch.models import lm

    toks = torch.as_tensor(prompt[None], device="cuda")
    first, cache = lm.prefill(params, toks, cfg, max_len=max_len)
    if nxt is None:
        nxt = first[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    if lm.int8_kv(cfg):
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
    decode step and chunk), whole prompts and with ``prefill_chunk=32``.
    Gates per config and cache: the first decode logits within B2's f32
    tolerance of the plain path on the card; every request DONE, 0
    demotions; B2 launches = layers x whole prompts, B3 = layers x decode
    steps (float cache), K1 = layers x (decode steps + chunks) and none of
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

    for name in SERVE_F32:
        t0 = time.monotonic()
        cfg = configs.get_smoke(name)
        cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        params = lm.init_model(cfg, seed=args.seed, device="cuda")
        prompts = _prompts(cfg, args.seed, lens)
        for c in (cfg, cfg8):
            got, nxt = _first_decode(torch, c, params, prompts[2], max_len)
            with layers.forced_backend("torch"):
                want, _ = _first_decode(torch, c, params, prompts[2],
                                        max_len, nxt)
            check(f"{phase} {name} first decode logits", got[
                ..., :cfg.vocab_size], want[..., :cfg.vocab_size],
                shape=f"{cfg.name} {c.kv_cache_dtype} cache d_head "
                      f"{cfg.d_head}", **F32_TOL)
        L = cfg.n_layers
        tokens, steps, la = drain(cfg, params, prompts, f"{name} float")
        if _attention(la) != L * len(lens) or \
                la["paged_attention"] != L * steps or \
                _attention(la, f32=True):
            raise AssertionError(f"{name} float cache launches {la}")
        tokens8, steps8, l8 = drain(cfg8, params, prompts, f"{name} int8")
        if _attention(l8, f32=True) != L * steps8 or \
                _attention(l8) != L * (steps8 + len(lens)) or \
                l8["paged_attention"]:
            raise AssertionError(f"{name} int8 cache launches {l8}: K1/K2 "
                                 f"want {L * steps8}")
        chunked, csteps, lc = drain(cfg8, params, prompts, f"{name} chunked",
                                    prefill_chunk=chunk)
        chunks = sum(-(-n // chunk) for n in lens if n > chunk)
        whole = sum(n <= chunk for n in lens)
        if _attention(lc, f32=True) != L * (csteps + chunks) or \
                _attention(lc) != L * (csteps + chunks + whole):
            raise AssertionError(f"{name} chunked int8 launches {lc}: K1/K2 "
                                 f"want {L * (csteps + chunks)}")
        emit({"phase": phase, "config": cfg.name, "d_head": cfg.d_head,
              "heads": [cfg.n_heads, cfg.n_kv_heads], "layers": L,
              "decode_steps": {"float": steps, "int8": steps8,
                               "int8_chunked": csteps},
              "chunks": chunks,
              "launches": {"float": {k: la[k] for k in SERVE_F32_PATH},
                           "int8": {k: l8[k] for k in SERVE_F32_PATH},
                           "int8_chunked": {k: lc[k] for k in
                                            SERVE_F32_PATH}},
              "int8_tokens_differing_from_float": sum(
                  a != b for x, y in zip(tokens, tokens8)
                  for a, b in zip(x, y)),
              "chunked_tokens_differing_from_whole": sum(
                  a != b for x, y in zip(tokens8, chunked)
                  for a, b in zip(x, y)),
              "seconds": time.monotonic() - t0})
    missing = [k for k in total if total[k] <= 0
               and (k == "paged_attention" or implied_total.get(k))]
    if missing:
        raise AssertionError(f"kernels never launched on {phase}: {missing}")
    emit({"phase": phase, "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t_phase, "launches_by_path": total})
    return total


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


def _device_trace(torch, run, repeats: int) -> dict:
    """A ``torch.profiler`` trace of ``repeats`` calls of ``run``: the
    device is busy for the union of its kernel and copy intervals, idle
    for the rest of the calls' host-clock time.  Kernel time per call is
    summed by the port's kernels and by the other kernels' names.  The
    trace's own host cost is in the traced ms."""
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
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
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
            "top_other_ms": top}


def trace_decode(torch, cfg, params, prompts, max_len, phase: str,
                 steps: int = 6):
    """Where a decode step's time goes: ``steps`` decode steps at batch
    ``len(prompts)`` (after every prompt is admitted), traced; every ms is
    per step."""
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    for p in prompts:
        eng.submit(p, 2 * steps + len(prompts) + 2)
    for _ in prompts:        # one admission per tick
        eng.step()
    emit({"phase": phase, "event": "decode_trace",
          "decode_batch": len(prompts), "steps": steps,
          **_device_trace(torch, eng.step, steps)})


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

    kernels = []
    for name, reg in registered_kernels().items():
        rec = records.get(name, {})
        # A kernel's own path: the first of these that runs it.
        own = next((p for p in ("serve", "serve_binary", "serve_packed",
                                "serve_recovery", "serve_int8kv",
                                "serve_dense", "serve_f32",
                                "dataflows", "quantized")
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
                                   "f32_ms", "library_why", "d16")
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
