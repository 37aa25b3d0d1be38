#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase, as the gate runs it
    python3 chip_smoke.py --phases card,build,kernels   # a quicker kernel check
    python3 chip_smoke.py --phases card,build,kernels,dataflows
    python3 chip_smoke.py --phases card,build,kernels,quantized
    python3 chip_smoke.py --phases card,build,serve_packed --layers 2

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
   window, timed at both.  B9 is held bit for bit at every anchor
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
4. ``dataflows``: the bench twins (``repro_torch.bench``): Fig. 2 (basic
   OS/WS/IS), Fig. 7 (auxiliary residencies) on the paper's layer grid
   and qwen3-1.7b's MLP GEMMs, and attention's OS vs WS anchor at prefill
   512 and 2048; every row printed, every dataflow kernel launched.
5. ``quantized``: the bench twins of the paper's quantized datapaths
   (``repro_torch.bench.conv``, ``repro_torch.bench.binary``): fused
   against unfused conv epilogue per anchor, the ResNet-18 conv body at
   int8 per anchor, Fig. 9 (binary against int8 and bf16 conv on the
   VGG layers) and the packed-weight rows (``repro_torch.bench.packed``:
   B1 on packed 4- and 5-bit, int8 and bf16 weights at qwen3-1.7b's MLP
   shapes); every row printed, B8 (its int8 and bf16 tiles and walks),
   B9, B1 and B6 launched.
6. ``serve``: full-width qwen3-1.7b (random bf16 weights from a seed, depth
   cut to ``--layers``) served through ``Engine.submit``/``drain``:
   every request DONE, no demotion, every kernel launched, mixed-length
   batch tokens == each request served alone; prefill tokens/s and decode
   ms/step; then ``torch.profiler`` traces of the 511-token prefill and
   of 6 decode steps at batch 4: device busy ms, idle share, kernel ms by
   name, per prefill and per step; and one prefill under ``cProfile``,
   its functions with the most own host time.
7. ``serve_binary``: the same, for qwen3-1.7b with its binary MLP
   (``binary_mlp=True``: +-1 weights bit-packed, the two projections
   through B9); besides, at every layer of a two-layer prefill the
   binary MLP on the kernels equals its plain version bit for bit.
8. ``serve_packed``: the same, for qwen3-1.7b with packed 4-bit MLP
   weights (``packed_weights=True``: the three projections through B1
   with B6 decoding the planes); at every layer of a two-layer prefill
   ``up`` and ``down`` on the kernels equal their plain versions bit for
   bit on the same int8 inputs and ``gate`` (silu fused) holds B1's
   tolerance.  Its activations are quantized per tensor over the batch,
   so the mixed-batch tokens are compared with each request alone and
   the differing tokens counted, not gated.

The ``kernels`` record gives each kernel's launches on its path (serve:
B1 with its bf16 prefill and decode tiles, B2, B3; serve_binary: B9 with
its prefill and decode tiles, B2, B3; serve_packed: B6, B1 with its int8
prefill and decode tiles, B2, B3; dataflows: B1 and its bf16 tiles, B2,
B4, B5a, B5b (B1's residencies, B4, B5a and B5b on their cluster walks),
B7 (on its cluster kernel);
quantized: B8 with its int8 and bf16 OS tiles and WS/IS walks, B9 and
its prefill tile, B1 and its int8 tiles, B6); on serve and serve_packed
every B1 launch, and on serve_binary every B9 launch, is one of its tiles' (prefill plus decode),
counted from 0 just before the path runs. The
last lines are the ``{"kernels": [...]}``
record, the card line, and ``{"ok": true, "device": {...}}``. Any
failure raises, so the script exits non-zero and prints no ``ok`` line;
it also exits non-zero when no CUDA device is visible or the port's
sources are not beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ALL_PHASES = ("card", "build", "kernels", "dataflows", "quantized", "serve",
              "serve_binary", "serve_packed")


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
    f32_tol = dict(atol=1e-4, rtol=1e-4, row_rtol=1e-4)
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
    records.update(binary_checks(torch, cfg, timer, gen))
    records.update(conv_checks(torch, timer, gen, b1_tol))
    records.update(int8_packed_checks(torch, cfg, timer, gen, b1_tol))
    records["conv2d_os_i8"]["packed4"] = packed_conv_checks(torch, timer,
                                                            gen)
    for name, rec in records.items():
        emit({"kernel_timing": name, **rec})
    return records


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
    return {"kv_stationary": rec, "kv_stationary_cluster": rec}


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
                     lambda: ops.matmul_packed(aq, pw, a_scale=a_scale),
                     lambda: ref.matmul_packed_ref(
                         aq, pw, a_scale=a_scale.reshape(1, 1)),
                     common.packed_read_bytes(pw)),
                    ("int8", lambda: ops.int8_matmul_fused(aq, q, a_scale,
                                                           w_scale),
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
                                                    x_scale=x_scale)),
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
    from repro_torch.bench import binary, conv, packed
    from repro_torch.kernels import _build

    _build.reset_launches()
    t0 = time.monotonic()
    for bench in (conv, binary, packed):
        for row in bench.run("cuda"):
            emit({"phase": "quantized", **row})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    emit({"phase": "quantized", "event": "done", "card": card_line(),
          "seconds": time.monotonic() - t0, "launches": launches})
    missing = [k for k in QUANTIZED_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the quantized "
                             f"path: {missing}")
    return {k: launches[k] for k in QUANTIZED_PATH}


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
                                "matmul_os_i8_decode")}


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

    from repro_torch.kernels import _build
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import Engine, RequestState

    max_len, new_tokens, lens = 1024, 16, (17, 64, 200, 511)
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
    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(_build.LAUNCHES)
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
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if phase in SERVE_TILES:
        event, lib, prefill, decode = SERVE_TILES[phase]
        split = {lib: launches[lib], "prefill_tile": launches[prefill],
                 "decode_tile": launches[decode]}
        emit({"phase": phase, "event": event, **split,
              "tiles": [prefill, decode]})
        if split["prefill_tile"] + split["decode_tile"] != split[lib]:
            raise AssertionError(f"{lib} launches off its tiles: {split}")

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


# Device kernels of the serving paths, by the name of their __global__
# function (B1's bf16 basic OS is gemm_tc.cuh's two tiles; its int8 and
# packed basic OS is gemm_tc_i8.cuh's two; every other B1 launch is
# gemm_common.cuh's walk_kernel; B9's basic OS is binary_mm.cu's two
# tiles, its WS/IS walks binary_kernel; B2's bf16 kernel is
# flash_tc_kernel; B3's chunks and their merge are one paged_kernel).
KERNEL_FUNCTIONS = {"tc_prefill_kernel": "matmul_os_prefill",
                    "tc_decode_kernel": "matmul_os_decode",
                    "i8_prefill_kernel": "matmul_os_i8_prefill",
                    "i8_decode_kernel": "matmul_os_i8_decode",
                    "walk_kernel": "matmul_os",
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
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
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

    kernels = []
    for name, reg in registered_kernels().items():
        rec = records.get(name, {})
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        # A kernel's own path: the first of these that runs it.
        own = next((p for p in ("serve", "serve_binary", "serve_packed",
                                "dataflows", "quantized")
                    if name in paths.get(p, {})), None)
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
                                   "split", "packed4")
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
