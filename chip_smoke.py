#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase, as the gate runs it
    python3 chip_smoke.py --phases card,build,kernels   # a quicker kernel check
    python3 chip_smoke.py --phases card,build,kernels,dataflows
    python3 chip_smoke.py --phases card,build,kernels,quantized

Phases, each printing JSON lines:

1. ``card``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: every kernel built from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), with its time.
3. ``kernels``: each kernel held against its plain PyTorch version on the
   card, at the full-width qwen3-1.7b shapes of the serving path, in bf16,
   with the tolerance stated per kernel; then each timed by CUDA events
   beside its plain version, the one PyTorch library call that computes
   the same function (where there is one; timed for the record, never on
   the port's path) and its bound on an H100.  The GEMM dataflows (B1's
   residencies, B4, B5a, B5b) run each of the nine canonical specs at
   qwen3-1.7b's MLP shapes, the paper's layer grid and small odd shapes: each
   runs through the kernel ``matmul_df.plan`` names, matches the plain
   version and equals B1's output bit for bit, or raises ``ValueError``
   naming the shared memory it needs.  B7 is held against the plain
   version with B2's tolerances.  B9 is held bit for bit at every anchor
   and epilogue stage at the served binary-MLP shapes; B8 at int8 bit for
   bit, and at f32/bf16 within B1's tolerance, on the ResNet-18 layers,
   every anchor equal to OS; each infeasible anchor raises naming its
   bytes.
4. ``dataflows``: the bench twins (``repro_torch.bench``): Fig. 2 (basic
   OS/WS/IS), Fig. 7 (auxiliary residencies) on the paper's layer grid
   and qwen3-1.7b's MLP GEMMs, and attention's OS vs WS anchor at prefill
   512 and 2048; every row printed, every dataflow kernel launched.
5. ``quantized``: the bench twins of the paper's quantized datapaths
   (``repro_torch.bench.conv``, ``repro_torch.bench.binary``): fused
   against unfused conv epilogue per anchor, the ResNet-18 conv body at
   int8 per anchor, and Fig. 9 (binary against int8 and bf16 conv on the
   VGG layers); every row printed, B8 and B9 launched.
6. ``serve``: full-width qwen3-1.7b (random bf16 weights from a seed, depth
   cut to ``--layers``) served through ``Engine.submit``/``drain``:
   every request DONE, no demotion, every kernel launched, mixed-length
   batch tokens == each request served alone; prefill tokens/s and decode
   ms/step; then a ``torch.profiler`` trace of 6 decode steps at batch 4:
   device busy ms/step, idle share, kernel ms/step by name.
7. ``serve_binary``: the same, for qwen3-1.7b with its binary MLP
   (``binary_mlp=True``: +-1 weights bit-packed, the two projections
   through B9); besides, at every layer of a two-layer prefill the
   binary MLP on the kernels equals its plain version bit for bit.

The ``kernels`` record gives each kernel's launches on its path (serve:
B1, B2, B3; serve_binary: B9, B2, B3; dataflows: B1, B2, B4, B5a, B5b,
B7; quantized: B8, B9), counted from 0 just before the path runs. The
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
              "serve_binary")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    from repro_torch.bench.common import card_line as line
    return line()


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(name: str, got, want, atol: float, rtol: float, row_rtol: float,
          shape: str):
    """Element-wise |got - want| <= atol + rtol*|want|, and per output row
    (the last axis) ||got - want|| <= row_rtol*||want||: a row whose
    every element sits inside the element limit but is shifted as a
    whole (a skipped KV block, a page read from the wrong id) fails the
    row check.  A row whose reference is all zeros must be all zeros."""
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    limit = float((atol + rtol * want.float().abs()).min())
    ok = bool((diff.abs() <= atol + rtol * want.float().abs()).all())
    d = diff.reshape(-1, diff.shape[-1]).norm(dim=-1)
    w = want.float().reshape(-1, diff.shape[-1]).norm(dim=-1)
    row_err = float((d / w.clamp_min(1e-30)).max())
    row_ok = bool((d <= row_rtol * w).all())
    emit({"check": name, "shape": shape, "max_abs_err": err,
          "max_row_rel_err": row_err, "atol": atol, "rtol": rtol,
          "row_rtol": row_rtol, "ok": ok and row_ok})
    if not ok:
        raise AssertionError(f"{name} {shape}: max |err| {err} exceeds "
                             f"atol {atol} + rtol {rtol}*|ref| "
                             f"(tightest {limit})")
    if not row_ok:
        raise AssertionError(f"{name} {shape}: a row's error norm is "
                             f"{row_err} of its reference's, over "
                             f"{row_rtol}")
    return err


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------
def kernel_phase(torch, cfg, timer):
    import torch.nn.functional as F

    from repro_torch.bench.common import bound
    from repro_torch.kernels import attention_df, matmul_df, ref

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    records = {}
    d, dff = cfg.d_model, cfg.d_ff

    # B1: f32 output of bf16 operands accumulated in f32 by both sides;
    # only the order of the k sums differs.
    b1_tol = dict(atol=1e-3, rtol=1e-3, row_rtol=1e-4)
    errs = []
    head = None
    for m in (1, 4, 137, 512):
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
                errs.append(check("matmul_os", got, want, shape=shape,
                                  **b1_tol))
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
    # The decode shapes (M = batch 4), where the weight stream bounds B1.
    for k, n, act in ((d, dff, "silu"), (dff, d, None)):
        a = randn(4, k)
        w = randn(k, n, std=(2.0 / (k + n)) ** 0.5)
        bnd = bound((4 * k + k * n) * 2 + 4 * n * 4, 2.0 * 4 * k * n)
        emit({"kernel_timing_detail": "matmul_os",
              "shape": f"decode M=4 K={k} N={n} act={act}",
              "ms": timer.ms(lambda: matmul_df.matmul_os(a, w,
                                                         activation=act)),
              "library_ms": timer.ms(lambda: torch.matmul(a, w)),
              "bound_ms": bnd[0], "bound_by": bnd[1]})
    a, w, shape = head
    m, k = a.shape
    n = w.shape[1]
    bnd = bound((m * k + k * n) * 2 + m * n * 4, 2.0 * m * k * n)
    records["matmul_os"] = dict(
        shape=shape, max_abs_err=max(errs),
        ms=timer.ms(lambda: matmul_df.matmul_os(a, w)),
        plain_ms=timer.ms(lambda: ref.matmul_fused_ref(a, w)),
        library_ms=timer.ms(lambda: torch.matmul(a, w)),
        library_call="torch.matmul (bf16 out)",
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=b1_tol)

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
    q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, sq, dh), \
        randn(1, hkv, sq, dh)
    pairs = sq * (sq + 1) // 2
    bnd = bound((hq + 2 * hkv) * sq * dh * 2 + hq * sq * dh * 2,
                4.0 * dh * pairs * hq)
    records["flash_attention"] = dict(
        shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal",
        max_abs_err=max(errs),
        ms=timer.ms(lambda: attention_df.flash_attention(q, kk, vv)),
        plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=True, enable_gqa=True)),
        library_call="F.scaled_dot_product_attention(is_causal, enable_gqa)",
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=att_tol)

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
    records.update(gemm_dataflow_checks(torch, cfg, timer, gen, b1_tol))
    records.update(kv_stationary_checks(torch, cfg, timer, gen, att_tol,
                                        f32_tol))
    records.update(binary_checks(torch, cfg, timer, gen))
    records.update(conv_checks(torch, timer, gen, b1_tol))
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
            before = _build.LAUNCHES[p.kernel]
            got = ops.matmul_fused(a, w, spec=spec, out_dtype=out_dtype,
                                   **epi)
            if _build.LAUNCHES[p.kernel] != before + 1:
                raise AssertionError(f"{name} at {label} did not launch "
                                     f"{p.kernel} once")
            err = check(f"{p.kernel}[{name}]", got, want,
                        shape=label, **tol)
            errs.setdefault(p.kernel, []).append(err)
            bitwise = torch.equal(got, base)
            if not bitwise:
                diff = float((got.float() - base.float()).abs().max())
                raise AssertionError(f"{name} at {label} differs from B1's "
                                     f"output (max |diff| {diff})")
            ran.append(name)
            feasibility.append({"shape": label, "spec": name,
                                "feasible": True, "kernel": p.kernel,
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

    # Timed shapes: each kernel where its dataflow fits at full size.
    records = {}
    timed = (("matmul_rmw", "ws_basic", (56, 3, 1, 128)),
             ("matmul_ws_stripe", "ws_o_stripe", (512, dff, d)),
             ("matmul_is_stripe", "is_o_stripe", (56, 3, 1, 128)))
    for kernel, spec_name, shape in timed:
        if len(shape) == 4:
            g = common.paper_gemm(shape)
            m, k, n = g.m, g.k, g.n
            label = f"paper layer {shape} M={m} K={k} N={n} {spec_name}"
        else:
            m, k, n = shape
            label = f"M={m} K={k} N={n} {spec_name}"
        a, w = common.gemm_operands(m, k, n, dev, seed=m + n)
        spec = common.NINE_SPECS[spec_name]
        bnd = common.gemm_bound(m, k, n)
        records[kernel] = dict(
            shape=label, max_abs_err=max(errs[kernel]),
            ms=timer.ms(lambda: matmul_df.matmul_df(a, w, spec)),
            plain_ms=timer.ms(lambda: ref.matmul_fused_ref(a, w)),
            library_ms=timer.ms(lambda: torch.matmul(a, w)),
            library_call="torch.matmul (bf16 out)",
            bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol)
    return records


def kv_stationary_checks(torch, cfg, timer, gen, tol, f32_tol):
    """B7 against the plain version at qwen3-1.7b prefill widths (the
    attention-anchor bench's 512 and 2048 among them), with B2's
    tolerances; whether it also equals B2 bit for bit (the same online
    softmax step over the same KV blocks, the state kept in f32) is
    reported, not required."""
    import torch.nn.functional as F

    from repro_torch.bench.common import bound
    from repro_torch.kernels import attention_df, ref

    dev = "cuda"
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    errs, same_as_b2 = [], []
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
        got = attention_df.kv_stationary_attention(q, kk, vv, kv_len=lens,
                                                   window=window)
        want = ref.attention_ref(q, kk, vv, kv_len=lens, window=window)
        errs.append(check("kv_stationary", got, want, **tol,
                          shape=f"B={b} Sq={sq} Skv={skv} kv_len={kv_len} "
                                f"window={window}"))
        same_as_b2.append(torch.equal(got, attention_df.flash_attention(
            q, kk, vv, kv_len=lens, window=window)))
    q, kk, vv = (torch.randn(s, generator=gen, device=dev) for s in (
        (2, 4, 40, 64), (2, 2, 40, 64), (2, 2, 40, 64)))
    check("kv_stationary", attention_df.kv_stationary_attention(
        q, kk, vv, window=9), ref.attention_ref(q, kk, vv, window=9),
        shape="float32 B=2 Sq=Skv=40 D=64 window=9", **f32_tol)
    emit({"check": "kv_stationary_equals_flash_bitwise",
          "cases": same_as_b2})
    sq = 512
    q, kk, vv = randn(1, hq, sq, dh), randn(1, hkv, sq, dh), \
        randn(1, hkv, sq, dh)
    pairs = sq * (sq + 1) // 2
    bnd = bound((hq + 2 * hkv) * sq * dh * 2 + hq * sq * dh * 2,
                4.0 * dh * pairs * hq)
    return {"kv_stationary": dict(
        shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={dh} causal",
        max_abs_err=max(errs),
        ms=timer.ms(lambda: attention_df.kv_stationary_attention(q, kk, vv)),
        plain_ms=timer.ms(lambda: ref.attention_ref(q, kk, vv)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=True, enable_gqa=True)),
        library_call="F.scaled_dot_product_attention(is_causal, enable_gqa)",
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=tol,
        equals_flash_bitwise=all(same_as_b2))}


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
    every anchor equal to OS."""
    from repro_torch.bench import common
    from repro_torch.core.dataflow import BinaryEpilogue, DataflowSpec, IS, OS, WS
    from repro_torch.kernels import binary_mm, ref

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
                    got = binary_mm.binary_mm_df(a, b, k, spec,
                                                 out_dtype=out_dtype,
                                                 epilogue=epi, **kw)
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

    # Timed: the served up projection at prefill M = 511, binarized.
    m, k, n = 511, d, dff
    a, b = operands(m, k, n)
    kp = a.shape[1]
    scale = torch.full((1, n), k ** -0.5, device=dev)
    bias = torch.zeros((1, n), device=dev)
    epi = BinaryEpilogue(scale=True, bias=True, binarize=True)
    a_pm = ref.unpack_binary(a, axis=1, dtype=torch.bfloat16)
    b_pm = ref.unpack_binary(b, axis=0, dtype=torch.bfloat16)
    # The card's fastest rate for a +-1 product is the int8 tensor cores'
    # (2*M*K*N operations on the unpacked values), against the packed
    # bytes; the CUDA cores' xor+popc word rate, which this kernel runs
    # at, is reported beside it.
    moved = (m * kp + kp * n) * 4 + m * n + 2 * n * 4
    bnd = common.bound(moved, 2.0 * m * k * n, common.INT8_OPS_PER_S)
    popc = common.bound(moved, float(m * kp * n), common.POPC_WORDS_PER_S)
    for anchor in ("ws", "is"):
        emit({"kernel_timing_detail": "binary_mm",
              "shape": f"up M={m} Kp={kp} N={n} {anchor}",
              "ms": timer.ms(lambda: binary_mm.binary_mm_df(
                  a, b, k, specs[anchor], epilogue=epi, scale=scale,
                  bias=bias))})
    a4, b4 = operands(4, dff, d)
    emit({"kernel_timing_detail": "binary_mm",
          "shape": f"decode down M=4 Kp={dff // 32} N={d} float",
          "ms": timer.ms(lambda: binary_mm.binary_mm_df(
              a4, b4, dff, specs["os"], epilogue=BinaryEpilogue(
                  scale=True, bias=True), scale=scale[:, :d],
              bias=bias[:, :d]))})
    return {"binary_mm": dict(
        shape=f"served up M={m} Kp={kp} N={n} scale+bias+sign -> int8",
        max_abs_err=max(errs),
        ms=timer.ms(lambda: binary_mm.binary_mm_df(
            a, b, k, specs["os"], epilogue=epi, scale=scale, bias=bias)),
        plain_ms=timer.ms(lambda: ref.binary_matmul_fused_ref(
            a, b, k, scale=scale, bias=bias, binarize=True)),
        library_ms=timer.ms(lambda: torch.matmul(a_pm, b_pm)),
        library_call="torch.matmul on the unpacked +-1 bf16 operands",
        bound_ms=bnd[0], bound_by=bnd[1],
        rate_for_bound="int8 tensor cores, 1979 TOP/s dense, on the "
                       "unpacked +-1 values",
        popc_bound_ms=popc[0], popc_bound_by=popc[1],
        popc_rate="xor+popc word pairs at 16 popc/SM/clock, 132 SMs, "
                  "1.98 GHz", tolerance="bit for bit")}


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

    def operands(n, ih, iw, f, cin, cout, dtype):
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
    errs, feasibility = [], []
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
                        errs.append(check(f"conv2d[{anchor}]", got, want,
                                          shape=shape, **tol))
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
    emit({"check": "conv2d_all", "checks": len(errs),
          "infeasible": len(feasibility),
          "infeasible_shapes": [f["shape"] for f in feasibility]})

    # Timed: ResNet-18 (56, 3, 1, 64 -> 64) at int8 with the fused dequant.
    ih, f, s, cin, cout = 56, 3, 1, 64, 64
    conv = ConvProblem(ih=ih, iw=ih, fh=f, fw=f, s=s, cin=cin, cout=cout)
    xq, wq = operands(1, ih, ih, f, cin, cout, torch.int8)
    scale = torch.rand((1, cout), generator=gen, device=dev) * 1e-4
    bias = torch.randn((1, cout), generator=gen, device=dev)
    bnd = common.conv_bound(conv, 1, 4, common.INT8_OPS_PER_S)
    for anchor in ("ws", "is"):
        emit({"kernel_timing_detail": "conv2d",
              "shape": f"resnet18 (56,3,1,64->64) int8 dequant {anchor}",
              "ms": timer.ms(lambda: ops.conv2d_fused(
                  xq, wq, s, scale=scale, bias=bias, spec=ANCHORS[anchor]))})
    x_nchw = xb.permute(0, 3, 1, 2)
    w_lib = wb.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bnd_bf16 = common.conv_bound(conv, 2, 4, common.BF16_FLOPS_PER_S)
    emit({"kernel_timing_detail": "conv2d",
          "shape": "resnet18 (56,3,1,64->64) bf16 -> f32, OS",
          "ms": timer.ms(lambda: ops.conv2d(xb, wb, s)),
          "plain_ms": timer.ms(lambda: ref.conv2d_ref(xb, wb, s)),
          "library_ms": timer.ms(lambda: torch.nn.functional.conv2d(
              x_nchw, w_lib, stride=s)),
          "library_call": "F.conv2d (cuDNN, bf16, channels_last)",
          "bound_ms": bnd_bf16[0], "bound_by": bnd_bf16[1]})
    return {"conv2d": dict(
        shape="resnet18 (56,3,1,64->64) int8, fused dequant (scale, bias), "
              "f32 out, OS",
        max_abs_err=max(errs),
        ms=timer.ms(lambda: ops.conv2d_fused(xq, wq, s, scale=scale,
                                             bias=bias)),
        plain_ms=timer.ms(lambda: ref.conv2d_fused_ref(
            xq, wq, s, scale=scale, bias=bias)),
        library_ms=None, library_call=None,
        bound_ms=bnd[0], bound_by=bnd[1], tolerance=dict(
            int8="bit for bit", float=tol))}


# ---------------------------------------------------------------------------
# Phase 4: the bench twins of the paper's dataflow comparison.
# ---------------------------------------------------------------------------
DATAFLOW_PATH = ("matmul_os", "matmul_rmw", "matmul_ws_stripe",
                 "matmul_is_stripe", "flash_attention", "kv_stationary")


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
QUANTIZED_PATH = ("conv2d", "binary_mm")


def quantized_phase(torch):
    from repro_torch.bench import binary, conv
    from repro_torch.kernels import _build

    _build.reset_launches()
    t0 = time.monotonic()
    for bench in (conv, binary):
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


SERVE_PATH = ("matmul_os", "flash_attention", "paged_attention")
SERVE_BINARY_PATH = ("binary_mm", "flash_attention", "paged_attention")


def binary_mlp_bitwise(cfg, params, toks, max_len, phase):
    """At every layer of a two-layer prefill on the kernels, the binary
    MLP's input is recorded, and the MLP on the kernels (B9) must equal
    its plain version on that input bit for bit: the hidden +-1 int8
    activations and the float output."""
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
    for i, (p, x) in enumerate(seen):
        hidden = layers.binary_dense(p["up"], x)
        out = layers.binary_mlp_apply(p, x)
        with layers.forced_backend("torch"):
            hidden_plain = layers.binary_dense(p["up"], x)
            out_plain = layers.binary_mlp_apply(p, x)
        shape = f"layer {i} M={x.shape[0] * x.shape[1]} d={x.shape[-1]}"
        _bitwise(f"{phase} binary_mlp hidden (int8)", hidden, hidden_plain,
                 shape)
        _bitwise(f"{phase} binary_mlp out (f32)", out, out_plain, shape)
    if len(seen) != 2:
        raise AssertionError(f"recorded {len(seen)} MLP calls, want 2")


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
          "params_gib": sum(t.numel() * t.element_size()
                            for t in _leaves(params)) / 2 ** 30,
          "seconds": time.monotonic() - t0})
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    if cfg.binary_mlp:
        binary_mlp_bitwise(cfg, params, torch.as_tensor(
            prompts[0][None], device="cuda"), max_len, phase)

    # The model on the kernels against its plain PyTorch path on a small
    # input (a 17-token prompt), at full width and two layers: bf16 rounds
    # at other places in the two paths, and random weights amplify that
    # with depth, so the check is a cosine >= 0.999 of the logits at two
    # layers; the full depth's cosine is reported beside it.
    toks = torch.as_tensor(prompts[0][None], device="cuda")
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

    # Mixed-length batch == each request served alone.
    for p, r in zip(prompts, reqs):
        alone = Engine(cfg, params, max_len=max_len, device="cuda")
        h = alone.submit(p, new_tokens)
        alone.drain()
        if h.state != RequestState.DONE or h.out_tokens != r.out_tokens:
            raise AssertionError(
                f"prompt of {len(p)}: alone {h.out_tokens} != batched "
                f"{r.out_tokens}")
    emit({"phase": phase, "event": "mixed_equals_sequential", "ok": True})

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
    trace_decode(torch, cfg, params, prompts, max_len, phase)
    return {k: launches[k] for k in path}


# Device kernels of the serving paths, by the name of their __global__
# function (B1's basic OS is gemm_common.cuh's walk_kernel).
KERNEL_FUNCTIONS = {"walk_kernel": "matmul_os",
                    "binary_kernel": "binary_mm",
                    "flash_kernel": "flash_attention",
                    "paged_kernel": "paged_attention"}


def trace_decode(torch, cfg, params, prompts, max_len, phase: str,
                 steps: int = 6):
    """Where a decode step's time goes: a ``torch.profiler`` trace of
    ``steps`` decode steps at batch ``len(prompts)`` (after every prompt
    is admitted).  The device is busy for the union of its kernel and copy
    intervals; the rest of the steps' host-clock time it is idle.  Kernel
    time is summed by the port's kernels and by the other kernels' names.
    The trace's own host cost is in the traced ms/step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, params, max_len=max_len, device="cuda")
    for p in prompts:
        eng.submit(p, 2 * steps + len(prompts) + 2)
    for _ in prompts:        # one admission per tick
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
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
        bucket[key] = bucket.get(key, 0.0) + us / steps / 1e3
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:8])
    emit({"phase": phase, "event": "decode_trace", "card": card_line(),
          "decode_batch": len(prompts), "steps": steps,
          "device_events": len(spans),
          "traced_ms_per_step": wall_us / steps / 1e3,
          "device_busy_ms_per_step": busy_us / steps / 1e3,
          "device_idle_share": (1.0 - busy_us / wall_us) if spans else None,
          "port_kernels_ms_per_step": port,
          "other_device_ms_per_step": sum(other.values()),
          "top_other_ms_per_step": top})


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
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

    records = {}
    if "kernels" in phases:
        records = kernel_phase(torch, cfg, Timer("cuda"))

    paths = {}
    if "dataflows" in phases:
        paths["dataflows"] = dataflows_phase(torch)
    if "quantized" in phases:
        paths["quantized"] = quantized_phase(torch)
    for phase, path, binary in (("serve", SERVE_PATH, False),
                                ("serve_binary", SERVE_BINARY_PATH, True)):
        if phase in phases:
            paths[phase] = serve_path(torch, dataclasses.replace(
                cfg, n_layers=args.layers, binary_mlp=binary), args, phase,
                path)

    kernels = []
    for name, reg in registered_kernels().items():
        rec = records.get(name, {})
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        # A kernel's own path: the first of these that runs it.
        own = next((p for p in ("serve", "serve_binary", "dataflows",
                                "quantized") if name in paths.get(p, {})),
                   None)
        kernels.append({   # every kernel of the port is CUDA C++ so far
            "name": name, "route": "cuda", "source": reg.source,
            "replaces": reg.replaces,
            "launches": paths.get(own, {}).get(name), "path": own,
            "launches_by_path": by_path,
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "plain_ms": rec.get("plain_ms"), "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"), "shape": rec.get("shape"),
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
