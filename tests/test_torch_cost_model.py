"""The port's cost model (``repro_torch.core.cost_model``) against the JAX
package's (``repro.core.cost_model``) where it is free of hardware, and
its Hopper estimate on its own terms.

Table I, the observations, the packed byte counts, the four traffic
functions with their footprints, ``roofline`` and ``model_flops`` take
the same problem, spec, block and budget on both sides (the reference's
spec carries the budget as ``vmem_budget``, the port's functions take it
as ``budget``; the reference's attention state rides in 256 f32 lanes
and its blocks clamp to 8-row multiples, given to the port as
``stat_words`` and ``align``) and must give the same numbers exactly.
Problems come from the paper's grid, small odd shapes and
hypothesis-drawn convs.
"""
import itertools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import cost_model as jcm
from repro.core.dataflow import AttentionProblem as JAtt
from repro.core.dataflow import BinaryProblem as JBin
from repro.core.dataflow import ConvProblem as JConv
from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import GemmProblem as JGemm
from repro.core.dataflow import IS as JIS, OS as JOS, WS as JWS
from repro.core.dataflow import Residency as JRes
from repro_torch.bench.common import PAPER_CIN, PAPER_LAYERS
from repro_torch.core import cost_model as cm
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, DataflowSpec, GemmProblem,
                                       Residency, IS, OS, WS)
from repro_torch.kernels import matmul_df

_ST = {OS: JOS, WS: JWS, IS: JIS}
_RES = {Residency.STREAMED: JRes.STREAMED, Residency.STRIPE: JRes.STRIPE,
        Residency.WHOLE: JRes.WHOLE}
BUDGETS = (64 * 1024, 16 * 2 ** 20)


def _jspec(spec: DataflowSpec, budget: int) -> JSpec:
    return JSpec(_ST[spec.anchor], {_ST[o]: _RES[r] for o, r in spec.aux},
                 tuple(_ST[o] for o in spec.aux_priority), tuple(spec.block),
                 budget)


def _same_traffic(got: cm.Traffic, want) -> None:
    assert {k.value: v for k, v in got.reads.items()} == \
        {k.value: v for k, v in want.reads.items()}
    assert {k.value: v for k, v in got.writes.items()} == \
        {k.value: v for k, v in want.writes.items()}
    assert got.footprint == want.vmem_peak
    assert got.feasible == want.feasible
    assert got.total == want.total


def _conv_pair(ih, f, s, cin, cout, **kw):
    return (ConvProblem(ih=ih, iw=ih, fh=f, fw=f, s=s, cin=cin, cout=cout,
                        **kw),
            JConv(ih=ih, iw=ih, fh=f, fw=f, s=s, cin=cin, cout=cout, **kw))


GRID = [_conv_pair(hw, f, s, PAPER_CIN, nf) for hw, f, s, nf in PAPER_LAYERS]
PAIRS = [(a, x) for a in (OS, WS, IS) for x in (OS, WS, IS) if a != x]


# ---------------------------------------------------------------------------
# Table I and the observations.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("anchor,aux", PAIRS,
                         ids=[f"{a.value}-{x.value}" for a, x in PAIRS])
def test_table1_every_anchor_aux_pair_equals_the_reference(anchor, aux):
    for conv, jconv in GRID:
        for nv in (1, 2, 3, 4, 6):
            got = cm.table1_reduction(anchor, aux, conv, n_aux_vars=nv)
            want = jcm.table1_reduction(_ST[anchor], _ST[aux], jconv,
                                        n_aux_vars=nv)
            assert got == want, (conv, nv)


@pytest.mark.parametrize("n_aux_vars", (1, 2, 4))
def test_table1_stride2_rows_equal_the_reference(n_aux_vars):
    conv, jconv = _conv_pair(56, 3, 2, 128, 128)
    for aux in (OS, WS):
        assert cm.table1_reduction(IS, aux, conv, n_aux_vars) == \
            jcm.table1_reduction(JIS, _ST[aux], jconv, n_aux_vars)


def test_table1_refuses_what_the_reference_refuses():
    conv, jconv = _conv_pair(56, 3, 1, 128, 128)
    for a in (OS, WS, IS):
        with pytest.raises(ValueError, match="no Table-I row"):
            cm.table1_reduction(a, a, conv)
        with pytest.raises(ValueError, match="no Table-I row"):
            jcm.table1_reduction(_ST[a], _ST[a], jconv)


def test_observations_over_the_paper_grid_equal_the_reference():
    for conv, jconv in GRID:
        got = cm.paper_observations_hold(conv)
        assert got == jcm.paper_observations_hold(jconv)
        assert all(got.values()), conv


@settings(deadline=None, max_examples=40)
@given(ih=st.integers(4, 120), f=st.integers(1, 5), s=st.integers(1, 3),
       cin=st.integers(1, 512), cout=st.integers(1, 512))
def test_observations_on_drawn_convs_equal_the_reference(ih, f, s, cin,
                                                         cout):
    if f > ih:
        return
    conv, jconv = _conv_pair(ih, f, s, cin, cout)
    assert cm.paper_observations_hold(conv) == \
        jcm.paper_observations_hold(jconv)


# ---------------------------------------------------------------------------
# Byte counts.
# ---------------------------------------------------------------------------
def test_packed_byte_counts_equal_the_reference():
    for k, n, bits in itertools.product((31, 256, 2048, 6144), (7, 64, 2048),
                                        (4, 5)):
        assert cm.packed_slab_bytes(k, n, bits) == \
            jcm.packed_slab_bytes(k, n, bits)
        assert cm.packed_weight_bytes(k, n, bits) == \
            jcm.packed_weight_bytes(k, n, bits)
        assert cm.weight_stream_bytes(GemmProblem(
            5, k, n, "int8", "float32", "int32", bits)) == \
            jcm.weight_stream_bytes(JGemm(5, k, n, "int8", "float32",
                                          "int32", bits))


ALL_AUX = [
    (OS, {}), (OS, {WS: Residency.STRIPE}), (OS, {WS: Residency.WHOLE}),
    (OS, {IS: Residency.STRIPE}), (OS, {IS: Residency.WHOLE}),
    (OS, {WS: Residency.WHOLE, IS: Residency.STRIPE}),
    (OS, {WS: Residency.STRIPE, IS: Residency.STRIPE}),
    (WS, {}), (WS, {OS: Residency.STRIPE}), (WS, {IS: Residency.STRIPE}),
    (WS, {OS: Residency.WHOLE}), (IS, {}), (IS, {OS: Residency.STRIPE}),
    (IS, {WS: Residency.WHOLE}), (IS, {WS: Residency.STRIPE}),
]
GEMMS = [(37, 64, 48, "bfloat16", "float32", "float32", None),
         (512, 2048, 6144, "bfloat16", "float32", "float32", None),
         (4, 6144, 2048, "int8", "float32", "int32", 4),
         (200, 2048, 6144, "int8", "int32", "int32", 5),
         (2916, 1152, 128, "float32", "float32", "float32", None)]


@pytest.mark.parametrize("shape", GEMMS, ids=[str(g[:4]) for g in GEMMS])
def test_gemm_traffic_equals_the_reference(shape):
    p, jp = GemmProblem(*shape), JGemm(*shape)
    for (anchor, aux), block, budget in itertools.product(
            ALL_AUX, ((32, 32, 32), (128, 128, 128), (64, 256, 512)),
            BUDGETS):
        for pri in (tuple(aux), tuple(reversed(tuple(aux)))):
            spec = DataflowSpec(anchor, aux, pri, block)
            _same_traffic(cm.gemm_traffic(p, spec, budget),
                          jcm.gemm_traffic(jp, _jspec(spec, budget)))
            assert cm.gemm_footprint(p, spec) == \
                jcm.gemm_vmem_footprint(jp, _jspec(spec, budget))


@pytest.mark.parametrize("layer", PAPER_LAYERS[:6])
def test_conv_traffic_equals_the_reference(layer):
    hw, f, s, nf = layer
    for kw in ({}, {"in_dtype": "bfloat16", "out_dtype": "float32"},
               {"weight_bits": 4}):
        conv, jconv = _conv_pair(hw, f, s, PAPER_CIN, nf, **kw)
        for anchor, aux in ((OS, {IS: Residency.WHOLE}), (WS, {}), (IS, {}),
                            (OS, {IS: Residency.STRIPE}),
                            (WS, {IS: Residency.STRIPE})):
            for block, budget in itertools.product(
                    ((4, 128, 128), (8, 128, 256), (16, 256, 128)), BUDGETS):
                spec = DataflowSpec(anchor, aux, tuple(aux), block)
                jspec = _jspec(spec, budget)
                view = cm.conv_gemm_view(conv, spec)
                assert view.block == jcm.conv_gemm_view(jconv, jspec).block
                _same_traffic(cm.conv_traffic(conv, view, budget),
                              jcm.conv_traffic(jconv, _jspec(view, budget)))
                assert cm.conv_footprint(conv, spec) == \
                    jcm.conv_vmem_footprint(jconv, jspec)


def test_binary_traffic_equals_the_reference():
    for m, kp, n, bits, out in ((511, 64, 6144, 2048, "int8"),
                                (4, 192, 2048, 6144, "float32"),
                                (37, 3, 50, 70, "int32")):
        p, jp = BinaryProblem(m, kp, n, bits, out), JBin(m, kp, n, bits, out)
        assert p.bit_ops == jp.bit_ops
        for anchor, block, budget in itertools.product(
                (OS, WS, IS), ((128, 2, 128), (256, 16, 512)), BUDGETS):
            spec = DataflowSpec.basic(anchor, block=block)
            _same_traffic(cm.binary_traffic(p, spec, budget),
                          jcm.binary_traffic(jp, _jspec(spec, budget)))


ATTENTION = [
    dict(bh=16, sq=512, skv=512, d=128, group=2, dtype="bfloat16"),
    dict(bh=64, sq=1, skv=1024, d=128, group=2, dtype="bfloat16",
         kv_dtype="int8"),
    dict(bh=8, sq=37, skv=300, d=64, group=4, causal=True, window=24,
         dtype="float32", kv_len=200),
    dict(bh=6, sq=9, skv=40, d=16, group=1, causal=False, dtype="float32"),
    dict(bh=16, sq=128, skv=1024, d=128, group=2, dtype="bfloat16",
         kv_len=512, rows=2),
]


@pytest.mark.parametrize("kw", ATTENTION, ids=range(len(ATTENTION)))
def test_attention_traffic_equals_the_reference(kw):
    p, jp = AttentionProblem(**kw), JAtt(**kw)
    assert (p.bh_kv, p.kv_valid, p.kv_quantized, p.dot_flops,
            p.softmax_ops) == (jp.bh_kv, jp.kv_valid, jp.kv_quantized,
                               jp.dot_flops, jp.softmax_ops)
    for anchor, (bq, bkv), budget in itertools.product(
            (OS, WS), ((128, 128), (256, 512), (8, 64)), BUDGETS):
        spec = DataflowSpec.basic(anchor, block=(bq, bkv, p.d))
        jspec = _jspec(spec, budget)
        _same_traffic(cm.attention_traffic(p, spec, budget, stat_words=256,
                                           align=8),
                      jcm.attention_traffic(jp, jspec))
        assert cm.attention_banded_ops(p, bq, bkv, align=8) == \
            jcm.attention_banded_ops(jp, bq, bkv)
        assert cm.attention_visited_blocks(p, bq, bkv, align=8) == \
            jcm.attention_visited_blocks(jp, bq, bkv)
        if p.rows > 1 or p.sq == 1:
            lens = [200, 0, 57, 1024][:max(p.rows, 2)]
            if p.bh % len(lens) == 0:
                _same_traffic(
                    cm.attention_rows_traffic(p, lens, spec, budget,
                                              stat_words=256, align=8),
                    jcm.attention_rows_traffic(jp, lens, jspec))


# ---------------------------------------------------------------------------
# Rooflines.
# ---------------------------------------------------------------------------
def test_roofline_and_model_flops_equal_the_reference():
    """The same rates on both sides: the port's ``HardwareSpec`` given the
    reference's (a test-side stand-in; the port holds no TPU constant)."""
    v5 = jcm.V5E
    hw = cm.HardwareSpec(
        name=v5.name, sms=1, smem_block=v5.vmem_bytes, l2_bytes=0,
        hbm_bw=v5.hbm_bw, link_bw=v5.ici_bw,
        rates=(("bf16_tc", v5.peak_flops_for("bfloat16")),
               ("int8_tc", v5.peak_flops_for("int8")),
               ("f32_cuda", v5.peak_flops_for("float32")),
               ("b1_tc", v5.peak_flops_for("binary_packed"))))
    for dtype in ("bfloat16", "int8", "float32", "binary_packed"):
        for args in ((1e12, 3e9, 0.0, 1), (5e14, 2e11, 7e9, 4)):
            got = cm.roofline(*args, hw=hw, dtype=dtype)
            want = jcm.roofline(*args, hw=v5, dtype=dtype)
            assert (got.t_compute, got.t_memory, got.t_collective,
                    got.dominant, got.bound_time, got.compute_fraction) == (
                want.t_compute, want.t_memory, want.t_collective,
                want.dominant, want.bound_time, want.compute_fraction)
    for n, t, train in ((1.7e9, 2048, True), (8e9, 17, False)):
        assert cm.model_flops(n, t, train) == jcm.model_flops(n, t, train)


def test_the_port_holds_no_tpu_constant():
    """The H100 constant is the card's: its SMs and the shared memory the
    kernels' planners check against, the data sheet's HBM rate, and no
    rate of the reference's V5E."""
    hw = cm.H100
    assert (hw.sms, hw.smem_block) == (matmul_df.CARD_SMS, matmul_df.MAX_SMEM)
    assert hw.hbm_bw == 3.35e12 and hw.rate("bf16_tc") == 989e12
    assert hw.rate("int8_tc") == 1979e12 and hw.rate("f32_cuda") == 67e12
    v5 = {jcm.V5E.peak_flops, jcm.V5E.hbm_bw, jcm.V5E.ici_bw,
          jcm.V5E.vmem_bytes}
    assert not v5 & ({hw.hbm_bw, hw.link_bw, hw.smem_block}
                     | set(dict(hw.rates).values()))
    assert cm.hardware_for("cpu") is cm.H100


# ---------------------------------------------------------------------------
# The Hopper estimate.
# ---------------------------------------------------------------------------
def test_estimate_is_inf_where_the_plan_refuses():
    p = GemmProblem(512, 2048, 6144)
    spec = DataflowSpec(OS, {WS: Residency.WHOLE}, (WS,), matmul_df.BLOCK)
    with pytest.raises(ValueError):
        matmul_df.plan(spec, p.m, p.k, p.n)
    assert cm.gemm_time_estimate(p, spec) == float("inf")
    other = DataflowSpec.basic(OS, block=(128, 128, 128))
    assert cm.gemm_time_estimate(p, other) == float("inf")


def test_estimate_rates_each_plan_at_its_unit():
    """int8 and packed operands reach the integer tensor cores only
    through basic OS; every other dataflow walks on the CUDA cores, so
    basic OS must rank first there, at prefill and at decode."""
    os_ = DataflowSpec.basic(OS, block=matmul_df.BLOCK)
    ws = DataflowSpec(WS, {OS: Residency.STRIPE}, (OS,), matmul_df.BLOCK)
    for m in (4, 511):
        p = GemmProblem(m, 2048, 6144, "int8", "float32", "int32", 4)
        assert cm.gemm_time_estimate(p, os_) < cm.gemm_time_estimate(p, ws)
    rng = np.random.default_rng(0)
    for _ in range(20):
        m, k, n = (int(x) for x in rng.integers(1, 3000, 3))
        t = cm.gemm_time_estimate(GemmProblem(m, k, n), os_)
        assert 0 < t < float("inf")


def test_constants_are_the_fit_of_the_stored_timings():
    """``cost_model``'s constants are what ``bench/calibrate.py`` fits to
    the card's timings it stores, every candidate weighted alike, and
    with them every serve hot problem's pick there is within
    chip_smoke.py's 1.15x of the fastest candidate (in sample; the
    held-out agreement is reported, PERF.md)."""
    from repro_torch.bench import calibrate

    rows = calibrate.load([calibrate.STORED])
    t0, beta, eff, pro, step, _ = calibrate.rounded(calibrate.fit(rows))
    assert (t0, beta) == (cm.LAUNCH_SECONDS, cm.CONTENTION)
    assert eff == cm.EFFICIENCY and pro == cm.PROLOGUE_SECONDS
    assert {k: v for k, v in step.items() if v} == cm.STEP_SECONDS
    ps = calibrate.picks(rows)
    serve = [p["ratio"] for p in ps if p["group"] == "serve"]
    assert len(serve) == 38 and max(serve) <= calibrate.RATIO
    held = calibrate.held_out(rows)
    assert set(held) == {"serve", "paper", "f32"}
    assert all(0 < a["within_ratio"] <= a["problems"] for a in held.values())