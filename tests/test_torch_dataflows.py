"""The port's GEMM dataflows (B1's residencies, B4, B5a, B5b) and its
KV-stationary attention (B7) on the CPU, against the JAX package's Pallas
kernels in interpret mode.

On the CPU each wrapper computes its kernels' plain version, so these
tests hold the port's dispatch (``ops.matmul_fused``/``ops.matmul``
under every canonical spec, ``ops.attention(anchor="ws")``) and the
arithmetic of the plain versions against the reference's kernels;
``matmul_df.plan`` is held against a table written from the reference's
build functions (``repro/kernels/matmul_df.py`` ``_build_os`` :291-345,
``_build_rmw`` :408-475, ``_build_ws`` :533-580, ``_build_is``
:620-665).  Inputs come from a seeded numpy generator and go through both
packages.  Tolerance: float32 throughout, atol 1e-5 and rtol 1e-5: the
two sides differ only in the order of float32 sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import IS as JIS, OS as JOS, WS as JWS
from repro.core.dataflow import Residency as JRes
from repro.kernels import ops as jops
from repro_torch.bench import (attention_anchors, basic_dataflows, common,
                               extended_dataflows)
from repro_torch.core.dataflow import (ConvProblem, DataflowSpec, Residency,
                                       IS, OS, WS)
from repro_torch.kernels import matmul_df, ops

TOL = dict(atol=1e-5, rtol=1e-5)
JAX_BLOCK = (32, 32, 32)          # several grid steps on each axis at 37x64x48
M, K, N = 37, 64, 48              # not block multiples on either side


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))


def _jax_spec(name: str) -> JSpec:
    """The reference's canonical spec of that name (its own test's set,
    tests/test_fused_epilogue.py), at a block that tiles the small
    shapes several times."""
    st = {OS: JOS, WS: JWS, IS: JIS}
    res = {Residency.STRIPE: JRes.STRIPE, Residency.WHOLE: JRes.WHOLE,
           Residency.STREAMED: JRes.STREAMED}
    spec = common.NINE_SPECS[name]
    return JSpec(st[spec.anchor], {st[o]: res[r] for o, r in spec.aux},
                 tuple(st[o] for o in spec.aux_priority), JAX_BLOCK)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


EPILOGUES = {                     # tests/test_fused_epilogue.py:30-36
    "scale_bias_gelu_res": dict(scale=True, bias=True, activation="gelu",
                                residual=True),
    "bias_relu": dict(bias=True, activation="relu"),
    "silu": dict(activation="silu"),
    "scale": dict(scale=True),
}


@pytest.mark.parametrize("epi_name", sorted(EPILOGUES))
@pytest.mark.parametrize("spec_name", sorted(common.NINE_SPECS))
def test_matmul_fused_every_dataflow_matches_interpret(spec_name, epi_name):
    rng = np.random.default_rng(sorted(common.NINE_SPECS).index(spec_name)
                                * 10 + sorted(EPILOGUES).index(epi_name))
    flags = EPILOGUES[epi_name]
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    arrays = {"bias": rng.standard_normal((1, N)).astype(np.float32),
              "scale": np.array([[rng.uniform(0.01, 0.5)]], np.float32),
              "residual": rng.standard_normal((M, N)).astype(np.float32)}
    (ja, jb), (ta, tb) = _both(a, b)
    jkw, tkw = {}, {}
    for name in ("bias", "scale", "residual"):
        if flags.get(name):
            (jkw[name],), (tkw[name],) = _both(arrays[name])
    if flags.get("activation"):
        jkw["activation"] = tkw["activation"] = flags["activation"]
    want = jops.matmul_fused(ja, jb, spec=_jax_spec(spec_name),
                             backend="interpret", **jkw)
    got = ops.matmul_fused(ta, tb, spec=common.NINE_SPECS[spec_name], **tkw)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("spec_name", ["os_w_stripe", "ws_o_stripe",
                                       "is_basic", "is_b_whole"])
def test_matmul_matches_interpret(spec_name):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    (ja, jb), (ta, tb) = _both(a, b)
    want = jops.matmul(ja, jb, spec=_jax_spec(spec_name),
                       backend="interpret")
    got = ops.matmul(ta, tb, spec=common.NINE_SPECS[spec_name])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), ops.matmul(ta, tb, backend="torch").numpy())


# spec -> (kernel, grid order, resident operands, entry arguments, demoted)
# from the reference's build functions: the OS aux residencies keep
# _build_os's grid (n first for a weight stripe); basic WS/IS are
# _build_rmw with the anchored stripe resident; an OS stripe sends WS to
# _build_ws and IS to _build_is (with B whole for a WS WHOLE aux); IS
# demotes a WS stripe.
PLAN_TABLE = {
    "os_basic": ("matmul_os", "(gm, gn, gk)", [], (0, 0), False),
    "os_w_stripe": ("matmul_os", "(gn, gm, gk)", ["B column stripe"],
                    (0, 1), False),
    "os_w_whole_i_stripe": ("matmul_os", "(gm, gn, gk)",
                            ["A row stripe", "B whole"], (1, 2), False),
    "os_i_stripe": ("matmul_os", "(gm, gn, gk)", ["A row stripe"], (1, 0),
                    False),
    "ws_basic": ("matmul_rmw", "(gn, gm, gk)", ["B column stripe"],
                 (1, 0, 1), False),
    "ws_o_stripe": ("matmul_ws_stripe", "(gn, gk, gm)",
                    ["output column stripe"], (), False),
    "ws_i_stripe": ("matmul_rmw", "(gn, gm, gk)",
                    ["B column stripe", "A row stripe"], (1, 1, 1), False),
    "ws_o_i_stripe": ("matmul_ws_stripe", "(gn, gk, gm)",
                      ["output column stripe"], (), True),
    "is_basic": ("matmul_rmw", "(gm, gn, gk)", ["A row stripe"], (0, 1, 0),
                 False),
    "is_w_stripe": ("matmul_rmw", "(gm, gn, gk)", ["A row stripe"],
                    (0, 1, 0), True),
    "is_o_stripe": ("matmul_is_stripe", "(gm, gk, gn)",
                    ["output row stripe"], (0,), False),
    "is_b_whole": ("matmul_rmw", "(gm, gn, gk)", ["A row stripe", "B whole"],
                   (0, 1, 2), False),
    "is_o_stripe_b_whole": ("matmul_is_stripe", "(gm, gk, gn)",
                            ["output row stripe", "B whole"], (1,), False),
}
_B = matmul_df.BLOCK
EXTRA_SPECS = {
    "os_i_stripe": DataflowSpec(OS, {IS: Residency.STRIPE}, (IS,), _B),
    "ws_o_i_stripe": DataflowSpec(
        WS, {OS: Residency.STRIPE, IS: Residency.STRIPE}, (OS, IS), _B),
    "is_w_stripe": DataflowSpec(IS, {WS: Residency.STRIPE}, (WS,), _B),
    "is_o_stripe_b_whole": DataflowSpec(
        IS, {OS: Residency.STRIPE, WS: Residency.WHOLE}, (OS, WS), _B),
}


@pytest.mark.parametrize("name", sorted(PLAN_TABLE))
def test_plan_follows_the_reference_dispatch(name):
    kernel, order, resident, args, demoted = PLAN_TABLE[name]
    spec = common.NINE_SPECS.get(name) or EXTRA_SPECS[name]
    p = matmul_df.plan(spec, M, K, N, torch.float32)
    assert p.kernel == kernel and p.grid_order == order and p.args == args
    assert [r.split(" (")[0] for r in p.resident] == resident
    assert (p.demoted is not None) == demoted
    assert p.smem_bytes <= matmul_df.MAX_SMEM


@pytest.mark.parametrize("name,shape,held", [
    ("ws_o_stripe", (4096, 256, 256), "output column stripe"),
    ("is_basic", (64, 8192, 64), "A row stripe"),
    ("os_w_whole_i_stripe", (64, 1152, 128), "B whole"),
    ("is_o_stripe", (64, 256, 2048), "output row stripe"),
])
def test_plan_refuses_an_oversize_residency(name, shape, held):
    m, k, n = shape
    with pytest.raises(ValueError, match=rf"needs \d+ bytes of shared "
                                         rf"memory.*{held}"):
        matmul_df.plan(common.NINE_SPECS[name], m, k, n)
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ops.matmul_fused(a, b, spec=common.NINE_SPECS[name])


def test_plan_rejects_another_block():
    spec = DataflowSpec.basic(WS, block=(128, 128, 128))
    with pytest.raises(ValueError, match="compiled for block"):
        matmul_df.plan(spec, M, K, N)


def test_conv_problem_gemm_view_matches_the_reference():
    from repro.core.dataflow import ConvProblem as JConv

    for hw, f, s, nf in common.PAPER_LAYERS:
        g = ConvProblem(ih=hw, iw=hw, fh=f, fw=f, s=s, cin=128,
                        cout=nf).as_gemm()
        j = JConv(ih=hw, iw=hw, fh=f, fw=f, s=s, cin=128, cout=nf).as_gemm()
        assert (g.m, g.k, g.n) == (j.m, j.k, j.n)
    opt = DataflowSpec.optimized(block=_B)
    assert opt.residency(WS) == Residency.STRIPE
    assert opt.residency(OS) == Residency.STRIPE        # the anchor
    assert opt.name == JSpec.optimized().name == "OS+w:stripe"


# (B, Hq, Hkv, Sq, Skv, kv_len, window); kv_len a list = one per row
ATTENTION_CASES = {
    "causal_prefill_gqa": (2, 4, 2, 19, 19, None, None),
    "scalar_kv_len": (1, 4, 2, 5, 24, 13, None),
    "per_row_kv_len": (4, 4, 2, 3, 24, [0, 5, 17, 24], None),
    "window": (1, 4, 2, 20, 20, None, 6),
    "per_row_kv_len_window": (3, 4, 1, 2, 32, [3, 12, 32], 8),
    "decode_sq1": (3, 4, 2, 1, 24, [1, 9, 24], None),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_kv_stationary_attention_matches_interpret(case):
    b, hq, hkv, sq, skv, kv_len, window = ATTENTION_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, hq, sq, 32)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, 32)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, 32)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    jlen = tlen = kv_len
    if isinstance(kv_len, list):
        jlen = jnp.asarray(kv_len, jnp.int32)
        tlen = torch.tensor(kv_len, dtype=torch.int32)
    want = jops.attention(jq, jk, jv, causal=True, window=window,
                          anchor="ws", bq=8, bkv=8, backend="interpret",
                          kv_len=jlen)
    got = ops.attention(tq, tk, tv, causal=True, window=window, kv_len=tlen,
                        anchor="ws")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if isinstance(kv_len, list) and 0 in kv_len:
        assert np.all(got.numpy()[kv_len.index(0)] == 0.0)


def test_bench_twins_give_rows_on_the_cpu():
    """On the CPU the bench twins only check shapes and plans: every time
    is None (not measured), and infeasible specs are reported, not run."""
    layers, mlp = [(10, 3, 1, 16), (12, 4, 2, 8)], [(5, 64, 48)]
    fig2 = basic_dataflows.run("cpu", layers=layers, mlp=mlp)
    assert [r["bench"] for r in fig2] == ["fig2"] * 3 + ["fig2_summary"]
    assert all(r["os_basic_ms"] is None for r in fig2[:3])
    fig7 = extended_dataflows.run("cpu", layers=layers, mlp=mlp)
    assert "os_w_whole_i_stripe" in fig7[0]["infeasible"]
    assert fig7[-1]["layers"] == 2
    attn = attention_anchors.run("cpu", lengths=(20,), heads=(4, 2), d=32)
    assert attn[0]["ws_ms"] is None and attn[0]["sq"] == 20


@pytest.mark.parametrize("spec_name", ["ws_o_stripe", "is_o_stripe"])
def test_bf16_output_stripes_accumulate_in_f32(spec_name):
    """The reference's float output-stripe kernels accumulate a bf16
    output in bf16, one rounding per k block (ROADMAP C); the port
    accumulates in f32 and rounds once.  At K = 256 (eight k blocks of
    32 on the JAX side) the two agree within atol 0.05, rtol 0.02 on
    outputs of unit size, and the port equals its f32 result rounded."""
    rng = np.random.default_rng(5)
    m, k, n = 37, 256, 48
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    (ja, jb), (ta, tb) = _both(a, b)
    want = jops.matmul_fused(ja, jb, spec=_jax_spec(spec_name),
                             out_dtype=jnp.bfloat16, backend="interpret")
    got = ops.matmul_fused(ta, tb, spec=common.NINE_SPECS[spec_name],
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.05, rtol=0.02)
    f32 = ops.matmul_fused(ta, tb, spec=common.NINE_SPECS[spec_name])
    assert torch.equal(got, f32.to(torch.bfloat16))
