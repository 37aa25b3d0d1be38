"""The port's binary (+-1, xnor-popcount) datapath on the CPU against the
JAX package's.

The kernel wrappers take their plain PyTorch versions on CPU tensors; the
JAX side runs its Pallas kernel in interpret mode (every call pins a
dataflow anchor at a small block) and its XLA oracle.  Inputs come from
seeded numpy generators; packed words cross over as the int32 view of
the JAX package's uint32 words.  Tolerance: the binary datapath proper
(int32 dots, +-1 outputs, packed words) is compared bit for bit; the
float image of an un-binarized epilogue within rtol 1e-6 plus 1 ulp of
the scale/bias stage, the reference's own 1 ulp (its kernel and its XLA
oracle may contract that stage into an FMA, and a residual can leave
the difference on a result near 0).  The model checks use the dense
path's atol 1e-4 on logits (float32 attention through two layers) with
equal greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import IS as JIS, OS as JOS, WS as JWS
from repro.kernels import ops as jops, ref as jref
from repro.models import layers as jlayers, lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro_torch import configs
from repro_torch.core import dataflow as tdf
from repro_torch.kernels import _build, binary_mm, ops, ref
from repro_torch.models import bridge, layers, lm
from repro_torch.runtime import health
from repro_torch.serve.engine import Engine, RequestState

ANCHORS = {"os": (JOS, tdf.OS), "ws": (JWS, tdf.WS), "is": (JIS, tdf.IS)}
JAX_BLOCK = (64, 2, 128)
SHAPES = [(128, 256, 128), (100, 96, 130), (64, 32, 256)]
EPILOGUES = {
    "scale_bias_sign": dict(scale=True, bias=True, binarize=True),
    "scale_bias": dict(scale=True, bias=True),
    "residual_sign": dict(residual=True, binarize=True),
    "residual": dict(scale=True, residual=True),
    "sign": dict(binarize=True),
    "scalar_scale": dict(scale="scalar"),
}
CFG = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), binary_mlp=True)
JCFG = dataclasses.replace(jconfigs.get_smoke("qwen3-1.7b"), binary_mlp=True)
MAX_LEN = 48
FLOAT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    health.reset_faults()


def _words(packed) -> torch.Tensor:
    """The JAX package's uint32 words as the port's int32 words."""
    return torch.from_numpy(np.asarray(packed).view(np.int32).copy())


def _specs(anchor):
    janchor, tanchor = ANCHORS[anchor]
    return (JSpec.basic(janchor, block=JAX_BLOCK),
            tdf.DataflowSpec.basic(tanchor, block=binary_mm.BLOCK))


def _packed_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.choice([-1.0, 1.0], (m, k)).astype(np.float32)
    b = rng.choice([-1.0, 1.0], (k, n)).astype(np.float32)
    ja, jb = jref.pack_binary(jnp.asarray(a), 1), jref.pack_binary(
        jnp.asarray(b), 0)
    return a, b, (ja, jb), (_words(ja), _words(jb))


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Packing.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_pack_unpack_match_jax_bit_for_bit(axis):
    """0, -0.0 and negatives pack as -1 (``x > 0`` is the bit) in both."""
    rng = np.random.default_rng(1)
    shape = [64, 64, 64]
    shape[axis] = 96
    x = rng.choice([-1.0, -0.0, 0.0, 0.5, 1.0, -3.0], shape).astype(
        np.float32)
    jp = jref.pack_binary(jnp.asarray(x), axis=axis)
    tp = ref.pack_binary(torch.from_numpy(x), axis=axis)
    assert tp.dtype == torch.int32
    _bitwise(tp, np.asarray(jp).view(np.int32))
    ju = jref.unpack_binary(jp, axis=axis)
    _bitwise(ref.unpack_binary(tp, axis=axis), ju)
    _bitwise(ref.pack_binary(ref.unpack_binary(tp, axis=axis), axis=axis),
             np.asarray(jp).view(np.int32))
    with pytest.raises(ValueError, match="multiple of 32"):
        ref.pack_binary(torch.ones(3, 40))


# ---------------------------------------------------------------------------
# The GEMM: raw dots, every anchor; every epilogue stage.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_binary_matmul_dots_match(anchor, shape):
    m, k, n = shape
    a, b, (ja, jb), (ta, tb) = _packed_operands(m, k, n, seed=sum(shape))
    jspec, tspec = _specs(anchor)
    want = jops.binary_matmul(ja, jb, n_bits=k, spec=jspec,
                              backend="interpret")
    got = ops.binary_matmul(ta, tb, k, spec=tspec)
    _bitwise(got, want)
    _bitwise(ops.binary_matmul(ta, tb, k, backend="torch"),
             jops.binary_matmul(ja, jb, n_bits=k, backend="xla"))
    np.testing.assert_array_equal(got.numpy(), (a @ b).astype(np.int32))


@pytest.mark.parametrize("epi_name", sorted(EPILOGUES))
@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_binary_matmul_fused_matches(anchor, epi_name):
    m, k, n = 100, 96, 130
    _, _, (ja, jb), (ta, tb) = _packed_operands(m, k, n, seed=len(epi_name))
    rng = np.random.default_rng(5)
    flags = EPILOGUES[epi_name]
    scale = None
    if flags.get("scale") == "scalar":
        scale = np.float32(0.37)
    elif flags.get("scale"):
        scale = rng.uniform(0.1, 2.0, (n,)).astype(np.float32)
    bias = (rng.normal(size=(n,)).astype(np.float32)
            if flags.get("bias") else None)
    residual = (rng.normal(size=(m, n)).astype(np.float32)
                if flags.get("residual") else None)
    binarize = flags.get("binarize", False)
    jspec, tspec = _specs(anchor)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.as_tensor(x)

    want = jops.binary_matmul_fused(
        ja, jb, k, scale=j(scale), bias=j(bias), residual=j(residual),
        binarize=binarize, spec=jspec, backend="interpret")
    oracle = jops.binary_matmul_fused(
        ja, jb, k, scale=j(scale), bias=j(bias), residual=j(residual),
        binarize=binarize, backend="xla")
    got = ops.binary_matmul_fused(ta, tb, k, scale=t(scale), bias=t(bias),
                                  residual=t(residual), binarize=binarize,
                                  spec=tspec)
    plain = ops.binary_matmul_fused(ta, tb, k, scale=t(scale), bias=t(bias),
                                    residual=t(residual), binarize=binarize,
                                    backend="torch")
    assert got.dtype == (torch.int8 if binarize else torch.float32)
    if binarize:
        _bitwise(got, want)
        _bitwise(plain, oracle)
        assert set(np.unique(got.numpy())) <= {-1, 1}
    else:
        # The reference's kernel and its XLA oracle may round the
        # scale/bias stage once (an FMA) where the port rounds twice: 1 ulp
        # of that stage, which a residual can leave on a result near 0.
        stage = np.abs(ref.binary_matmul_ref(ta, tb, k).numpy()
                       * (1.0 if scale is None else scale))
        if bias is not None:
            stage = stage + np.abs(bias)
        atol = float(np.spacing(np.float32(stage.max())))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLOAT_RTOL, atol=atol)
        np.testing.assert_allclose(plain.numpy(), np.asarray(oracle),
                                   rtol=FLOAT_RTOL, atol=atol)
        assert torch.equal(got, plain)


def test_binary_epilogue_sign_conventions():
    """``sign`` maps y >= 0 (and -0.0) to +1; the output dtypes follow
    the JAX op's defaults and the kernel's table."""
    dot = torch.tensor([[-2, 0, 2]], dtype=torch.int32)
    neg_zero = torch.tensor([[1.0, -0.0, 1.0]])
    out = ref.binary_epilogue_ref(dot, scale=neg_zero, binarize=True)
    assert out.dtype == torch.int8 and out.tolist() == [[-1, 1, 1]]
    a = torch.zeros(2, 1, dtype=torch.int32)
    b = torch.zeros(1, 3, dtype=torch.int32)
    assert ops.binary_matmul(a, b, 32).dtype == torch.int32
    assert ops.binary_matmul_fused(a, b, 32, bias=torch.zeros(3)).dtype \
        == torch.float32
    with pytest.raises(TypeError, match="writes"):
        binary_mm.binary_mm_df(a, b, 32, binary_mm.BASIC_OS,
                               out_dtype=torch.int8)
    with pytest.raises(TypeError, match="int32 words"):
        ops.binary_matmul(a.float(), b, 32)
    with pytest.raises(ValueError, match="exceeds packed depth"):
        ops.binary_matmul(a, b, 33)


# ---------------------------------------------------------------------------
# Binary conv on the implicit-GEMM view.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_binary_conv2d_matches(stride, fused):
    rng = np.random.default_rng(stride)
    x = rng.choice([-1.0, 1.0], (2, 9, 8, 64)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], (3, 3, 64, 70)).astype(np.float32)
    jx, jw = jref.pack_binary(jnp.asarray(x), -1), jref.pack_binary(
        jnp.asarray(w), 2)
    kw = {}
    if fused:
        oh, ow = (9 - 3) // stride + 1, (8 - 3) // stride + 1
        kw = dict(scale=rng.uniform(0.1, 1.0, (70,)).astype(np.float32),
                  bias=rng.normal(size=(70,)).astype(np.float32),
                  residual=rng.normal(size=(2, oh, ow, 70)).astype(
                      np.float32), binarize=True)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = jops.binary_conv2d(jx, jw, stride=stride, spec=JSpec.basic(
        JOS, block=JAX_BLOCK), backend="interpret", **jkw)
    got = ops.binary_conv2d(_words(jx), _words(jw), stride=stride, **tkw)
    _bitwise(got, want)
    _bitwise(ref.binary_conv2d_ref(_words(jx), _words(jw), stride, **tkw),
             jref.binary_conv2d_ref(jx, jw, stride, **jkw))


# ---------------------------------------------------------------------------
# Feasibility, fault sites.
# ---------------------------------------------------------------------------
def test_plan_names_walks_and_refuses_what_does_not_fit():
    os_ = binary_mm.plan(binary_mm.BASIC_OS, 511, 64, 6144)
    assert os_.ctas == 8 * 96 and os_.resident == {}
    ws = tdf.DataflowSpec.basic(tdf.WS, block=binary_mm.BLOCK)
    is_ = tdf.DataflowSpec.basic(tdf.IS, block=binary_mm.BLOCK)
    assert binary_mm.plan(ws, 511, 192, 2048).ctas == 32
    assert binary_mm.plan(is_, 511, 192, 2048).ctas == 8
    assert binary_mm.plan(ws, 4, 832, 64).smem_bytes <= binary_mm.MAX_SMEM
    for spec in (ws, is_):
        with pytest.raises(ValueError, match=r"needs 2\d+ bytes") as err:
            binary_mm.plan(spec, 64, 1024, 64)
        assert "stripe" in str(err.value) and "232448" in str(err.value)
        with pytest.raises(ValueError, match="needs"):
            ops.binary_matmul(torch.zeros(64, 1024, dtype=torch.int32),
                              torch.zeros(1024, 64, dtype=torch.int32),
                              32 * 1024, spec=spec)
    with pytest.raises(ValueError, match="compiled for block"):
        binary_mm.plan(tdf.DataflowSpec.basic(tdf.OS), 4, 4, 4)


@pytest.mark.parametrize("entry", ["binary_matmul", "binary_matmul_fused",
                                   "binary_conv2d"])
def test_fault_site_binary_matmul_fires(monkeypatch, entry):
    a = torch.zeros(4, 2, dtype=torch.int32)
    b = torch.zeros(2, 3, dtype=torch.int32)
    calls = {
        "binary_matmul": lambda: ops.binary_matmul(a, b, 64),
        "binary_matmul_fused": lambda: ops.binary_matmul_fused(
            a, b, 64, bias=torch.ones(3)),
        "binary_conv2d": lambda: ops.binary_conv2d(
            torch.zeros(1, 3, 3, 2, dtype=torch.int32),
            torch.zeros(2, 2, 2, 3, dtype=torch.int32), bias=torch.ones(3)),
    }
    monkeypatch.setenv("REPRO_FAULT_PLAN", "kernel.binary_matmul:0:raise,"
                                           "kernel.binary_matmul:1:nan")
    with pytest.raises(health.SimulatedFailure):
        calls[entry]()
    out = calls[entry]()
    if out.is_floating_point():
        assert bool(torch.isnan(out).all())
    assert [(f.site, f.hit) for f in health.fault_log()] == [
        ("kernel.binary_matmul", 0), ("kernel.binary_matmul", 1)]


# ---------------------------------------------------------------------------
# The binary-MLP decoder: layers, bridge, serving.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def params():
    jp = jlm.init_model(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                        device="cpu")


def test_binary_mlp_apply_matches(params):
    jp, tp = params
    x = np.random.default_rng(3).standard_normal((2, 5, CFG.d_model)).astype(
        np.float32)
    jmlp = jax.tree.map(lambda t: t[0], jp["layers"]["mlp"])
    tmlp = {k: {n: v[0] for n, v in d.items()}
            for k, d in tp["layers"]["mlp"].items()}
    want = jlayers.binary_mlp_apply(jmlp, jnp.asarray(x))
    got = layers.binary_mlp_apply(tmlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLOAT_RTOL, atol=0)
    hidden = layers.binary_dense(tmlp["up"], torch.from_numpy(x))
    _bitwise(hidden, jlayers.binary_dense(jmlp["up"], jnp.asarray(x)))
    with layers.forced_backend("torch"):
        assert torch.equal(layers.mlp_apply(tmlp, torch.from_numpy(x)), got)


def test_bridge_carries_the_binary_model(params):
    jp, tp = params
    assert tp["layers"]["mlp"]["up"]["w_packed"].dtype == torch.int32
    np.testing.assert_array_equal(
        tp["layers"]["mlp"]["down"]["w_packed"].numpy(),
        np.asarray(jp["layers"]["mlp"]["down"]["w_packed"]).view(np.int32))
    fresh = lm.init_model(CFG, seed=0, device="cpu")
    for name in ("up", "down"):
        for leaf in ("w_packed", "scale", "bias"):
            a, b = fresh["layers"]["mlp"][name][leaf], \
                tp["layers"]["mlp"][name][leaf]
            assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(
            fresh["layers"]["mlp"][name]["scale"],
            tp["layers"]["mlp"][name]["scale"], rtol=0, atol=0)
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["mlp"]["up"]["w_packed"] = np.zeros((2, 3, 4), np.uint32)
    with pytest.raises(ValueError, match="up.w_packed: shape"):
        bridge.params_from_numpy(tree, CFG, device="cpu")


def test_binary_prefill_logits_and_greedy_tokens_match(params):
    jp, tp = params
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 13))
    jl, _ = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), JCFG,
                        max_len=MAX_LEN)
    tl, _ = lm.prefill(tp, torch.as_tensor(toks), CFG, max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    prompts = [np.random.default_rng(s).integers(0, CFG.vocab_size, (n,))
               .astype(np.int32) for s, n in ((1, 7), (2, 12), (3, 3))]
    jeng = JaxEngine(JCFG, jp, max_len=MAX_LEN)
    jreqs = [jeng.submit(p, 5) for p in prompts]
    jeng.drain()
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    reqs = [eng.submit(p, 5) for p in prompts]
    eng.drain()
    assert [list(r.out_tokens) for r in reqs] == \
        [list(r.out_tokens) for r in jreqs]
    assert eng.stats()["demotions"] == 0


def test_binary_serving_mixed_batch_equals_sequential(params):
    """Port against port: paged decode through ``Engine``, a mixed-length
    batch emits the tokens each request emits alone."""
    _, tp = params
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
               for n in (3, 11, 6, 17)]

    def serve(batch):
        eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
        reqs = [eng.submit(p, 4) for p in batch]
        eng.drain()
        assert all(r.state == RequestState.DONE for r in reqs)
        assert eng.stats()["demotions"] == 0
        return [list(r.out_tokens) for r in reqs]

    before = dict(_build.LAUNCHES)
    assert serve(prompts) == [serve([p])[0] for p in prompts]
    assert _build.LAUNCHES == before


def test_init_model_draws_the_binary_mlp():
    p = lm.init_model(CFG, seed=1, device="cpu")
    up = p["layers"]["mlp"]["up"]
    n, d, ff = CFG.n_layers, CFG.d_model, CFG.d_ff
    assert up["w_packed"].shape == (n, d // 32, ff)
    assert up["w_packed"].dtype == torch.int32
    assert torch.equal(up["scale"], torch.full((n, ff), d ** -0.5))
    assert not up["bias"].any()
    signs = ref.unpack_binary(up["w_packed"], axis=1)
    assert 0.4 < float((signs > 0).float().mean()) < 0.6
    with pytest.raises(NotImplementedError, match="A8"):
        lm.init_model(dataclasses.replace(CFG, packed_weights=True),
                      device="cpu")


def test_fig9_bench_runs_on_the_cpu():
    """The Fig. 9 twin on the plain path: the binary dots equal the int8
    and bf16 convs of the same +-1 values, and nothing is timed."""
    from repro_torch.bench import binary as bench_binary

    rows = bench_binary.run("cpu", iters=1, layers=[(8, 7, 3, 1, 64, 40)])
    row = rows[0]
    assert row["binary_equals_int8"] and row["binary_ms"] is None
    assert row["bytes_int8_over_binary"] > 1
    assert rows[-1]["bench"] == "fig9_summary"
