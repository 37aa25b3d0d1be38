"""The port's direct convolution (B8) on the CPU against the JAX package's.

The kernel wrappers take their plain PyTorch versions on CPU tensors; the
JAX side runs its Pallas conv kernel in interpret mode under each anchor
(every call pins its spec, so no autotune entry is written) and its XLA
oracle.  Inputs come from seeded numpy generators; the shapes are ragged
in Cin, Cout and the output rows, so the JAX side pads (channels to 128
lanes, halo rows) where the port's kernel masks.  Tolerance: int8 inputs
accumulate exactly (int32 outputs compared bit for bit); float32 within
atol/rtol 1e-5 (the sums run in another order); the float epilogue of
an int8 conv within 1 ulp of its scale/bias stage, which XLA may
contract into an FMA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import IS as JIS, OS as JOS, WS as JWS
from repro.kernels import ops as jops
from repro_torch.core import dataflow as tdf
from repro_torch.core.dataflow import ConvProblem
from repro_torch.kernels import conv2d_df, ops, pack, ref
from repro_torch.runtime import health

ANCHORS = {"os": (JOS, tdf.OS), "ws": (JWS, tdf.WS), "is": (JIS, tdf.IS)}
# (n, ih, iw, fh, fw, s, cin, cout): ragged channels and rows; the last
# crosses the port's 64-pixel and 64-channel tiles and its 32-deep steps.
CASES = [
    (1, 9, 8, 3, 3, 1, 5, 6),
    (2, 11, 10, 3, 3, 2, 7, 10),
    (1, 14, 13, 3, 2, 1, 20, 70),
]
EPILOGUES = {
    "scale_tensor": dict(scale="tensor"),
    "scale_channel": dict(scale="channel"),
    "bias": dict(bias=True),
    "relu": dict(activation="relu"),
    "gelu": dict(activation="gelu"),
    "silu": dict(activation="silu"),
    "residual": dict(residual=True),
    "all": dict(scale="channel", bias=True, activation="gelu",
                residual=True),
}
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    health.reset_faults()


def _specs(anchor):
    janchor, tanchor = ANCHORS[anchor]
    return (JSpec.basic(janchor),
            tdf.DataflowSpec.basic(tanchor, block=conv2d_df.BLOCK))


def _operands(case, seed, integer=False):
    n, ih, iw, fh, fw, s, cin, cout = case
    oh, ow = (ih - fh) // s + 1, (iw - fw) // s + 1
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-20, 21, (n, ih, iw, cin)).astype(np.int8)
        w = rng.integers(-20, 21, (fh, fw, cin, cout)).astype(np.int8)
    else:
        x = rng.normal(size=(n, ih, iw, cin)).astype(np.float32)
        w = (rng.normal(size=(fh, fw, cin, cout))
             / np.sqrt(fh * fw * cin)).astype(np.float32)
    epi = dict(
        scale_tensor=np.float32(0.37),
        scale_channel=rng.uniform(0.01, 0.5, (cout,)).astype(np.float32),
        bias=rng.normal(size=(cout,)).astype(np.float32),
        residual=rng.normal(size=(n, oh, ow, cout)).astype(np.float32))
    return x, w, epi


def _epilogue_kwargs(flags, epi):
    kw = {}
    if flags.get("scale"):
        kw["scale"] = epi[f"scale_{flags['scale']}"]
    if flags.get("bias"):
        kw["bias"] = epi["bias"]
    if flags.get("residual"):
        kw["residual"] = epi["residual"]
    if flags.get("activation"):
        kw["activation"] = flags["activation"]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    return jkw, tkw


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_conv2d_matches(anchor, case):
    x, w, _ = _operands(case, seed=sum(case))
    s = case[5]
    jspec, tspec = _specs(anchor)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=s, spec=jspec,
                       b_oh=4, backend="interpret")
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=s,
                     spec=tspec)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=s,
                   backend="torch").numpy(),
        np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=s,
                               backend="xla")), **TOL)


@pytest.mark.parametrize("epi_name", sorted(EPILOGUES))
def test_conv2d_fused_matches(epi_name):
    case = CASES[1]
    x, w, epi = _operands(case, seed=len(epi_name))
    jkw, tkw = _epilogue_kwargs(EPILOGUES[epi_name], epi)
    jspec, tspec = _specs("os")
    want = jops.conv2d_fused(jnp.asarray(x), jnp.asarray(w), stride=2,
                             spec=jspec, b_oh=4, backend="interpret", **jkw)
    got = ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, spec=tspec, **tkw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                             stride=2, backend="torch", **tkw)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jops.conv2d_fused(
            jnp.asarray(x), jnp.asarray(w), stride=2, backend="xla",
            **jkw)), **TOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_int8_conv2d_is_exact(anchor, stride):
    case = (1, 13, 12, 3, 3, stride, 9, 70)
    x, w, _ = _operands(case, seed=stride, integer=True)
    jspec, tspec = _specs(anchor)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       spec=jspec, b_oh=4, backend="interpret")
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, spec=tspec)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.conv2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                       stride).numpy(), np.asarray(want))


@pytest.mark.parametrize("activation", [None, "relu", "silu"])
def test_int8_conv2d_fused_matches(activation):
    case = (2, 11, 10, 3, 3, 2, 7, 10)
    x, w, epi = _operands(case, seed=3, integer=True)
    x_scale = np.float32(0.02)
    w_scale = np.random.default_rng(4).uniform(0.01, 0.1, (10,)).astype(
        np.float32)
    bias, residual = epi["bias"], epi["residual"]
    want = jops.int8_conv2d_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(x_scale),
        jnp.asarray(w_scale), stride=2, bias=jnp.asarray(bias),
        residual=jnp.asarray(residual), activation=activation,
        spec=JSpec.basic(JOS), backend="interpret")
    got = ops.int8_conv2d_fused(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(x_scale),
        torch.from_numpy(w_scale), stride=2, bias=torch.from_numpy(bias),
        residual=torch.from_numpy(residual), activation=activation)
    assert got.dtype == torch.float32
    acc = ref.conv2d_ref(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    stage = np.abs(acc * (x_scale * w_scale)) + np.abs(bias)
    atol = float(np.spacing(np.float32(stage.max())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=atol)


def test_plan_names_walks_and_refuses_what_does_not_fit():
    """The resident operand must fit beside the two staging tiles."""
    ws = tdf.DataflowSpec.basic(tdf.WS, block=conv2d_df.BLOCK)
    is_ = tdf.DataflowSpec.basic(tdf.IS, block=conv2d_df.BLOCK)
    resnet = ConvProblem(ih=56, iw=56, fh=3, fw=3, s=1, cin=64, cout=64)
    p = conv2d_df.plan(is_, resnet, torch.int8)
    assert p.ctas == 1 and list(p.resident.values()) == [200_704]
    assert p.smem_bytes <= conv2d_df.MAX_SMEM
    with pytest.raises(ValueError, match=r"needs 418816 bytes") as err:
        conv2d_df.plan(is_, resnet, torch.bfloat16)
    assert "image (56, 56, 64)" in str(err.value)
    assert conv2d_df.plan(ws, resnet, torch.bfloat16).ctas == 1
    case = ConvProblem(ih=14, iw=14, fh=3, fw=3, s=1, cin=128, cout=128)
    with pytest.raises(ValueError, match="weight block .* 294912 B"):
        conv2d_df.plan(ws, case, torch.float32)
    os_ = conv2d_df.plan(conv2d_df.BASIC_OS, case, torch.float32)
    assert os_.resident == {} and os_.ctas == 3 * 2
    with pytest.raises(ValueError, match="needs"):
        ops.conv2d(torch.zeros(1, 14, 14, 128), torch.zeros(3, 3, 128, 128),
                   spec=ws)


@pytest.mark.parametrize("entry", ["conv2d", "conv2d_fused",
                                   "int8_conv2d_fused"])
def test_fault_site_conv2d_fires(monkeypatch, entry):
    x, w = torch.ones(1, 4, 4, 3), torch.ones(2, 2, 3, 5)
    calls = {
        "conv2d": lambda: ops.conv2d(x, w),
        "conv2d_fused": lambda: ops.conv2d_fused(x, w, bias=torch.ones(5)),
        "int8_conv2d_fused": lambda: ops.int8_conv2d_fused(
            x.to(torch.int8), w.to(torch.int8), 0.5, torch.ones(5)),
    }
    monkeypatch.setenv("REPRO_FAULT_PLAN",
                       "kernel.conv2d:0:raise,kernel.conv2d:1:nan")
    with pytest.raises(health.SimulatedFailure):
        calls[entry]()
    assert bool(torch.isnan(calls[entry]()).all())
    assert [(f.site, f.hit) for f in health.fault_log()] == [
        ("kernel.conv2d", 0), ("kernel.conv2d", 1)]


def test_unported_and_malformed_convs_raise():
    """The conv ops take no ``weight_bits`` (as the reference's take
    none): packed filters go through ``ops.conv2d_packed``, which equals
    the int8 conv of their exact int8 image.  Malformed calls raise."""
    x, w = torch.ones(1, 4, 4, 8), torch.ones(2, 2, 8, 5)
    for call in (lambda: ops.conv2d(x, w, weight_bits=4),
                 lambda: ops.conv2d_fused(x, w, weight_bits=5)):
        with pytest.raises(TypeError, match="weight_bits"):
            call()
    pcw = pack.pack_conv_weights(torch.randn(2, 2, 8, 5), 4)
    xq = torch.ones(1, 4, 4, 8, dtype=torch.int8)
    q, scale = pack.unpack_conv_weights(pcw)
    assert torch.equal(ops.conv2d_packed(xq, pcw),
                       ops.conv2d_fused(xq, q, scale=scale))
    with pytest.raises(ValueError, match="per-output-channel"):
        ops.conv2d_fused(x, w, scale=torch.ones(3))
    with pytest.raises(ValueError, match="per-output-channel"):
        ops.int8_conv2d_fused(x.to(torch.int8), w.to(torch.int8),
                              torch.ones(2), torch.ones(1))
    with pytest.raises(TypeError, match="share one of"):
        ops.conv2d(x.to(torch.int8), w)
    with pytest.raises(ValueError, match="bad conv shapes"):
        ops.conv2d(x, torch.ones(2, 2, 7, 5))
    with pytest.raises(ValueError, match="residual shape"):
        ops.conv2d_fused(x, w, residual=torch.ones(1, 3, 3, 4))
    with pytest.raises(TypeError, match="writes"):
        conv2d_df.conv2d_df(x, w, 1, conv2d_df.BASIC_OS,
                            out_dtype=torch.int32)


def test_conv_bench_runs_on_the_cpu():
    """The bench twin's rows on the plain path: every anchor of the
    ResNet-18-shaped layers equals OS, the f32 WS weight block of the
    reference's case does not fit, and nothing is timed."""
    from repro_torch.bench import conv as bench_conv

    rows = bench_conv.run("cpu", iters=1,
                          layers=[(9, 9, 3, 1, 8, 16, 2),
                                  (9, 9, 3, 2, 16, 70, 1)])
    fused = {r["anchor"]: r for r in rows if r["bench"] == "conv_fused"}
    assert not fused["ws"]["feasible"] and "294912 B" in fused["ws"]["why"]
    assert fused["os"]["feasible"] and fused["os"]["fused_ms"] is None
    resnet = [r for r in rows if r["bench"] == "resnet18_int8"]
    assert len(resnet) == 2 and all(r["anchors_equal_os_bitwise"]
                                    for r in resnet)
    assert rows[-1]["stack_ms"] == {"os": None, "ws": None, "is": None}
