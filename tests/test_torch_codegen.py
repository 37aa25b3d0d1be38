"""The code generator's twin (``repro_torch.core.codegen``) against the
JAX package's (``repro.core.codegen``), on the CPU: both generated
sources run on the same numpy inputs (the JAX one in interpret mode, the
port's kernel on CPU tensors through B1's plain version), float32, atol
1e-3 / rtol 1e-5 as the reference's own test; every spec of the port's
GEMM space round-trips through its source (``ns["SPEC"] == spec``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import codegen as jcodegen
from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import GemmProblem as JProblem
from repro.core.dataflow import Residency as JRes
from repro.core.dataflow import Stationarity as JSt
from repro_torch.core import codegen, explorer
from repro_torch.core.dataflow import (ConvProblem, DataflowSpec,
                                       GemmProblem, Residency, OS, WS)
from repro_torch.kernels import matmul_df

TOL = dict(rtol=1e-5, atol=1e-3)
SPACE = explorer.gemm_specs(prune_with_observations=False)


def _exec(src):
    ns = {}
    exec(compile(src, "<generated>", "exec"), ns)
    return ns


def _jax_twin(spec: DataflowSpec) -> JSpec:
    """The reference's spec of the same anchor and residencies, at the
    reference test's block."""
    return JSpec(JSt(spec.anchor.value),
                 {JSt(st.value): JRes(r.value) for st, r in spec.aux},
                 tuple(JSt(st.value) for st in spec.aux_priority),
                 (128, 128, 128))


@pytest.mark.parametrize("spec", SPACE, ids=[s.name for s in SPACE])
def test_generated_source_pins_the_spec(spec):
    p = GemmProblem(m=512, k=2048, n=6144, in_dtype="bfloat16")
    src = codegen.generate_source(p, spec)
    ns = _exec(src)
    assert ns["SPEC"] == spec
    assert "import jax" not in src and "from repro." not in src
    head = src.split('"""')[1]
    for field in ("problem :", "anchor  :", "aux     :", "blocks  :",
                  "plan    :", "traffic :"):
        assert field in head
    assert codegen.card_plan(p, spec) in head


@pytest.mark.parametrize("spec", [
    DataflowSpec(OS, {WS: Residency.STRIPE}, (WS,), matmul_df.BLOCK),
    DataflowSpec.basic(OS, block=matmul_df.BLOCK),
    DataflowSpec.basic(WS, block=matmul_df.BLOCK)], ids=lambda s: s.name)
def test_generated_sources_of_both_packages_agree(spec):
    p = GemmProblem(m=256, k=256, n=256, in_dtype="float32")
    rng = np.random.default_rng(0)
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=(256, 256)).astype(np.float32)
    got = _exec(codegen.generate_source(p, spec))["kernel"](
        torch.from_numpy(a), torch.from_numpy(b))
    jspec = _jax_twin(spec)
    jns = _exec(jcodegen.generate_source(
        JProblem(m=256, k=256, n=256, in_dtype="float32"), jspec))
    want = jns["kernel"](jnp.asarray(a), jnp.asarray(b), interpret=True)
    assert jns["SPEC"] == jspec
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_generated_kernel_checks_shapes():
    p = GemmProblem(m=64, k=64, n=64, in_dtype="float32")
    ns = _exec(codegen.generate_source(p, SPACE[0]))
    with pytest.raises(AssertionError):
        ns["kernel"](torch.zeros(32, 64), torch.zeros(64, 64))


def test_describe_plan_mentions_residency_and_the_card_plan():
    p = GemmProblem(m=1024, k=1024, n=1024)
    spec = DataflowSpec.optimized(block=matmul_df.BLOCK)
    text = codegen.describe_plan(p, spec)
    assert "anchor=output" in text and "stripe" in text
    assert codegen.card_plan(p, spec) in text
    # the reference's lines, traffic per operand from the same model
    jtext = jcodegen.describe_plan(JProblem(m=1024, k=1024, n=1024),
                                   _jax_twin(spec))
    assert text.splitlines()[0] == jtext.splitlines()[0]


def test_build_matmul_and_conv2d_callables():
    p = GemmProblem(m=128, k=128, n=128, in_dtype="float32")
    fn = codegen.build_matmul(p, DataflowSpec.basic(OS,
                                                    block=matmul_df.BLOCK))
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(128, 128, generator=g), torch.randn(128, 128,
                                                           generator=g)
    np.testing.assert_allclose(fn(a, b).numpy(), (a @ b).numpy(), **TOL)
    assert fn.__name__ == "matmul_OS"
    cp = ConvProblem(ih=8, iw=8, fh=3, fw=3, s=1, cin=4, cout=8, n=1,
                     in_dtype="float32")
    conv = codegen.build_conv2d(cp, DataflowSpec.basic(OS,
                                                       block=(64, 32, 64)))
    x = torch.randn(1, 8, 8, 4, generator=g)
    w = torch.randn(3, 3, 4, 8, generator=g)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      w.permute(3, 2, 0, 1))
    np.testing.assert_allclose(conv(x, w).numpy(),
                               want.permute(0, 2, 3, 1).numpy(), **TOL)
