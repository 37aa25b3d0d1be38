"""The port's kernel entry points on the CPU (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode.

Inputs come from a seeded numpy generator and go through both packages.
Every JAX call pins its dataflow (an OS spec, or anchor/bq/bkv), so no
autotune entry is written.  Tolerance: float32 throughout, atol 1e-5
(rtol 1e-5 for the few GEMM outputs above 1): the two sides differ only
in the order of float32 sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import DataflowSpec, OS
from repro.kernels import ops as jops
from repro_torch.core import dataflow as tdataflow
from repro_torch.kernels import matmul_df, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)
JAX_OS_SPEC = DataflowSpec(anchor=OS, block=(32, 32, 32))


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


M, K, N = 37, 64, 48          # not block multiples: the JAX side pads
EPILOGUES = {
    "none": {},
    "bias": {"bias": ("n",)},
    "scale_tensor": {"scale": ()},
    "scale_column": {"scale": ("n",)},
    "scale_row": {"scale": ("m", 1)},
    "relu": {"activation": "relu"},
    "gelu": {"activation": "gelu"},
    "silu_residual": {"activation": "silu", "residual": ("m", "n")},
    "all": {"scale": ("n",), "bias": ("n",), "activation": "gelu",
            "residual": ("m", "n")},
}


@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_matmul_fused_matches_interpret_os_kernel(epi):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    (ja, jb), (ta, tb) = _both(a, b)
    jkw, tkw = {}, {}
    for name, spec in EPILOGUES[epi].items():
        if name == "activation":
            jkw[name] = tkw[name] = spec
            continue
        shape = tuple({"m": M, "n": N}.get(s, s) for s in spec)
        arr = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        (jkw[name],), (tkw[name],) = _both(arr)
    want = jops.matmul_fused(ja, jb, spec=JAX_OS_SPEC, backend="interpret",
                             **jkw)
    got = ops.matmul_fused(ta, tb, **tkw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
def test_attention_matches_interpret_flash_kernel(case):
    b, hq, hkv, sq, skv, kv_len, window = ATTENTION_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, hq, sq, 32)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, 32)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, 32)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    jlen = tlen = kv_len
    if isinstance(kv_len, list):
        jlen = jnp.asarray(kv_len, jnp.int32)
        tlen = torch.tensor(kv_len, dtype=torch.int32)
    want = jops.attention(jq, jk, jv, causal=True, window=window,
                          anchor="os", bq=8, bkv=8, backend="interpret",
                          kv_len=jlen)
    got = ops.attention(tq, tk, tv, causal=True, window=window, kv_len=tlen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if isinstance(kv_len, list) and 0 in kv_len:
        assert np.all(got.numpy()[kv_len.index(0)] == 0.0)


@pytest.mark.parametrize("window", [None, 10])
def test_paged_attention_matches_interpret_paged_kernel(window):
    rng = np.random.default_rng(2)
    b, hq, hkv, d, page, max_pages = 4, 4, 2, 32, 8, 5
    n_pages = b * max_pages + 1
    k_pages = rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
    v_pages = rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
    tables = rng.permutation(n_pages - 1)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    kv_lens = np.array([0, 7, 21, 40], np.int32)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(
        q, k_pages, v_pages, tables, kv_lens)
    want = jops.paged_attention(jq, jk, jv, jt, jl, window=window,
                                backend="interpret")
    got = ops.paged_attention(tq, tk, tv, tt, tl, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[0] == 0.0)          # kv_len 0 writes zeros


def test_torch_backend_is_the_plain_twin():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 16)).astype(np.float32)
    b = rng.standard_normal((16, 7)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        ops.matmul_fused(ta, tb, activation="silu").numpy(),
        ops.matmul_fused(ta, tb, activation="silu", backend="torch").numpy())


def test_unported_dataflows_raise():
    """What the port refuses raises: int8 K/V without their per-position
    scales (int8 K/V with them run, ROADMAP A6 being ported); int8 GEMM
    operands run (exact int32 sums, equal to the plain int8 oracles); a
    block other than the compiled one raises; and an OS spec with a
    residency is planned as that residency, never silently streamed."""
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="per-position"):
        ops.attention(q, q.to(torch.int8), q.to(torch.int8))
    with pytest.raises(ValueError, match="per-position"):
        ops.attention(q, q.to(torch.int8), q.to(torch.int8), anchor="ws")
    rng = np.random.default_rng(8)
    a8 = torch.from_numpy(rng.integers(-127, 128, (2, 3)).astype(np.int8))
    b8 = torch.from_numpy(rng.integers(-127, 128, (3, 4)).astype(np.int8))
    scale = torch.tensor([[0.5, 0.25, 2.0, 1.0]])
    assert torch.equal(ops.matmul_fused(a8, b8, scale=scale),
                       ref.int8_matmul_ref(a8, b8, 1.0, scale))
    acc = ops.matmul(a8, b8)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, a8.long() @ b8.long())
    spec = tdataflow.DataflowSpec(anchor=tdataflow.OS, block=(32, 32, 32))
    with pytest.raises(ValueError, match="compiled for block"):
        ops.matmul_fused(torch.zeros(2, 3), torch.zeros(3, 4), spec=spec)
    with pytest.raises(ValueError, match="compiled for"):
        ops.attention(q, q, q, bq=8)
    with pytest.raises(ValueError, match="compiled for"):
        ops.attention(q, q, q, bq=8, anchor="ws")
    assert ops.attention(q, q, q, bq=16).shape == q.shape
    assert ops.attention(q, q, q, anchor="ws").shape == q.shape
    optimized = tdataflow.DataflowSpec.optimized(block=matmul_df.BLOCK)
    plan = matmul_df.plan(optimized, 2, 3, 4)
    assert plan.kernel == "matmul_os" and plan.args == (0, 1)
    assert plan.grid_order == "(gn, gm, gk)"
    assert list(plan.resident) == ["B column stripe (32, 64)"]
    assert ops.matmul_fused(torch.zeros(2, 3), torch.zeros(3, 4),
                            spec=optimized).shape == (2, 4)
