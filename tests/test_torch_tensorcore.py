"""B1's and B2's bf16 tensor-core paths: what the CPU can hold, and the
card-only checks.

On the CPU: ``matmul_df.plan`` names the bf16 basic OS launch's tiles
(``csrc/gemm_tc.cuh``: 128x64 for M > 16, 16x16 for M <= 16) with their
shared memory, while every float32 plan, and every bf16, int8 and packed
plan with a residency, keeps the values it had before the tensor-core
tiles (the table below was written from the planner before them; the
int8 and packed basic OS plans became tiles of their own later,
``tests/test_torch_int8_tc.py``); the
flash kernel's compiled (bq, bkv) follows the dtype; and the bf16 plain
versions the kernels are held against on the card agree with the JAX
package's Pallas kernels in interpret mode on the same seeded inputs.

On the card (marker ``card``, skipped here): bf16 B1 equals every
feasible dataflow bit for bit and stays within ``chip_smoke.py``'s
``B1_TOL`` of its plain version, and bf16 B2 within its ``att_tol``.
The card's machine has no JAX, so this module imports the JAX package
only inside the parity tests, and runs there without the repo's
conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q -m card \
        tests/test_torch_tensorcore.py
"""
import numpy as np
import pytest
import torch

from repro_torch.bench import common
from repro_torch.core.dataflow import (DataflowSpec, Residency, IS, OS, WS,
                                       registered_kernels)
from repro_torch.kernels import _build, attention_df, matmul_df, ops, ref

_B = matmul_df.BLOCK
SPECS = dict(common.NINE_SPECS, **{
    "os_i_stripe": DataflowSpec(OS, {IS: Residency.STRIPE}, (IS,), _B),
    "ws_o_i_stripe": DataflowSpec(
        WS, {OS: Residency.STRIPE, IS: Residency.STRIPE}, (OS, IS), _B),
    "is_w_stripe": DataflowSpec(IS, {WS: Residency.STRIPE}, (WS,), _B),
    "is_o_stripe_b_whole": DataflowSpec(
        IS, {OS: Residency.STRIPE, WS: Residency.WHOLE}, (OS, WS), _B),
})
KINDS = {"float32": (torch.float32, None), "int8": (torch.int8, None),
         "packed4": (torch.int8, 4), "packed5": (torch.int8, 5),
         "bfloat16": (torch.bfloat16, None)}
# spec -> (smem_bytes, resident bytes) per KINDS entry at M=37 K=64 N=48
# (test_torch_dataflows.py's PLAN_TABLE shape), from the planner before
# the tensor-core tiles.  os_basic is the one plan that changes: bf16's
# takes the bf16 prefill tile, int8's and packed's the int8 one (None).
PLAN_BEFORE = {
    "is_b_whole": [(26624, (10240, 16384)), (6656, (2560, 4096)), (4608, (2560, 2048)), (5120, (2560, 2560)), (13312, (5120, 8192))],
    "is_basic": [(18944, (10240,)), (11264, (2560,)), (11264, (2560,)), (11264, (2560,)), (13824, (5120,))],
    "is_o_stripe": [(27648, (10240,)), (27648, (10240,)), (27648, (10240,)), (27648, (10240,)), (27648, (10240,))],
    "is_o_stripe_b_whole": [(35328, (10240, 16384)), (23040, (10240, 4096)), (20992, (10240, 2048)), (21504, (10240, 2560)), (27136, (10240, 8192))],
    "is_w_stripe": [(18944, (10240,)), (11264, (2560,)), (11264, (2560,)), (11264, (2560,)), (13824, (5120,))],
    "os_basic": [(17408, ()), None, None, None, None],
    "os_i_stripe": [(18944, (10240,)), (11264, (2560,)), (11264, (2560,)), (11264, (2560,)), (13824, (5120,))],
    "os_w_stripe": [(25088, (16384,)), (12800, (4096,)), (10752, (2048,)), (11264, (2560,)), (16896, (8192,))],
    "os_w_whole_i_stripe": [(26624, (10240, 16384)), (6656, (2560, 4096)), (4608, (2560, 2048)), (5120, (2560, 2560)), (13312, (5120, 8192))],
    "ws_basic": [(25088, (16384,)), (12800, (4096,)), (10752, (2048,)), (11264, (2560,)), (16896, (8192,))],
    "ws_i_stripe": [(26624, (16384, 10240)), (6656, (4096, 2560)), (4608, (2048, 2560)), (5120, (2560, 2560)), (13312, (8192, 5120))],
    "ws_o_i_stripe": [(27648, (10240,)), (27648, (10240,)), (27648, (10240,)), (27648, (10240,)), (27648, (10240,))],
    "ws_o_stripe": [(27648, (10240,)), (27648, (10240,)), (27648, (10240,)), (27648, (10240,)), (27648, (10240,))],
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plans_other_than_bf16_basic_os_are_unchanged(kind):
    dtype, bits = KINDS[kind]
    col = list(KINDS).index(kind)
    for name, spec in SPECS.items():
        want = PLAN_BEFORE[name][col]
        p = matmul_df.plan(spec, 37, 64, 48, dtype, bits)
        if want is None:               # basic OS: the prefill tile
            assert p.tile_kernel == ("matmul_os_prefill"
                                     if dtype == torch.bfloat16
                                     else "matmul_os_i8_prefill"), kind
            continue
        assert (p.smem_bytes, tuple(p.resident.values())) == want, name
        assert p.tile == matmul_df.BLOCK and p.tile_kernel is None, name
        assert p.ctas == 1, name        # one 64x64 tile, or one stripe


# (M, K, N) -> (tile kernel, (bm, bk, bn), CTAs, shared memory bytes)
BF16_BASIC = {
    (512, 6144, 2048): ("matmul_os_prefill", (128, 32, 64), 128, 59392),
    (512, 2048, 6144): ("matmul_os_prefill", (128, 32, 64), 384, 59392),
    (137, 2048, 6144): ("matmul_os_prefill", (128, 32, 64), 192, 59392),
    (17, 2048, 6144): ("matmul_os_prefill", (128, 32, 64), 96, 59392),
    (16, 2048, 6144): ("matmul_os_decode", (16, 256, 16), 384, 165888),
    (4, 6144, 2048): ("matmul_os_decode", (16, 256, 16), 128, 165888),
    (4, 2048, 6144): ("matmul_os_decode", (16, 256, 16), 384, 165888),
    (1, 100, 50): ("matmul_os_decode", (16, 256, 16), 4, 165888),
}


@pytest.mark.parametrize("shape", sorted(BF16_BASIC), ids=str)
def test_bf16_basic_os_plans_a_tensor_core_tile(shape):
    m, k, n = shape
    tile_kernel, tile, ctas, smem = BF16_BASIC[shape]
    p = matmul_df.plan(common.NINE_SPECS["os_basic"], m, k, n, torch.bfloat16)
    assert p.kernel == "matmul_os" and p.args == (0, 0)
    assert (p.tile_kernel, p.tile, p.ctas, p.smem_bytes) == \
        (tile_kernel, tile, ctas, smem)
    assert p.smem_bytes <= matmul_df.MAX_SMEM and p.resident == {}
    assert p.grid_order == "(gm, gn, gk)" and "tensor cores" in p.walk
    # counted beside matmul_os, under a registered kernel of its own
    assert tile_kernel in _build.LAUNCHES
    assert registered_kernels()[tile_kernel].source.endswith("gemm_tc.cuh")


def test_flash_block_follows_the_dtype():
    """The bf16 kernel is compiled for 64x64 tiles, the f32 one for
    16x32; a block other than the dtype's raises."""
    assert attention_df.FLASH_BLOCKS == {torch.bfloat16: (64, 64),
                                         torch.float32: (16, 32)}
    assert attention_df.FLASH.spec.block[:2] == (64, 64)
    for dtype, (bq, bkv) in attention_df.FLASH_BLOCKS.items():
        q = torch.zeros(1, 2, 4, 32, dtype=dtype)
        assert ops.attention(q, q, q, bq=bq, bkv=bkv).dtype == dtype
        other = 16 if bq == 64 else 64
        with pytest.raises(ValueError, match="compiled for"):
            ops.attention(q, q, q, bq=other)


def _bf16(rng, *shape, std=1.0):
    import jax.numpy as jnp

    x = (rng.standard_normal(shape) * std).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("m", [4, 37])
def test_bf16_gemm_plain_version_matches_interpret(m):
    """The bf16 basic OS GEMM's plain version (what the tensor-core
    tiles are held against on the card) against the reference's OS
    kernel in interpret mode, on the same bf16 inputs: both accumulate
    the exact bf16 products in float32, in other orders, so atol 1e-5,
    rtol 1e-5 on outputs of unit size."""
    import jax.numpy as jnp
    from repro.core.dataflow import DataflowSpec as JSpec
    from repro.core.dataflow import OS as JOS
    from repro.kernels import ops as jops

    rng = np.random.default_rng(m)
    k, n = 160, 48
    a, b = _bf16(rng, m, k), _bf16(rng, k, n, std=k ** -0.5)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    want = jops.matmul_fused(jnp.asarray(a, jnp.bfloat16),
                             jnp.asarray(b, jnp.bfloat16),
                             bias=jnp.asarray(bias), activation="silu",
                             spec=JSpec.basic(JOS, block=(32, 32, 32)),
                             backend="interpret")
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    got = ops.matmul_fused(ta, tb, bias=torch.from_numpy(bias),
                           activation="silu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_bf16_flash_plain_version_matches_interpret():
    """bf16 banded GQA attention (per-row kv_len, causal, window) through
    the port's op and the reference's flash kernel in interpret mode:
    both compute in float32 and round the output to bf16, so they agree
    within one bf16 rounding (atol 1e-2, rtol 1e-2 on unit-size v)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    rng = np.random.default_rng(3)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 9, 24, 32
    q, k, v = (_bf16(rng, b, h, s, d) for h, s in
               ((hq, sq), (hkv, skv), (hkv, skv)))
    kv_len = [13, 24]
    want = jops.attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                          causal=True, window=7, anchor="os", bq=8, bkv=8,
                          backend="interpret",
                          kv_len=jnp.asarray(kv_len, jnp.int32))
    got = ops.attention(*(torch.from_numpy(x).to(torch.bfloat16)
                          for x in (q, k, v)), causal=True, window=7,
                        kv_len=torch.tensor(kv_len, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
B1_TOL = dict(atol=1e-3, rtol=1e-3)        # chip_smoke.py's B1_TOL
ATT_TOL = dict(atol=4e-3, rtol=8e-3)       # chip_smoke.py's att_tol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tensor-core kernels run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("m", [4, 37])
def test_bf16_b1_equals_every_anchor_on_the_card(card, m):
    """The tensor-core tile of the basic launch (decode at M = 4,
    prefill at M = 37) equals every feasible dataflow's 64x64 walk bit
    for bit, and its plain version within B1_TOL."""
    gen = torch.Generator(device=card).manual_seed(m)
    k, n = 320, 136
    a = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=card)
         * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn((1, n), generator=gen, device=card)
    base = ops.matmul_fused(a, w, bias=bias, activation="gelu")
    want = ref.matmul_fused_ref(a, w, bias=bias, activation="gelu")
    torch.testing.assert_close(base, want, **B1_TOL)
    ran = 0
    for name, spec in common.NINE_SPECS.items():
        try:
            matmul_df.plan(spec, m, k, n, a.dtype)
        except ValueError:
            continue
        got = ops.matmul_fused(a, w, bias=bias, activation="gelu",
                               spec=spec)
        assert torch.equal(got, base), name
        ran += 1
    assert ran >= 6


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_b2_at_d_head_16_on_the_card(card, dtype):
    """B2 at d_head 16 (the tensor-core tile's single QK^T chunk and two PV
    fragments; the f32 kernel's half-idle lanes) against its plain version
    over causal, windowed and per-row bands (a zero row among them), with
    B2's tolerance (float32: 1e-4)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(16)
    tol = ATT_TOL if dt == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    for b, hq, hkv, sq, skv in ((3, 6, 6, 70, 150), (2, 8, 2, 1, 300),
                                (1, 4, 2, 200, 200)):
        q, k, v = (torch.randn(s, generator=gen, device=card).to(dt) for s in (
            (b, hq, sq, 16), (b, hkv, skv, 16), (b, hkv, skv, 16)))
        lens = torch.tensor([0, 90, skv][:b], device=card, dtype=torch.int32)
        for mask in (dict(), dict(kv_len=lens, window=40),
                     dict(causal=False, kv_len=skv - 9)):
            got = attention_df.flash_attention(q, k, v, **mask)
            want = ref.attention_ref(q, k, v, **mask)
            torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.card
def test_bf16_b2_within_att_tol_on_the_card(card):
    """Banded GQA (per-row kv_len with a zero row, window) on the
    tensor-core flash kernel against its plain version."""
    gen = torch.Generator(device=card).manual_seed(7)
    b, hq, hkv, sq, skv, d = 3, 8, 2, 70, 150, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=card).to(torch.bfloat16)

    q, k, v = randn(b, hq, sq, d), randn(b, hkv, skv, d), randn(b, hkv, skv, d)
    lens = torch.tensor([0, 90, 150], device=card, dtype=torch.int32)
    got = attention_df.flash_attention(q, k, v, kv_len=lens, window=40)
    want = ref.attention_ref(q, k, v, kv_len=lens, window=40)
    torch.testing.assert_close(got.float(), want.float(), **ATT_TOL)
    assert bool((got[0] == 0).all())
