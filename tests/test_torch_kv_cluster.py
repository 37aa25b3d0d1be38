"""B7 (KV-stationary attention) and B5b (IS with the output stripe) on
thread-block clusters: what the CPU can hold, and the card-only checks.

On the CPU: ``attention_df.kv_stationary_plan`` gives B7's bf16 cluster
kernel (``csrc/kv_stationary.cu``) its cluster, CTAs and shared memory,
pinned at qwen3-1.7b's widths; every unit (q head of the group, 64-row q
tile) belongs to exactly one CTA of its cluster; each CTA's schedule
(``attention_df.kv_schedule``, the kernel's walk) visits its units' KV
bands in ascending order, block by block, and a unit whose band is empty
writes zeros; the band holds every visible (row, key) pair; the WS
anchor's compiled block follows the dtype; ``matmul_df.plan`` gives B5b's
bf16 stripes of 2 to 32 column tiles their cluster walk (pinned), every
other B5b plan keeping the one-CTA kernel; ``check_took`` raises where a
launch's report drifts from its plan; the new keys are registered and
counted from the report.

On the card (marker ``card``, skipped here): B7 equals B2 bit for bit at
bf16 over causal, windowed, scalar and per-row ``kv_len`` (0 among them),
Sq = 1, 3, 17, 65 and 200 and groups of 1, 2 and 4, and stays within B2's
tolerance of the plain version; B5b's cluster walk equals B1 bit for bit
at ragged M, N and K with every epilogue stage, and with B whole.  The
card's machine has no JAX; this module imports none, so it runs there
without the repo's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q -m card \
        tests/test_torch_kv_cluster.py
"""
import pytest
import torch

from repro_torch.bench import common
from repro_torch.core.dataflow import (DataflowSpec, Residency, IS, OS, WS,
                                       registered_kernels)
from repro_torch.kernels import _build, attention_df, matmul_df, ops, ref

NINE = common.NINE_SPECS
IS_O_STRIPE_B_WHOLE = DataflowSpec(
    IS, {OS: Residency.STRIPE, WS: Residency.WHOLE}, (OS, WS), matmul_df.BLOCK)

# (B, Hq, Hkv, Sq, Skv, D) -> (cluster, CTAs, shared memory): qwen3-1.7b
# prefill at the attention-anchor bench's 512 and 2048, a short prompt
# against a long cache, and a 3-row decode-sized tile.
KV_PLANS = {
    (1, 16, 8, 512, 512, 128): (16, 128, 65664),
    (1, 16, 8, 2048, 2048, 128): (16, 128, 65664),
    (1, 16, 8, 17, 1024, 128): (2, 16, 65664),
    (1, 16, 8, 3, 64, 128): (2, 16, 65664),
    (4, 4, 4, 3, 64, 64): (1, 16, 32896),
    (2, 8, 2, 200, 200, 32): (16, 64, 16512),
}


@pytest.mark.parametrize("shape", sorted(KV_PLANS), ids=str)
def test_kv_plan_is_pinned(shape):
    b, hq, hkv, sq, skv, d = shape
    plan = attention_df.kv_stationary_plan(b, hq, hkv, sq, skv, d=d)
    assert tuple(plan) == KV_PLANS[shape]
    # a cluster per (batch row, kv head); 2 ring slots of a 64-key K and V
    # block and 4 mbarriers (a 128-byte line)
    assert plan.ctas == b * hkv * plan.cluster
    assert plan.smem_bytes == 2 * 2 * 64 * d * 2 + 128
    units = -(-sq // 64) * (hq // hkv)    # (q head, 64-row q tile) units
    assert plan.cluster <= units
    assert attention_df.kv_stationary_plan(b, hq, hkv, sq, skv,
                                           torch.float32, d) is None


def test_kv_cluster_size_rule():
    """Doubled from 2 while SMs stay idle, up to 16 and the units; one CTA
    for one unit."""
    for clusters in (1, 2, 8, 16, 64):
        for units in range(1, 70):   # Sq = 1: one q tile, `units` q heads
            c = attention_df.kv_stationary_plan(clusters, units, 1, 1,
                                                64).cluster
            assert c == 1 if units == 1 else c in (2, 4, 8, 16)
            assert c <= units
            assert c <= 2 or clusters * c // 2 < matmul_df.CARD_SMS
            assert c in (1, 16) or 2 * c > units or \
                clusters * c >= matmul_df.CARD_SMS


@pytest.mark.parametrize("cluster", range(1, 17))
def test_every_unit_belongs_to_exactly_one_cta(cluster):
    for units in range(1, 80):
        owned = [u for r in range(cluster)
                 for u in matmul_df.cluster_tiles(units, cluster, r)]
        assert sorted(owned) == list(range(units)), (units, cluster)


def _visible(sq, skv, kv_valid, causal, window, row, key):
    qpos = row + kv_valid - sq
    ok = key < kv_valid and key < skv
    if causal:
        ok = ok and key <= qpos
    if window:
        ok = ok and key > qpos - window
    return ok


# (Sq, Skv, kv_valid, group, causal, window)
SCHEDULES = [
    (512, 512, 512, 2, True, None), (200, 200, 200, 4, True, 64),
    (65, 300, 120, 1, True, None), (17, 1024, 65, 2, True, None),
    (130, 130, 0, 2, True, None), (3, 64, 5, 4, True, 24),
    (100, 256, 256, 2, False, None), (150, 70, 70, 2, True, None),
    (300, 300, 300, 1, True, 20),
]


@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_each_cta_folds_its_units_bands_in_ascending_order(case):
    sq, skv, kv_valid, group, causal, window = case
    gq = -(-sq // 64)
    units = gq * group
    bands = {u: attention_df.kv_band(u // group * 64, sq, skv, kv_valid,
                                     causal, window) for u in range(units)}
    for cluster in (1, 2, 3, 4, 8, 16):
        folded, zeros = {}, []
        for rank in range(cluster):
            steps = attention_df.kv_schedule(sq, skv, kv_valid, group, causal,
                                             window, cluster, rank)
            blocks = [s[1] for s in steps if s[0] == "fold"]
            assert blocks == sorted(blocks)            # KV-block-outer walk
            for step in steps:
                assert step[-1] % cluster == rank      # its own units only
                if step[0] == "fold":
                    folded.setdefault(step[2], []).append(step[1])
                else:
                    zeros.append(step[1])
        for u, (lo, hi) in bands.items():
            if lo <= hi:   # every block of the band, once, in order
                assert folded[u] == list(range(lo, hi + 1)), (u, cluster)
                assert u not in zeros
            else:          # an empty band: no fold, one write of zeros
                assert u not in folded and zeros.count(u) == 1


@pytest.mark.parametrize("case", SCHEDULES, ids=str)
def test_the_band_holds_every_visible_key(case):
    sq, skv, kv_valid, group, causal, window = case
    for q0 in range(0, sq, 64):
        lo, hi = attention_df.kv_band(q0, sq, skv, kv_valid, causal, window)
        for row in range(q0, min(q0 + 64, sq)):
            for key in range(skv):
                if _visible(sq, skv, kv_valid, causal, window, row, key):
                    assert lo <= key // 64 <= hi, (q0, row, key)


def test_kv_blocks_follow_the_dtype():
    """B7's bf16 cluster kernel takes B2's 64x64 tiles, its float32 kernel
    16x32; the WS anchor's block check reads the dtype's."""
    assert attention_df.KV_BLOCKS == {torch.bfloat16: (64, 64),
                                      torch.float32: (16, 32)}
    assert attention_df.KV_BLOCKS == attention_df.FLASH_BLOCKS
    for dtype, (bq, bkv) in attention_df.KV_BLOCKS.items():
        q = torch.zeros(1, 2, 4, 32, dtype=dtype)
        out = ops.attention(q, q, q, anchor="ws", bq=bq, bkv=bkv)
        assert out.dtype == dtype
        other = 16 if bq == 64 else 64
        with pytest.raises(ValueError, match="compiled for"):
            ops.attention(q, q, q, anchor="ws", bq=other)


def test_kv_check_took_holds_the_report_against_the_plan():
    plan = attention_df.kv_stationary_plan(1, 16, 8, 512, 512)
    took = ("kv_stationary_cluster", plan.smem_bytes, plan.ctas, plan.cluster)
    attention_df.check_took(plan, took)
    drifts = {"tile": ("matmul_os_cluster",) + took[1:],
              "bytes": (took[0], took[1] + 1024) + took[2:],
              "ctas": took[:2] + (took[2] * 2, took[3]),
              "cluster": took[:3] + (8,),
              "no cluster": took[:3],
              "f32 kernel": None}
    for what, bad in drifts.items():
        with pytest.raises(_build.KernelError, match="plan says"):
            attention_df.check_took(plan, bad)
    attention_df.check_took(None, None)        # float32: no report
    with pytest.raises(_build.KernelError):
        attention_df.check_took(None, took)


# (spec, M, K, N) -> (cluster, CTAs, one CTA's shared memory): the paper's
# layer (56,3,1,128) (B5b's timed shape), column sweeps needing C = 8, and
# qwen3-1.7b's decode-width down projection (32 column tiles, C = 16).
IS_CLUSTER_PLANS = {
    ("is_o_stripe", 2916, 1152, 128): (2, 92, 65664),
    ("is_o_stripe", 2916, 1152, 512): (4, 184, 98432),
    ("is_o_stripe", 64, 1152, 512): (8, 8, 65664),
    ("is_o_stripe", 729, 1152, 832): (8, 96, 98432),
    ("is_o_stripe", 4, 6144, 2048): (16, 16, 98432),
    ("is_o_stripe_b_whole", 729, 256, 128): (2, 24, 65664),
}
SPECS = dict(NINE, is_o_stripe_b_whole=IS_O_STRIPE_B_WHOLE)


@pytest.mark.parametrize("case", sorted(IS_CLUSTER_PLANS), ids=str)
def test_is_stripe_cluster_plans_are_pinned(case):
    name, m, k, n = case
    cluster, ctas, smem = IS_CLUSTER_PLANS[case]
    p = matmul_df.plan(SPECS[name], m, k, n, torch.bfloat16)
    assert p.kernel == "matmul_is_stripe"
    assert (p.tile_kernel, p.cluster, p.ctas, p.smem_bytes) == \
        ("matmul_is_stripe_cluster", cluster, ctas, smem)
    gm, gn = -(-m // 64), -(-n // 64)
    assert ctas == gm * cluster and -(-gn // cluster) <= matmul_df.STRIPE_TILES
    # 4 chunks of 2 k steps of the input stripe and of the busiest CTA's B
    # tiles, and 8 mbarriers
    assert smem == 4 * 2 * 4096 * (1 + -(-gn // cluster)) + 128
    assert smem == matmul_df.stripe_cluster_smem(gn, cluster)


@pytest.mark.parametrize("shape", [(37, 64, 48), (2916, 1152, 64),
                                   (4, 2048, 6144), (8, 1024, 2112)])
def test_is_stripe_keeps_one_cta_outside_two_to_32_column_tiles(shape):
    """One column tile, or more than 16 CTAs hold in registers (feasible
    only below 64 rows): the one-CTA kernel."""
    m, k, n = shape
    p = matmul_df.plan(NINE["is_o_stripe"], m, k, n, torch.bfloat16)
    assert p.tile_kernel is None and p.cluster is None
    assert p.ctas == -(-m // 64)


def test_is_stripe_other_types_keep_the_one_cta_kernel():
    for dtype, bits in ((torch.float32, None), (torch.int8, None),
                        (torch.int8, 4), (torch.int8, 5)):
        p = matmul_df.plan(NINE["is_o_stripe"], 2916, 1152, 128, dtype, bits)
        assert p.tile_kernel is None and p.cluster is None
        assert p.ctas == 46 and p.walk == "CTA per row stripe i, sweeps k then j"


def test_is_stripe_check_took_raises_on_drift():
    p = matmul_df.plan(NINE["is_o_stripe"], 2916, 1152, 128)
    took = (p.tile_kernel, p.smem_bytes, p.ctas, p.cluster)
    matmul_df.check_took(p, took)
    for bad in (("matmul_ws_stripe_cluster",) + took[1:],
                (took[0], took[1] + 4096) + took[2:],
                took[:2] + (46, took[3]), took[:3] + (4,), None):
        with pytest.raises(_build.KernelError, match="plan says"):
            matmul_df.check_took(p, bad)


@pytest.mark.parametrize("key,library,source", [
    ("kv_stationary_cluster", "kv_stationary", "csrc/kv_stationary.cu"),
    ("matmul_is_stripe_cluster", "matmul_is_stripe", "csrc/gemm_cluster.cuh")])
def test_new_keys_are_registered_and_counted(monkeypatch, key, library,
                                             source):
    regs = registered_kernels()
    assert regs[key].source.endswith(source)
    assert regs[key].replaces == regs[library].replaces
    assert _build.TILE_LIBRARIES[library] == (key,)
    assert "flash_tc.cuh" in _build.HEADERS

    class Lib:
        pass

    def entry(*args):
        took, stream = args[-2:]
        took[0], took[1], took[2], took[3] = 1, 131200, 128, 16
        return 0

    setattr(Lib, library, staticmethod(entry))
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    assert _build.launch(library, 1, 2) == (key, 131200, 128, 16)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {library: 1, key: 1}


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cluster kernels run only there")
    return torch.device("cuda")


# (causal, window, kv_len): kv_len "short" is a scalar below Skv, a list
# one length per batch row (0 among them).
MASKS = [(True, None, None), (True, 24, "short"), (False, None, [0, 40]),
         (True, 40, [70, 0]), (False, 16, "short")]


@pytest.mark.card
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 3, 17, 65, 200])
def test_kv_stationary_equals_flash_bitwise_on_the_card(card, sq, group):
    """bf16 B7 on its cluster kernel (counted under its key, the report
    held against its plan) equals B2 bit for bit, and stays within B2's
    tolerance of the plain version."""
    hkv, d = 2, 128 if group != 4 else 64
    b, skv = 2, sq + 57
    gen = torch.Generator(device=card).manual_seed(sq * 10 + group)
    q = torch.randn((b, hkv * group, sq, d), generator=gen,
                    device=card).to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                        device=card).to(torch.bfloat16) for _ in range(2))
    for causal, window, kv_len in MASKS:
        lens = {None: None, "short": skv - 9}.get(kv_len) \
            if not isinstance(kv_len, list) else \
            torch.tensor(kv_len, dtype=torch.int32, device=card)
        before = _build.LAUNCHES["kv_stationary_cluster"]
        got = attention_df.kv_stationary_attention(
            q, k, v, causal=causal, window=window, kv_len=lens)
        assert _build.LAUNCHES["kv_stationary_cluster"] == before + 1
        want = attention_df.flash_attention(q, k, v, causal=causal,
                                            window=window, kv_len=lens)
        assert torch.equal(got, want), (causal, window, kv_len, (
            got.float() - want.float()).abs().max())
        plain = ref.attention_ref(q, k, v, causal=causal, window=window,
                                  kv_len=lens)
        assert torch.allclose(got.float(), plain.float(), atol=4e-3,
                              rtol=8e-3)


@pytest.mark.card
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 17, 200])
def test_kv_stationary_at_d_head_16_on_the_card(card, sq, group):
    """d_head 16: bf16 B7 on its cluster kernel (32-byte rows under the
    TMA's 32-byte swizzle) equals B2 bit for bit; float32 B7 equals B2's
    f32 kernel bit for bit and both hold 1e-4 of the plain version."""
    hkv, d = 2, 16
    b, skv = 2, sq + 57
    gen = torch.Generator(device=card).manual_seed(sq * 10 + group + 16)
    q = torch.randn((b, hkv * group, sq, d), generator=gen, device=card)
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=card)
            for _ in range(2))
    for causal, window, kv_len in MASKS:
        lens = {None: None, "short": skv - 9}.get(kv_len) \
            if not isinstance(kv_len, list) else \
            torch.tensor(kv_len, dtype=torch.int32, device=card)
        mask = dict(causal=causal, window=window, kv_len=lens)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        before = _build.LAUNCHES["kv_stationary_cluster"]
        got = attention_df.kv_stationary_attention(qb, kb, vb, **mask)
        assert _build.LAUNCHES["kv_stationary_cluster"] == before + 1
        assert torch.equal(got, attention_df.flash_attention(
            qb, kb, vb, **mask)), (causal, window, kv_len)
        assert torch.allclose(got.float(), ref.attention_ref(
            qb, kb, vb, **mask).float(), atol=4e-3, rtol=8e-3)
        got32 = attention_df.kv_stationary_attention(q, k, v, **mask)
        assert torch.equal(got32, attention_df.flash_attention(
            q, k, v, **mask)), ("float32", causal, window, kv_len)
        assert torch.allclose(got32, ref.attention_ref(q, k, v, **mask),
                              atol=1e-4, rtol=1e-4)


@pytest.mark.card
def test_kv_stationary_several_units_a_cta_on_the_card(card):
    """Sq = 2048 at qwen3-1.7b's widths: 4 units a CTA, the state through
    device memory between KV blocks; D = 32 at 64 units over 2 clusters."""
    for b, hq, hkv, sq, d in ((1, 16, 8, 2048, 128), (1, 8, 2, 1000, 32)):
        gen = torch.Generator(device=card).manual_seed(sq)
        q = torch.randn((b, hq, sq, d), generator=gen,
                        device=card).to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, sq, d), generator=gen,
                            device=card).to(torch.bfloat16) for _ in range(2))
        plan = attention_df.kv_stationary_plan(b, hq, hkv, sq, sq, d=d)
        assert -(-sq // 64) * (hq // hkv) > plan.cluster   # units a cluster
        for window in (None, 300):
            assert torch.equal(
                attention_df.kv_stationary_attention(q, k, v, window=window),
                attention_df.flash_attention(q, k, v, window=window))


@pytest.mark.card
@pytest.mark.parametrize("m", [37, 65, 200])
@pytest.mark.parametrize("k,n", [(200, 136), (100, 130), (64, 520)])
def test_is_stripe_cluster_equals_b1_on_the_card(card, m, k, n):
    """B5b's cluster walk equals B1's basic launch bit for bit, with a
    per-column scale, bias, gelu and residual to f32, and a per-row scale
    to bf16, B streamed or whole; each counted once under its cluster key.
    K = 200, N = 136 take the TMA, K = 100, N = 130 element loads and the
    exchange; N = 520 is 9 column tiles (clusters of 8)."""
    gen = torch.Generator(device=card).manual_seed(m * 7 + k)
    a = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=card)
         * k ** -0.5).to(torch.bfloat16)
    epis = (dict(scale=torch.rand((1, n), generator=gen, device=card) + 0.5,
                 bias=torch.randn((1, n), generator=gen, device=card),
                 activation="gelu",
                 residual=torch.randn((m, n), generator=gen, device=card),
                 out_dtype=torch.float32),
            dict(scale=torch.rand((m, 1), generator=gen, device=card) + 0.5,
                 out_dtype=torch.bfloat16))
    ran = 0
    for epi in epis:
        base = matmul_df.matmul_os(a, b, **epi)
        for spec in (NINE["is_o_stripe"], IS_O_STRIPE_B_WHOLE):
            try:
                p = matmul_df.plan(spec, m, k, n)
            except ValueError:
                continue
            assert p.tile_kernel == "matmul_is_stripe_cluster"
            before = _build.LAUNCHES["matmul_is_stripe_cluster"]
            got = matmul_df.matmul_df(a, b, spec, **epi)
            assert _build.LAUNCHES["matmul_is_stripe_cluster"] == before + 1
            assert torch.equal(got, base), (got.float() - base.float()) \
                .abs().max()
            ran += 1
    assert ran >= 2
