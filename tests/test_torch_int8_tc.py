"""B1's int8 and packed basic OS launch on the integer tensor cores
(``csrc/gemm_tc_i8.cuh``): what the CPU can hold, and the card-only
checks.

On the CPU: ``matmul_df.plan`` names the int8 tiles (prefill for M > 16,
decode for M <= 16) with their CTAs and ring bytes; a launch counts the
tile the kernel reports and raises where the plan differs from it; and
two pieces of the tiles' arithmetic that a wrong answer could hide, as
design notes in numpy: B6's fragment decode (``pack_common.cuh``
``decode_frag``) against ``pack.unpack_block``, and the dense B tile's
swizzle being a conflict-free permutation.  The card test below is what
holds the kernels themselves.

On the card (marker ``card``, skipped here): int8 and packed 4/5-bit B1
on the tiles equals its plain version and every feasible anchor (the
integer walks on the CUDA cores) bit for bit, with outlier rows that the
activations hit:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \\
        tests/test_torch_int8_tc.py
"""
import numpy as np
import pytest
import torch

from repro_torch.bench import common
from repro_torch.core.dataflow import registered_kernels
from repro_torch.kernels import _build, matmul_df, ops, pack, ref

OS_BASIC = common.NINE_SPECS["os_basic"]
KIND_BITS = {"int8": None, "packed4": 4, "packed5": 5}
_PRE, _DEC = "matmul_os_i8_prefill", "matmul_os_i8_decode"
# (kind, (M, K, N)) -> (tile kernel, (bm, bk, bn), CTAs, ring bytes):
# for M > 16 128x64 tiles on 4 stages of 128-deep k steps; for
# M <= 16 64 (int8, 3 stages) or 32 (packed, 4
# stages) columns of 512-deep steps.  A rows take bk + 32 bytes; B takes
# bk x bn bytes (int8) or its planes' words, rows of bn + 8 words.
I8_BASIC = {
    ("int8", (4, 2048, 6144)): (_DEC, (16, 512, 64), 96, 124416),
    ("int8", (4, 6144, 2048)): (_DEC, (16, 512, 64), 32, 124416),
    ("int8", (512, 2048, 6144)): (_PRE, (128, 128, 64), 384, 114688),
    ("int8", (512, 6144, 2048)): (_PRE, (128, 128, 64), 128, 114688),
    ("int8", (37, 100, 50)): (_PRE, (128, 128, 64), 1, 114688),
    ("packed4", (4, 2048, 6144)): (_DEC, (16, 512, 32), 192, 75776),
    ("packed4", (4, 6144, 2048)): (_DEC, (16, 512, 32), 64, 75776),
    ("packed4", (512, 2048, 6144)): (_PRE, (128, 128, 64), 384, 100352),
    ("packed4", (512, 6144, 2048)): (_PRE, (128, 128, 64), 128, 100352),
    ("packed4", (37, 100, 50)): (_PRE, (128, 128, 64), 1, 100352),
    ("packed5", (4, 2048, 6144)): (_DEC, (16, 512, 32), 192, 86016),
    ("packed5", (4, 6144, 2048)): (_DEC, (16, 512, 32), 64, 86016),
    ("packed5", (512, 2048, 6144)): (_PRE, (128, 128, 64), 384, 104960),
    ("packed5", (512, 6144, 2048)): (_PRE, (128, 128, 64), 128, 104960),
    ("packed5", (37, 100, 50)): (_PRE, (128, 128, 64), 1, 104960),
}


@pytest.mark.parametrize("case", sorted(I8_BASIC), ids=str)
def test_int8_basic_os_plans_an_integer_tensor_core_tile(case):
    kind, (m, k, n) = case
    tile_kernel, tile, ctas, smem = I8_BASIC[case]
    p = matmul_df.plan(OS_BASIC, m, k, n, torch.int8, KIND_BITS[kind])
    assert p.kernel == "matmul_os" and p.args == (0, 0)
    assert (p.tile_kernel, p.tile, p.ctas, p.smem_bytes) == \
        (tile_kernel, tile, ctas, smem)
    assert p.smem_bytes <= matmul_df.MAX_SMEM and p.resident == {}
    assert "int8 tensor cores" in p.walk
    # counted beside matmul_os, under a registered kernel of its own
    assert tile_kernel in _build.LAUNCHES
    assert registered_kernels()[tile_kernel].source.endswith(
        "gemm_tc_i8.cuh")


@pytest.mark.parametrize("bits", [None, 4, 5])
def test_int8_residencies_keep_the_integer_walk(bits):
    """Only the basic launch moves to the tiles: every other int8 or
    packed spec keeps its 64x64 walk and its pre-tile plan."""
    for name, spec in common.NINE_SPECS.items():
        if name == "os_basic":
            continue
        try:
            p = matmul_df.plan(spec, 37, 64, 48, torch.int8, bits)
        except ValueError:
            continue
        assert p.tile_kernel is None and p.tile == matmul_df.BLOCK, name


# ---------------------------------------------------------------------------
# The tile a launch took, as the kernel reports it.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(I8_BASIC), ids=str)
def test_check_took_accepts_the_planned_tile(case):
    kind, (m, k, n) = case
    tile_kernel, _, ctas, smem = I8_BASIC[case]
    p = matmul_df.plan(OS_BASIC, m, k, n, torch.int8, KIND_BITS[kind])
    matmul_df.check_took(p, (tile_kernel, smem, ctas))


@pytest.mark.parametrize("drift", ["tile", "smem", "ctas", "walk"])
def test_check_took_raises_when_the_plan_drifts_from_the_kernel(drift):
    """The planner's copy of the tile shapes disagreeing with what the
    kernel launched is a fault, not a quiet miscount."""
    p = matmul_df.plan(OS_BASIC, 4, 6144, 2048, torch.int8, 4)
    took = {"tile": (_PRE, p.smem_bytes, p.ctas),
            "smem": (p.tile_kernel, p.smem_bytes + 16, p.ctas),
            "ctas": (p.tile_kernel, p.smem_bytes, p.ctas * 2),
            "walk": None}[drift]
    with pytest.raises(_build.KernelError, match="plan says"):
        matmul_df.check_took(p, took)
    walk = matmul_df.plan(common.NINE_SPECS["os_w_stripe"], 4, 6144, 2048,
                          torch.int8, 4)
    matmul_df.check_took(walk, None)
    with pytest.raises(_build.KernelError):
        matmul_df.check_took(walk, (p.tile_kernel, p.smem_bytes, p.ctas))


@pytest.mark.parametrize("code", range(len(_build.TILES) + 1))
def test_launch_counts_the_tile_the_kernel_reports(monkeypatch, code):
    """``_build.launch`` counts the tile from the entry point's report
    (``gemm::Took``), whatever the caller planned."""
    class Lib:
        @staticmethod
        def matmul_os(*args):
            took, stream = args[-2:]
            took[0], took[1], took[2] = code, 1000 + code, 7
            assert args[:-2] == (1, 2, 3) and stream == 0
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    got = _build.launch("matmul_os", 1, 2, 3, packed=True)
    tile = _build.TILES[code - 1] if code else None
    assert got == (None if tile is None else (tile, 1000 + code, 7))
    counted = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert counted == {"matmul_os": 1, _build.PACKED_DECODE: 1,
                       **({tile: 1} if tile else {})}


@pytest.mark.parametrize("bits", [4, 5])
def test_packed_read_bytes_counts_only_filled_delta_rows(bits):
    """A bound's packed weight bytes: planes, every slot index, and the
    delta rows of the filled slots (the tiles skip the empty ones)."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(bits)
    k, n = 1000, 48
    pw = layers.draw_packed(gen, k, n, bits)
    cap, kp = pack.outlier_capacity(k), 1024
    assert pw.outlier_idx.shape[0] == cap > 2
    planes = kp // 8 + (kp // 32 if bits == 5 else 0)
    assert common.packed_read_bytes(pw) == 4 * (planes * n + cap + 2 * n)
    assert common.packed_read_bytes(pw) < pack.packed_bytes(k, n, bits)


def test_packed_read_bytes_of_conv_weights():
    q = torch.zeros((3, 3, 40, 16))
    q[1, 2, 7] = 1.0          # an outlier row that sets every scale
    q[0, 0, 0, 3] = -0.3      # and one hit in a single channel
    pcw = pack.pack_conv_weights(q, 4)
    r = pcw.outlier_idx.shape[0]
    filled = int((pcw.outlier_idx < 3 * 3 * 64).sum())
    assert filled >= 1
    assert common.packed_read_bytes(pcw) == 4 * (
        3 * 3 * 64 // 8 * 16 + r + filled * 16)


# ---------------------------------------------------------------------------
# Design notes: two pieces of csrc/gemm_tc_i8.cuh's arithmetic in numpy.
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _u32(x):
    return np.asarray(x, dtype=np.uint64) & _M32


def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)``: byte i of the result is byte
    ``(sel >> 4i) & 7`` of the 8 bytes (x low, y high)."""
    both = _u32(x) | (_u32(y) << np.uint64(32))
    out = np.zeros_like(both)
    for i in range(4):
        src = np.uint64((sel >> (4 * i)) & 7)
        out |= ((both >> (src * np.uint64(8))) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out


def _decode_frag(w, h8, bits):
    """``pack_common.cuh`` ``decode_frag`` on uint32 words."""
    w = _u32(w)
    lo = w & np.uint64(0x0F0F0F0F)
    hi = (w >> np.uint64(4)) & np.uint64(0x0F0F0F0F)
    u0, u1 = _byte_perm(lo, hi, 0x5140), _byte_perm(lo, hi, 0x7362)
    if bits == 5:
        h8 = _u32(h8)
        for half, u in ((0, u0), (1, u1)):
            x = (h8 >> np.uint64(4 * half)) & np.uint64(0xF)
            u |= _u32(x * np.uint64(0x02040810)) & np.uint64(0x10101010)
    bias = np.uint64(0x70707070 if bits == 5 else 0x78787878)
    return [_u32(u + bias) ^ np.uint64(0x80808080) for u in (u0, u1)]


def _bytes_of(reg):
    """(..., ) uint32 registers -> (..., 4) int8, the low byte first."""
    return np.asarray(reg, dtype=np.uint32).view(np.int8).reshape(
        *np.shape(reg), 4)


@pytest.mark.parametrize("bits", [4, 5])
def test_fragment_decode_matches_unpack_block(bits):
    """Every nibble word and bit-plane byte a lane sees decodes to the
    int8 values ``unpack_block`` gives for its 8 rows."""
    rng = np.random.default_rng(bits)
    n = 512
    words = rng.integers(0, 2 ** 32, (4, n), dtype=np.uint64)  # 32 rows
    hi = rng.integers(0, 2 ** 32, (1, n), dtype=np.uint64)
    want = pack.unpack_block(
        torch.from_numpy(words.astype(np.uint32).view(np.int32)),
        torch.from_numpy(hi.astype(np.uint32).view(np.int32)), bits,
        32).numpy()                                           # (32, n)
    for t in range(4):                     # lane t: rows 8t..8t+7
        h8 = (hi[0] >> np.uint64(8 * t)) & np.uint64(0xFF)
        f0, f1 = _decode_frag(words[t], h8, bits)
        got = np.concatenate([_bytes_of(f0), _bytes_of(f1)], axis=-1)
        np.testing.assert_array_equal(got, want[8 * t:8 * t + 8].T)


def _b_unit(c_units, kk, c):
    """``b_unit<C>``: the swizzled 16-byte unit of (row kk, unit c)."""
    if c_units == 1:
        z = ((kk >> 3) & 3) << 1
    elif c_units == 2:
        z = ((kk >> 3) & 1) | (((kk >> 4) & 1) << 2)
    elif c_units == 4:
        z = (kk >> 3) & 3
    else:
        z = ((kk >> 3) & 3) | ((kk & 1) << 2)
    return (kk * c_units + c) ^ z


@pytest.mark.parametrize("c_units", [1, 2, 4, 8])
def test_dense_b_swizzle_is_a_conflict_free_permutation(c_units):
    """``b_unit<C>`` permutes a 64-row tile's units, and each ldmatrix
    phase (8 rows of one unit column) hits 8 distinct bank groups."""
    units = [_b_unit(c_units, kk, c) for kk in range(64)
             for c in range(c_units)]
    assert sorted(units) == list(range(64 * c_units))
    for kb in (0, 32):
        for j in range(4):
            for c in range(c_units):
                rows = [kb + 8 * (i >> 1) + 2 * j + (i & 1) for i in range(8)]
                groups = {_b_unit(c_units, r, c) % 8 for r in rows}
                assert len(groups) == 8, (kb, j, c)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tensor-core kernels run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KIND_BITS))
@pytest.mark.parametrize("m", [4, 16, 37, 200])
def test_int8_b1_tiles_equal_every_anchor_on_the_card(card, kind, m):
    """The tile of the basic launch (decode at M <= 16, prefill above)
    equals its plain version and every feasible dataflow's integer walk
    bit for bit: int32 out, and the fused dequant + bias + gelu.  The
    packed weight's outlier rows carry spikes that every activation row
    hits, so a sidecar added to the wrong output would show.  Vector
    loads (K = 320, N = 192) and element loads (K = 100, N = 50)."""
    from repro_torch.models import layers

    bits = KIND_BITS[kind]
    for k, n in ((320, 192), (100, 50)):
        gen = torch.Generator(device=card).manual_seed(m * 1000 + k)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=card,
                           dtype=torch.int8)
        aq[aq == 0] = 1
        if bits is None:
            bq = torch.randint(-127, 128, (k, n), generator=gen,
                               device=card, dtype=torch.int8)
            call = (lambda spec: matmul_df.matmul_df(aq, bq, spec))
            want = ref.matmul_ref(aq, bq)
        else:
            pw = layers.draw_packed(gen, k, n, bits, card)
            assert int((pw.outlier_idx < pw.k_pad).sum()) == 2
            call = (lambda spec: matmul_df.matmul_df(
                aq, pw.codes, spec, weight_bits=bits, b_hi=pw.highbits,
                outlier_idx=pw.outlier_idx, outlier_delta=pw.outlier_delta))
            want = ref.matmul_ref(aq, pack.unpack_weights(pw)[0])
        p = matmul_df.plan(OS_BASIC, m, k, n, torch.int8, bits)
        before = _build.LAUNCHES[p.tile_kernel]
        base = call(OS_BASIC)
        assert _build.LAUNCHES[p.tile_kernel] == before + 1
        assert base.dtype == torch.int32 and torch.equal(base, want)
        ran = 0
        for name, spec in common.NINE_SPECS.items():
            try:
                matmul_df.plan(spec, m, k, n, torch.int8, bits)
            except ValueError:
                continue
            assert torch.equal(call(spec), base), name
            ran += 1
        assert ran >= 6
        scale = torch.rand((1, n), generator=gen, device=card) * 1e-3
        bias = torch.randn((1, n), generator=gen, device=card)
        if bits is None:
            fused = ops.matmul_fused(aq, bq, scale=scale, bias=bias,
                                     activation="gelu")
            walk = ops.matmul_fused(aq, bq, scale=scale, bias=bias,
                                    activation="gelu",
                                    spec=common.NINE_SPECS["os_w_stripe"])
        else:
            fused = ops.matmul_packed_fused(aq, pw, bias=bias,
                                            activation="gelu")
            walk = ops.matmul_packed_fused(
                aq, pw, bias=bias, activation="gelu",
                spec=common.NINE_SPECS["os_w_stripe"])
        assert torch.equal(fused, walk)
