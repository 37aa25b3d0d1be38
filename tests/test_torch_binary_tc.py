"""B9's basic OS launch on Hopper's binary tensor cores (``mma.sync``
m16n8k256 ``.b1 .and.popc``, ``csrc/binary_mm.cu``): what the CPU can
hold, and the card-only checks.

On the CPU: ``binary_mm.plan`` names the tiles (decode for M <= 16,
prefill above) with their CTAs and shared memory while WS and IS keep
their walk; a launch counts the tile the kernel reports and raises where
the plan differs from it; and the tiles' arithmetic as a design note in
numpy: the m16n8k256 ``.b1`` fragment layout (PTX ISA), the ``ldmatrix``
rows the prefill tile reads A's fragments with, the AND count turned into
the xor count by popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), the
quad sums and the column shuffles, and the decode tile's warps splitting
k.  The model's dots are held against ``ref.binary_matmul_ref`` and the
JAX package's Pallas kernel in interpret mode, bit for bit.

On the card (marker ``card``, skipped here): every anchor, both tiles
among them, equals the plain version bit for bit at the served shapes:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \\
        tests/test_torch_binary_tc.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import DataflowSpec as JSpec, OS as JOS
from repro.kernels import ops as jops
from repro_torch.core import dataflow as tdf
from repro_torch.core.dataflow import registered_kernels
from repro_torch.kernels import _build, binary_mm, matmul_df, ref

OS = binary_mm.BASIC_OS
WS = tdf.DataflowSpec.basic(tdf.WS, block=binary_mm.BLOCK)
IS = tdf.DataflowSpec.basic(tdf.IS, block=binary_mm.BLOCK)
_PRE, _DEC = "binary_mm_prefill", "binary_mm_decode"
# (M, Kp, N) -> (tile kernel, CTAs, shared memory bytes): 64x64 output
# tiles (4 x 2 warps) on a 3-stage ring of 32-word stages (A rows of 36
# words, B rows of 72: 3 x (64 x 36 + 32 x 72) x 4 bytes), or 16 columns
# a CTA with 8 warps' 16 x 16 int32 partials.
TILES = {
    (511, 64, 6144): (_PRE, 8 * 96, 55296),     # served up, prefill
    (511, 192, 2048): (_PRE, 8 * 32, 55296),    # served down, prefill
    (17, 64, 6144): (_PRE, 1 * 96, 55296),
    (16, 64, 6144): (_DEC, 384, 8192),
    (4, 64, 6144): (_DEC, 384, 8192),           # served up, decode
    (4, 192, 2048): (_DEC, 128, 8192),          # served down, decode
    (1, 5, 50): (_DEC, 4, 8192),
    (37, 5, 50): (_PRE, 1, 55296),
}


@pytest.mark.parametrize("shape", sorted(TILES), ids=str)
def test_basic_os_plans_a_binary_tensor_core_tile(shape):
    m, kp, n = shape
    tile_kernel, ctas, smem = TILES[shape]
    p = binary_mm.plan(OS, m, kp, n)
    assert (p.kernel, p.args) == ("binary_mm", (0,))
    assert (p.tile_kernel, p.ctas, p.smem_bytes) == (tile_kernel, ctas, smem)
    assert p.tile == (binary_mm.DECODE_TILE if m <= binary_mm.DECODE_M
                      else binary_mm.PREFILL_TILE)
    assert p.resident == {} and "binary tensor cores" in p.walk
    assert tile_kernel in _build.LAUNCHES
    assert registered_kernels()[tile_kernel].source.endswith("binary_mm.cu")


@pytest.mark.parametrize("m", [1, 4, 16, 17, 511])
def test_ws_and_is_keep_the_cuda_core_walk(m):
    """Only the basic launch moves to the tiles; the pinned walk values
    stay as they were."""
    for spec, ctas in ((WS, 32), (IS, -(-m // 64))):
        p = binary_mm.plan(spec, m, 192, 2048)
        assert p.tile_kernel is None and p.ctas == ctas
        assert p.smem_bytes == binary_mm.TILE_BYTES + 192 * 68 * 4
    assert binary_mm.BLOCK == (64, 16, 64) and binary_mm.TILE_BYTES == 4352
    assert binary_mm.WALKS == {tdf.OS: 0, tdf.WS: 1, tdf.IS: 2}


# ---------------------------------------------------------------------------
# The tile a launch took, as the kernel reports it.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code", range(len(_build.BINARY_TILES) + 1))
def test_launch_counts_the_binary_tile_the_kernel_reports(monkeypatch, code):
    class Lib:
        @staticmethod
        def binary_mm(*args):
            took, stream = args[-2:]
            took[0], took[1], took[2] = code, 500 + code, 9
            assert args[:-2] == (1, 2) and stream == 0
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    got = _build.launch("binary_mm", 1, 2)
    tile = _build.BINARY_TILES[code - 1] if code else None
    assert got == (None if tile is None else (tile, 500 + code, 9))
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "binary_mm": 1, **({tile: 1} if tile else {})}


@pytest.mark.parametrize("drift", ["tile", "smem", "ctas", "walk"])
def test_a_binary_tile_other_than_the_plan_raises(drift):
    p = binary_mm.plan(OS, 4, 64, 6144)
    matmul_df.check_took(p, (_DEC, 8192, 384))
    took = {"tile": (_PRE, p.smem_bytes, p.ctas),
            "smem": (_DEC, p.smem_bytes + 4, p.ctas),
            "ctas": (_DEC, p.smem_bytes, p.ctas - 1),
            "walk": None}[drift]
    with pytest.raises(_build.KernelError, match="binary_mm took the tile"):
        matmul_df.check_took(p, took)
    matmul_df.check_took(binary_mm.plan(WS, 4, 64, 6144), None)


# ---------------------------------------------------------------------------
# The tiles' arithmetic, lane by lane, in numpy.
# ---------------------------------------------------------------------------
LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def popc(x):
    """Set bits of each uint32 (as uint64) word, SWAR."""
    x = np.asarray(x, np.uint64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).astype(np.int64)


def mma_b1_and(c, a, b):
    """mma.sync m16n8k256 .b1 .and.popc on per-lane fragments (PTX ISA
    layout): a (32, 4) and b (32, 2) words, c (32, 4) int counts."""
    am = np.zeros((16, 8), np.uint64)              # rows x 8 words of k
    am[G, T], am[G + 8, T] = a[:, 0], a[:, 1]
    am[G, 4 + T], am[G + 8, 4 + T] = a[:, 2], a[:, 3]
    bm = np.zeros((8, 8), np.uint64)               # 8 words of k x columns
    bm[T, G], bm[4 + T, G] = b[:, 0], b[:, 1]
    d = popc(am[:, :, None] & bm[None, :, :]).sum(1)   # (16, 8)
    return c + np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T],
                         d[G + 8, 2 * T + 1]], 1)


def ldmatrix_x4(tile, rows, words):
    """ldmatrix.x4 .b16 of a word tile: lane l gives the address of row
    l % 8 of matrix l // 8 (tile[rows[l], words[l]:words[l] + 4]); lane
    4g + t gets word t of row g of each matrix."""
    mats = [np.stack([tile[rows[8 * i + r], words[8 * i + r]:
                           words[8 * i + r] + 4] for r in range(8)])
            for i in range(4)]
    return np.stack([mats[i][G, T] for i in range(4)], 1)


def quad_sum(x):
    """x summed over the 4 lanes of each quad (shfl_xor 1, 2)."""
    return np.repeat(x.reshape(8, 4).sum(1), 4)


def _xor_pops(pa, pb_col, acc):
    """popc(a ^ b) of this lane's four outputs: the quad-summed row
    counts, the column counts of columns 2t and 2t + 1 (shuffled from
    lanes 8t and 8t + 4) and the AND counts."""
    pb0, pb1 = pb_col[8 * T], pb_col[8 * T + 4]
    return np.stack([pa[0] + pb0, pa[0] + pb1, pa[1] + pb0, pa[1] + pb1],
                    1) - 2 * acc


def prefill_tile_pops(a, b):
    """csrc/binary_mm.cu bin_prefill_kernel, lane by lane: (M, N) xor
    counts of words a (M, Kp) and b (Kp, N)."""
    pm, pkw, pn = binary_mm.PREFILL_TILE
    wm, wn = binary_mm.PREFILL_WARPS
    mi_tiles, ni_tiles = pm // wm // 16, pn // wn // 8
    m, kp = a.shape
    n = b.shape[1]
    ap = np.zeros((-(-m // pm) * pm, -(-kp // pkw) * pkw), np.uint64)
    bp = np.zeros((ap.shape[1], -(-n // pn) * pn), np.uint64)
    ap[:m, :kp], bp[:kp, :n] = a, b
    pops = np.zeros(ap.shape[:1] + bp.shape[1:], np.int64)
    for row0 in range(0, ap.shape[0], pm):
        for col0 in range(0, bp.shape[1], pn):
            for warp in range(wm * wn):
                wr, wc = (warp // wn) * (pm // wm), (warp % wn) * (pn // wn)
                acc = np.zeros((mi_tiles, ni_tiles, 32, 4), np.int64)
                pa = np.zeros((mi_tiles, 2, 32), np.int64)
                pb = np.zeros((ni_tiles, 32), np.int64)
                for k0 in range(0, ap.shape[1], pkw):      # ring stages
                    at = ap[row0:row0 + pm, k0:k0 + pkw]
                    bt = bp[k0:k0 + pkw, col0:col0 + pn]
                    for ks in range(pkw // 8):
                        af = [ldmatrix_x4(
                            at, wr + mi * 16 + (LANES & 7)
                            + ((LANES >> 3) & 1) * 8,
                            ks * 8 + (LANES >> 4) * 4)
                            for mi in range(mi_tiles)]
                        bf = [np.stack([bt[ks * 8 + T, wc + ni * 8 + G],
                                        bt[ks * 8 + 4 + T, wc + ni * 8 + G]],
                                       1) for ni in range(ni_tiles)]
                        for mi in range(mi_tiles):
                            for ni in range(ni_tiles):
                                acc[mi, ni] = mma_b1_and(acc[mi, ni],
                                                         af[mi], bf[ni])
                            pa[mi, 0] += popc(af[mi][:, 0]) + popc(af[mi][:, 2])
                            pa[mi, 1] += popc(af[mi][:, 1]) + popc(af[mi][:, 3])
                        for ni in range(ni_tiles):
                            pb[ni] += popc(bf[ni][:, 0]) + popc(bf[ni][:, 1])
                for mi in range(mi_tiles):
                    rows = [quad_sum(pa[mi, 0]), quad_sum(pa[mi, 1])]
                    for ni in range(ni_tiles):
                        got = _xor_pops(rows, quad_sum(pb[ni]), acc[mi, ni])
                        for j in range(4):
                            pops[row0 + wr + mi * 16 + G + (j >> 1) * 8,
                                 col0 + wc + ni * 8 + 2 * T + (j & 1)] = \
                                got[:, j]
    return pops[:m, :n]


def decode_tile_pops(a, b):
    """csrc/binary_mm.cu bin_decode_kernel, lane by lane: M <= 16 rows,
    16 columns a CTA, 8 warps taking k steps w, w + 8, ... from device
    memory, their partial counts summed in shared memory."""
    dm, dkw, dn = binary_mm.DECODE_TILE
    m, kp = a.shape
    n = b.shape[1]
    assert m <= dm
    steps = -(-kp // dkw)
    pops = np.zeros((m, n), np.int64)

    def word(x, r, k, ok):
        rr, kk = np.broadcast_arrays(r, k)
        ok = ok & (rr < x.shape[0]) & (kk < x.shape[1])
        return np.where(ok, x[np.minimum(rr, x.shape[0] - 1),
                              np.minimum(kk, x.shape[1] - 1)], 0)

    for col0 in range(0, n, dn):
        part = np.zeros((binary_mm.DECODE_WARPS, dm, dn), np.int64)
        for warp in range(binary_mm.DECODE_WARPS):
            acc = np.zeros((2, 32, 4), np.int64)
            pa, pb = np.zeros((2, 32), np.int64), np.zeros((2, 32), np.int64)
            for s in range(warp, steps, binary_mm.DECODE_WARPS):
                kw = s * 8 + T
                af = np.stack([word(a, G, kw, True), word(a, G + 8, kw, True),
                               word(a, G, kw + 4, True),
                               word(a, G + 8, kw + 4, True)], 1)
                for ni in range(2):
                    c = col0 + ni * 8 + G
                    bf = np.stack([word(b.T, c, kw, True),
                                   word(b.T, c, kw + 4, True)], 1)
                    acc[ni] = mma_b1_and(acc[ni], af, bf)
                    pb[ni] += popc(bf[:, 0]) + popc(bf[:, 1])
                pa[0] += popc(af[:, 0]) + popc(af[:, 2])
                pa[1] += popc(af[:, 1]) + popc(af[:, 3])
            rows = [quad_sum(pa[0]), quad_sum(pa[1])]
            for ni in range(2):
                got = _xor_pops(rows, quad_sum(pb[ni]), acc[ni])
                for j in range(4):
                    part[warp, G + (j >> 1) * 8, ni * 8 + 2 * T + (j & 1)] = \
                        got[:, j]
        cols = min(dn, n - col0)
        pops[:, col0:col0 + cols] = part.sum(0)[:m, :cols]
    return pops


def _operands(m, kp, n, seed, ragged_bits=0):
    """Random words, and the reduction depth: every bit, or the last
    word's top ``ragged_bits`` bits zero on both sides (a K that is not
    a multiple of 32)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (m, kp), dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, (kp, n), dtype=np.uint64)
    if ragged_bits:
        keep = np.uint64((1 << (32 - ragged_bits)) - 1)
        a[:, -1] &= keep
        b[-1, :] &= keep
    return a, b, 32 * kp - ragged_bits


def _port_dots(a, b, n_bits):
    return ref.binary_matmul_ref(
        torch.from_numpy(a.astype(np.uint32).view(np.int32)),
        torch.from_numpy(b.astype(np.uint32).view(np.int32)), n_bits).numpy()


@pytest.mark.parametrize("shape", [(37, 11, 50), (64, 32, 64), (70, 40, 72)],
                         ids=str)
def test_prefill_tile_model_rebuilds_the_plain_dots(shape):
    m, kp, n = shape
    a, b, n_bits = _operands(m, kp, n, seed=m * kp + n, ragged_bits=7)
    got = n_bits - 2 * prefill_tile_pops(a, b)
    want = _port_dots(a, b, n_bits)
    np.testing.assert_array_equal(got, want)
    jwant = jops.binary_matmul(
        jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)),
        n_bits=n_bits, spec=JSpec.basic(JOS, block=(64, 2, 128)),
        backend="interpret")
    np.testing.assert_array_equal(got, np.asarray(jwant))


@pytest.mark.parametrize("shape", [(4, 64, 40), (1, 5, 50), (16, 27, 24),
                                   (4, 192, 16)], ids=str)
def test_decode_tile_model_rebuilds_the_plain_dots(shape):
    m, kp, n = shape
    a, b, n_bits = _operands(m, kp, n, seed=m + kp * n, ragged_bits=3)
    got = n_bits - 2 * decode_tile_pops(a, b)
    np.testing.assert_array_equal(got, _port_dots(a, b, n_bits))


@pytest.mark.parametrize("seed", range(4))
def test_and_count_gives_the_xor_count_with_zero_padding(seed):
    """popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b) for any words: so
    with zero words past Kp (and zero bits past a ragged n_bits) on both
    sides the AND form's count equals the xor form's exactly."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (64, 9), dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, (64, 9), dtype=np.uint64)
    a[:, 7:] = 0                       # zero padding words
    b[:, 7:] = 0
    keep = np.uint64((1 << 19) - 1)    # n_bits = 6 * 32 + 19
    a[:, 6] &= keep
    b[:, 6] &= keep
    xor = popc(a ^ b).sum(1)
    via_and = popc(a).sum(1) + popc(b).sum(1) - 2 * popc(a & b).sum(1)
    np.testing.assert_array_equal(xor, via_and)
    n_bits = 6 * 32 + 19
    dots = n_bits - 2 * via_and
    pm = lambda w: np.where(((w[:, :7, None] >> np.arange(32, dtype=np.uint64))
                             & 1).reshape(64, -1)[:, :n_bits] == 1, 1, -1)
    np.testing.assert_array_equal(dots, (pm(a) * pm(b)).sum(1))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binary tensor-core tiles run "
                    "only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("proj", ["up", "down"])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 511])
def test_binary_tiles_equal_every_anchor_on_the_card(card, proj, m):
    """The basic launch's tile (decode at M <= 16, prefill above) and
    the WS/IS walks equal the plain version bit for bit at the served
    projections of qwen3-1.7b's binary MLP (up: 64 words -> 6144, scale
    + bias + sign -> int8; down: 192 words -> 2048, scale + bias -> f32)
    and on the raw int32 dots."""
    from repro_torch.core.dataflow import BinaryEpilogue

    kp, n = (64, 6144) if proj == "up" else (192, 2048)
    k = 32 * kp
    gen = torch.Generator(device=card).manual_seed(m * 7 + kp)
    a = ref.pack_binary(torch.randn((m, k), generator=gen, device=card), 1)
    b = ref.pack_binary(torch.randn((k, n), generator=gen, device=card), 0)
    scale = (torch.rand((1, n), generator=gen, device=card) + 0.5) * k ** -0.5
    bias = torch.randn((1, n), generator=gen, device=card)
    binarize = proj == "up"
    epi = BinaryEpilogue(scale=True, bias=True, binarize=binarize)
    want = ref.binary_matmul_fused_ref(a, b, k, scale=scale, bias=bias,
                                       binarize=binarize)
    raw = ref.binary_matmul_ref(a, b, k)
    tile = binary_mm.plan(OS, m, kp, n).tile_kernel
    before = _build.LAUNCHES[tile]
    for spec in (OS, WS, IS):
        got = binary_mm.binary_mm_df(a, b, k, spec, epilogue=epi,
                                     scale=scale, bias=bias)
        assert got.dtype == want.dtype and torch.equal(got, want), spec.name
        assert torch.equal(binary_mm.binary_mm_df(a, b, k, spec), raw)
    assert _build.LAUNCHES[tile] == before + 2
