"""B4's walks, B5a and B1's residencies on thread-block clusters
(``csrc/gemm_cluster.cuh``): what the CPU can hold, and the card-only
checks.

On the CPU: ``matmul_df.plan`` gives every bf16 resident walk over a sweep
of two tiles or more its cluster walk (the launch key, the cluster size,
the CTAs, one CTA's launched shared memory), pinned below at the timed
shapes and the paper's layers; a sweep of one tile, and every float32,
int8 and packed operand, keeps the one-CTA walk; which specs are feasible
at which shape, and the messages of those that are not, are exactly the
planner's before the cluster walks (the table was generated from it); the
tile assignment gives every tile, and every resident slot and chunk
vector, to exactly one CTA of its cluster; ``check_took`` raises where a
launch's report drifts from its plan; and the new keys are registered.

On the card (marker ``card``, skipped here): every cluster walk equals B1
bit for bit at ragged shapes with every epilogue stage, each counted under
its cluster key, and a sweep of one tile still takes the one-CTA walk.  The
card's machine has no JAX; this module imports none, so it runs there
without the repo's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q -m card \
        tests/test_torch_cluster.py
"""
import hashlib

import pytest
import torch

from repro_torch.bench import common
from repro_torch.core.dataflow import (DataflowSpec, Residency, IS, OS, WS,
                                       registered_kernels)
from repro_torch.kernels import _build, matmul_df, ref

NINE = common.NINE_SPECS
# An OS spec with the whole weight and no input stripe: the one cluster
# walk the nine do not reach (B1's WALK_N without A's stripe).
OS_W_WHOLE = DataflowSpec(OS, {WS: Residency.WHOLE}, (WS,), matmul_df.BLOCK)

# (spec, M, K, N) -> (tile kernel, cluster, CTAs, one CTA's shared memory)
# for bf16 operands: the timed shapes (B4 at the paper's (56,3,1,128), B5a
# at qwen3-1.7b's down projection) and every feasible cluster walk at the
# paper's layers and qwen3-1.7b's prefill MLP shapes.
CLUSTER_PLANS = {
    ("os_w_stripe", 2916, 1152, 128): ("matmul_os_cluster", 16, 32, 213376),
    ("ws_basic", 2916, 1152, 128): ("matmul_rmw_cluster", 16, 32, 213376),
    ("is_basic", 2916, 1152, 128): ("matmul_rmw_cluster", 2, 92, 213376),
    ("os_w_stripe", 2916, 1152, 256): ("matmul_os_cluster", 16, 64, 213376),
    ("ws_basic", 2916, 1152, 256): ("matmul_rmw_cluster", 16, 64, 213376),
    ("is_basic", 2916, 1152, 256): ("matmul_rmw_cluster", 4, 184, 213376),
    ("os_w_stripe", 2916, 1152, 512): ("matmul_os_cluster", 16, 128, 213376),
    ("ws_basic", 2916, 1152, 512): ("matmul_rmw_cluster", 16, 128, 213376),
    ("is_basic", 2916, 1152, 512): ("matmul_rmw_cluster", 4, 184, 213376),
    ("os_w_stripe", 12100, 1152, 128): ("matmul_os_cluster", 16, 32, 213376),
    ("ws_basic", 12100, 1152, 128): ("matmul_rmw_cluster", 16, 32, 213376),
    ("is_basic", 12100, 1152, 128): ("matmul_rmw_cluster", 2, 380, 213376),
    ("os_w_stripe", 12100, 1152, 256): ("matmul_os_cluster", 16, 64, 213376),
    ("ws_basic", 12100, 1152, 256): ("matmul_rmw_cluster", 16, 64, 213376),
    ("is_basic", 12100, 1152, 256): ("matmul_rmw_cluster", 2, 380, 213376),
    ("os_w_stripe", 729, 1152, 128): ("matmul_os_cluster", 8, 16, 213376),
    ("ws_basic", 729, 1152, 128): ("matmul_rmw_cluster", 8, 16, 213376),
    ("ws_o_stripe", 729, 1152, 128): ("matmul_ws_stripe_cluster", 8, 16,
                                      98432),
    ("is_basic", 729, 1152, 128): ("matmul_rmw_cluster", 2, 24, 213376),
    ("ws_o_stripe", 729, 2048, 256): ("matmul_ws_stripe_cluster", 8, 32,
                                      98432),
    ("os_w_stripe", 3025, 1152, 128): ("matmul_os_cluster", 16, 32, 213376),
    ("ws_basic", 3025, 1152, 128): ("matmul_rmw_cluster", 16, 32, 213376),
    ("is_basic", 3025, 1152, 128): ("matmul_rmw_cluster", 2, 96, 213376),
    ("ws_o_stripe", 137, 2048, 6144): ("matmul_ws_stripe_cluster", 2, 192,
                                       98432),
    ("ws_o_stripe", 512, 2048, 6144): ("matmul_ws_stripe_cluster", 4, 384,
                                       98432),
    ("ws_o_stripe", 137, 6144, 2048): ("matmul_ws_stripe_cluster", 2, 64,
                                       98432),
    ("ws_o_stripe", 512, 6144, 2048): ("matmul_ws_stripe_cluster", 8, 256,
                                       65664),
}
_LIBRARY = {"matmul_os_cluster": "matmul_os",
            "matmul_rmw_cluster": "matmul_rmw",
            "matmul_ws_stripe_cluster": "matmul_ws_stripe"}


@pytest.mark.parametrize("case", sorted(CLUSTER_PLANS), ids=str)
def test_cluster_plans_are_pinned(case):
    name, m, k, n = case
    tile_kernel, cluster, ctas, smem = CLUSTER_PLANS[case]
    p = matmul_df.plan(NINE[name], m, k, n, torch.bfloat16)
    assert (p.tile_kernel, p.cluster, p.ctas, p.smem_bytes) == \
        (tile_kernel, cluster, ctas, smem)
    assert p.kernel == _LIBRARY[tile_kernel]
    gm, gn = -(-m // 64), -(-n // 64)
    # one cluster per anchored stripe: column stripes for WS (and B1's
    # weight stripe), row stripes for IS
    anchors = gm if name.startswith("is") else gn
    assert p.ctas == anchors * cluster
    assert p.smem_bytes <= matmul_df.MAX_SMEM and cluster in (2, 4, 8, 16)
    kp = -(-k // 32) * 32
    if name == "ws_o_stripe":
        # 4 chunks of 2 k steps of B and of the busiest CTA's A tiles, and
        # 8 mbarriers (a 128-byte line)
        assert smem == 4 * 2 * 4096 * (1 + -(-gm // cluster)) + 128
        assert -(-gm // cluster) <= matmul_df.STRIPE_TILES
    else:
        # the stripe (kp x 64 bf16), a ring of 16 k steps, 33 mbarriers
        assert smem == kp * 128 + 16 * 4096 + 384


@pytest.mark.parametrize("name", ["ws_basic", "ws_i_stripe", "is_basic",
                                  "is_b_whole", "ws_o_stripe",
                                  "os_w_stripe", "os_w_whole_i_stripe"])
def test_a_sweep_of_one_tile_keeps_the_one_cta_walk(name):
    """37 x 64 x 48 is one tile: nothing to split."""
    p = matmul_df.plan(NINE[name], 37, 64, 48, torch.bfloat16)
    assert p.tile_kernel is None and p.cluster is None and p.ctas == 1
    # one row tile (WS) or one column tile (IS) at a larger other side
    m, n = (40, 1000) if name.startswith(("ws", "os_w_stripe")) \
        else (1000, 40)
    try:
        p = matmul_df.plan(NINE[name], m, 64, n, torch.bfloat16)
    except ValueError:
        return
    assert p.tile_kernel is None and p.cluster is None, name


KINDS = {"bfloat16": (torch.bfloat16, None), "float32": (torch.float32, None),
         "int8": (torch.int8, None), "packed4": (torch.int8, 4),
         "packed5": (torch.int8, 5)}
SHAPES = [(g.m, g.k, g.n) for g in map(common.paper_gemm,
                                       common.PAPER_LAYERS)] + \
    list(common.QWEN_MLP)
# spec -> kind -> one 1/0 per SHAPES entry: feasible or not, from the
# planner before the cluster walks; and the sha256 of its refusal messages
# in this order (spec, kind, shape).
FEASIBLE = {
    "os_basic": {"bfloat16": "111111111111111111", "float32": "111111111111111111", "int8": "111111111111111111", "packed4": "111111111111111111", "packed5": "111111111111111111"},
    "os_w_stripe": {"bfloat16": "111001101010000000", "float32": "000000000000000000", "int8": "111111111111101010", "packed4": "111111111111111111", "packed5": "111111111111101010"},
    "os_w_whole_i_stripe": {"bfloat16": "000000000000000000", "float32": "000000000000000000", "int8": "100001001010000000", "packed4": "110001101010000000", "packed5": "100001001010000000"},
    "ws_basic": {"bfloat16": "111001101010000000", "float32": "000000000000000000", "int8": "111111111111101010", "packed4": "111111111111111111", "packed5": "111111111111101010"},
    "ws_o_stripe": {"bfloat16": "000000001100111111", "float32": "000000001100111111", "int8": "000000001100111111", "packed4": "000000001100111111", "packed5": "000000001100111111"},
    "ws_i_stripe": {"bfloat16": "000000000000000000", "float32": "000000000000000000", "int8": "111001101010100000", "packed4": "111101111110111010", "packed5": "111101111110101010"},
    "is_basic": {"bfloat16": "111001101010110000", "float32": "000000000000110000", "int8": "111111111111111010", "packed4": "111111111111111010", "packed5": "111111111111111010"},
    "is_o_stripe": {"bfloat16": "111111111111110000", "float32": "111111111111110000", "int8": "111111111111110000", "packed4": "111111111111110000", "packed5": "111111111111110000"},
    "is_b_whole": {"bfloat16": "000000000000000000", "float32": "000000000000000000", "int8": "100001001010000000", "packed4": "110001101010000000", "packed5": "100001001010000000"},
}
REFUSALS_SHA256 = \
    "e1904dcd3ee20c932e9718c373e533f4c7d34de9d5478fe797f30be216f226cc"


def test_feasibility_is_the_planners_before_the_cluster_walks():
    digest = hashlib.sha256()
    for name, spec in NINE.items():
        for kind, (dtype, bits) in KINDS.items():
            got = ""
            for m, k, n in SHAPES:
                try:
                    p = matmul_df.plan(spec, m, k, n, dtype, bits)
                except ValueError as err:
                    got += "0"
                    digest.update(str(err).encode())
                    continue
                got += "1"
                # only bf16 walks take a cluster
                assert p.cluster is None or dtype == torch.bfloat16, \
                    (name, kind)
            assert got == FEASIBLE[name][kind], (name, kind)
    assert digest.hexdigest() == REFUSALS_SHA256


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_every_tile_belongs_to_exactly_one_cta(cluster):
    """CTA r of a cluster walks tiles r, r + C, ... (and fetches resident
    slots r, r + C, ...), for every sweep, shorter than the cluster or not a
    multiple of it."""
    for g in range(1, 50):
        owned = [t for r in range(cluster)
                 for t in matmul_df.cluster_tiles(g, cluster, r)]
        assert sorted(owned) == list(range(g)), (g, cluster)
        counts = [len(matmul_df.cluster_tiles(g, cluster, r))
                  for r in range(cluster)]
        assert max(counts) - min(counts) <= 1 and max(counts) == -(-g // cluster)
    # B5a's weight chunk: STRIPE_KC 32-row k steps of 16-byte vectors, CTA
    # v // (vectors / C) fetching v: whole 128-byte (swizzled) rows each
    vectors = matmul_df.STRIPE_KC * 4096 // 16
    per = vectors // cluster
    owners = [v // per for v in range(vectors)]
    assert sorted(set(owners)) == list(range(cluster))
    assert all(owners.count(r) == per for r in range(cluster))
    assert per % 8 == 0


def test_the_cluster_size_rule():
    for anchors in (1, 2, 3, 16, 32, 46, 96, 200):
        for g in range(2, 60):
            c = matmul_df.cluster_size(anchors, g)
            assert c in (2, 4, 8, 16) and c <= g
            # doubled only while the card has SMs left and tiles to give
            assert c == 2 or anchors * c // 2 < matmul_df.CARD_SMS
            assert c == 16 or 2 * c > g or anchors * c >= matmul_df.CARD_SMS
            # B5a: no CTA owns more row tiles than its registers hold
            if g <= 14:
                lo = 1 << (-(-g // matmul_df.STRIPE_TILES) - 1).bit_length()
                c5 = matmul_df.cluster_size(anchors, g, lo)
                assert -(-g // c5) <= matmul_df.STRIPE_TILES and c5 <= g


@pytest.mark.parametrize("name", ["ws_basic", "ws_i_stripe", "is_basic",
                                  "is_b_whole", "ws_o_stripe", "os_w_stripe",
                                  "os_w_whole_i_stripe"])
def test_every_feasible_cluster_walk_fits_a_block(name):
    """A cluster walk keeps the one-CTA walk's resident bytes and sizes its
    ring (and its mbarriers) to what is left, so whatever the plan finds
    feasible launches: it refuses no more shapes than before.  Odd M (a
    resident A stripe of fewer than 64 rows), odd K and N, up to the
    largest stripes that fit."""
    spec = NINE[name]
    walks = 0
    for m in (36, 37, 60, 65, 137, 729, 840, 2916):
        for k in range(8, 3600, 88):
            for n in (40, 72, 130, 256, 700, 2048):
                try:
                    p = matmul_df.plan(spec, m, k, n, torch.bfloat16)
                except ValueError:
                    continue
                assert p.smem_bytes <= matmul_df.MAX_SMEM, (m, k, n)
                walks += p.cluster is not None
    assert walks > 50


def test_every_feasible_ws_stripe_cluster_is_at_most_eight():
    """B5a's cluster kernel refuses a cluster of more than 8 (a CTA's part
    of a weight chunk, 64 / C rows, must be whole 1024-byte swizzle rows
    for the TMA): no stripe one CTA could hold needs more."""
    sizes = set()
    for m in range(65, 1100, 7):
        for n in (64, 2048):
            try:
                p = matmul_df.plan(NINE["ws_o_stripe"], m, 1152, n)
            except ValueError:
                continue
            sizes.add(p.cluster)
    assert max(sizes) == 8 and sizes >= {2, 4, 8}


def test_other_types_keep_the_one_cta_walk():
    for name in ("ws_basic", "is_basic", "os_w_stripe", "ws_o_stripe"):
        for dtype, bits in ((torch.float32, None), (torch.int8, None),
                            (torch.int8, 4), (torch.int8, 5)):
            try:
                p = matmul_df.plan(NINE[name], 729, 1152, 128, dtype, bits)
            except ValueError:
                continue
            assert p.tile_kernel is None and p.cluster is None, name


def test_check_took_holds_the_cluster_report_against_the_plan():
    p = matmul_df.plan(NINE["ws_basic"], 2916, 1152, 128)
    took = (p.tile_kernel, p.smem_bytes, p.ctas, p.cluster)
    matmul_df.check_took(p, took)
    drifts = {"tile": ("matmul_os_cluster",) + took[1:],
              "bytes": (took[0], took[1] + 4096) + took[2:],
              "ctas": took[:2] + (took[2] * 2, took[3]),
              "cluster": took[:3] + (8,),
              "no cluster": took[:3],
              "one-CTA walk": None}
    for what, bad in drifts.items():
        with pytest.raises(_build.KernelError, match="plan says"):
            matmul_df.check_took(p, bad)
    one = matmul_df.plan(NINE["ws_basic"], 37, 64, 48)
    matmul_df.check_took(one, None)
    with pytest.raises(_build.KernelError):
        matmul_df.check_took(one, took)


def test_cluster_keys_are_registered():
    regs = registered_kernels()
    for key, library in _LIBRARY.items():
        assert regs[key].source.endswith("csrc/gemm_cluster.cuh")
        assert key in _build.LAUNCHES and key in _build.TILE_LIBRARIES[library]
        assert regs[key].replaces == regs[library].replaces
    assert "gemm_cluster.cuh" in _build.HEADERS


@pytest.mark.parametrize("library", sorted(set(_LIBRARY.values())))
def test_launch_counts_the_cluster_walk_the_kernel_reports(monkeypatch,
                                                           library):
    """``_build.launch`` counts the cluster walk from the entry point's
    report and returns its cluster size after the CTAs."""
    code = 1 + _build.TILE_LIBRARIES[library].index(
        next(k for k, v in _LIBRARY.items() if v == library))

    class Lib:
        pass

    def entry(*args):
        took, stream = args[-2:]
        took[0], took[1], took[2], took[3] = code, 163840, 32, 16
        return 0

    setattr(Lib, library, staticmethod(entry))
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    tile = _build.TILE_LIBRARIES[library][code - 1]
    assert _build.launch(library, 1, 2) == (tile, 163840, 32, 16)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {library: 1, tile: 1}


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cluster walks run only there")
    return torch.device("cuda")


# Every spec whose walk may take a cluster: the nine's, B1's input stripe
# and B1's whole weight without it.
SPECS = {name: NINE[name] for name in (
    "ws_basic", "ws_i_stripe", "is_basic", "is_b_whole", "ws_o_stripe",
    "os_w_stripe", "os_w_whole_i_stripe")}
SPECS["os_i_stripe"] = DataflowSpec(OS, {IS: Residency.STRIPE}, (IS,),
                                    matmul_df.BLOCK)
SPECS["os_w_whole"] = OS_W_WHOLE


@pytest.mark.card
@pytest.mark.parametrize("m", [65, 137, 200])
@pytest.mark.parametrize("k,n", [(200, 72), (100, 130)])
def test_cluster_walks_equal_b1_on_the_card(card, m, k, n):
    """Every cluster walk equals B1's basic launch bit for bit, with a
    per-column scale, bias, gelu and residual to f32, and a per-row scale
    to bf16; each counted once under its cluster key.  K = 200, N = 72
    take 16-byte loads, K = 100, N = 130 element loads; K is no multiple
    of 32 and N none of 64."""
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
    ran = set()
    for epi in epis:
        base = matmul_df.matmul_os(a, b, **epi)
        want = ref.matmul_fused_ref(a, b, **epi)
        assert (base.float() - want.float()).abs().max() < 0.1
        for name, spec in SPECS.items():
            try:
                p = matmul_df.plan(spec, m, k, n)
            except ValueError:
                continue
            if p.tile_kernel is None:
                continue
            before = (_build.LAUNCHES[p.kernel], _build.LAUNCHES[p.tile_kernel])
            got = matmul_df.matmul_df(a, b, spec, **epi)
            assert (_build.LAUNCHES[p.kernel], _build.LAUNCHES[p.tile_kernel]) \
                == (before[0] + 1, before[1] + 1), name
            assert torch.equal(got, base), (name, (got.float() - base.float())
                                             .abs().max())
            ran.add(name)
    assert {"ws_basic", "is_basic", "ws_o_stripe", "os_w_stripe"} <= ran


@pytest.mark.card
def test_sixteen_ctas_a_cluster_on_the_card(card):
    """A WS sweep of 33 row tiles under one column stripe takes clusters of
    16 (the non-portable size), and B5a's stripe of 12 row tiles clusters
    of 8; both equal B1 bit for bit."""
    gen = torch.Generator(device=card).manual_seed(16)
    for name, (m, k, n), cluster in (("ws_basic", (2100, 96, 40), 16),
                                     ("ws_o_stripe", (729, 1152, 128), 8)):
        a = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device=card)
             * k ** -0.5).to(torch.bfloat16)
        p = matmul_df.plan(NINE[name], m, k, n)
        assert p.cluster == cluster
        assert torch.equal(matmul_df.matmul_df(a, b, NINE[name]),
                           matmul_df.matmul_os(a, b))


@pytest.mark.card
@pytest.mark.parametrize("name", ["is_basic", "os_i_stripe"])
def test_a_short_row_stripe_on_the_card(card, name):
    """A resident A stripe of fewer than 64 rows (M = 37) with 16-byte rows
    (K, N multiples of 8) over three column tiles: the walk of 16-byte
    ``cp.async`` copies exchanged over distributed shared memory, equal to
    B1 bit for bit."""
    m, k, n = 37, 200, 136
    gen = torch.Generator(device=card).manual_seed(37)
    a = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=card)
         * k ** -0.5).to(torch.bfloat16)
    p = matmul_df.plan(SPECS[name], m, k, n)
    assert p.tile_kernel in _LIBRARY and p.cluster == 2
    for epi in (dict(out_dtype=torch.float32),
                dict(bias=torch.randn((1, n), generator=gen, device=card),
                     activation="gelu", out_dtype=torch.bfloat16)):
        before = _build.LAUNCHES[p.tile_kernel]
        got = matmul_df.matmul_df(a, b, SPECS[name], **epi)
        assert _build.LAUNCHES[p.tile_kernel] == before + 1
        assert torch.equal(got, matmul_df.matmul_os(a, b, **epi))


@pytest.mark.card
def test_a_sweep_of_one_tile_takes_the_one_cta_walk_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(1)
    a = torch.randn((37, 300), generator=gen, device=card).to(torch.bfloat16)
    b = torch.randn((300, 48), generator=gen, device=card).to(torch.bfloat16)
    for name in ("ws_basic", "is_basic", "ws_o_stripe"):
        p = matmul_df.plan(NINE[name], 37, 300, 48)
        assert p.tile_kernel is None
        tiles = {k: _build.LAUNCHES[k] for k in _LIBRARY}
        before = _build.LAUNCHES[p.kernel]
        got = matmul_df.matmul_df(a, b, NINE[name])
        assert _build.LAUNCHES[p.kernel] == before + 1
        assert {k: _build.LAUNCHES[k] for k in _LIBRARY} == tiles
        assert torch.equal(got, matmul_df.matmul_os(a, b))
