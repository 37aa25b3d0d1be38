"""B3, paged decode attention, split across CTAs (``csrc/paged_attention.cu``):
what the CPU can hold, and the card-only checks.

On the CPU: the chunk plan (``attention_df.paged_chunks``: key ranges of
``PAGED_CHUNK_TILES`` tiles) covers each row's visited keys exactly once,
at pages of 32 keys or fewer on whole pages lo..hi, with and without a
window, and is a function of the row alone; a plain PyTorch model of the
kernel's split (tiles of ``paged_tile_keys(page)`` keys, each mapped to
its page and offset, folded online within a chunk, each chunk's partial
(m, l, acc), merged in chunk order) matches ``ref.paged_attention_ref``
and the JAX package's ``paged_attention`` in interpret mode, float32,
atol 1e-5 and rtol 1e-5 (the tolerance of ``test_torch_kernels.py``'s
paged test: the sides differ only in the order of float32 sums); and
the plain version against the JAX kernel at pages of 48, 64 and 128 keys
(the reference's ``bkv == page``), groups 1, 2 and 8, with and without a
window, at the same tolerance.

On the card (marker ``card``, skipped here): the kernel against its plain
version at ragged lengths and a long row, pages of 5 to 128 keys:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \\
        tests/test_torch_paged_split.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, attention_df, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30


@pytest.mark.parametrize("window", [None, 1, 7, 100, 600])
@pytest.mark.parametrize("page", [1, 5, 16, 32, 48, 64, 128])
def test_chunk_plan_covers_the_visited_pages_once(page, window):
    max_pages = -(-4096 // page) + 3
    ck = attention_df.paged_chunk_keys(page)
    tk = (32 // page * page) if page < 32 else 32
    assert attention_df.paged_tile_keys(page) == tk
    assert ck == attention_df.PAGED_CHUNK_TILES * tk
    for kv in (0, 1, page - 1, page, page + 1, 527, 4096):
        chunks = attention_df.paged_chunks(kv, page, max_pages, window)
        if kv == 0:
            assert chunks == []
            continue
        hi = -(-kv // page) - 1
        lo = 0 if window is None else max(0, (kv - window) // page)
        first = max(0, kv - window) if window else 0
        # every key from the window's first one to the last, once, in
        # runs of ck (the first may start up to 31 keys before the window)
        keys = [k for c_lo, c_hi in chunks for k in range(c_lo, c_hi)]
        assert keys == list(range(chunks[0][0], kv)), (kv, chunks)
        assert lo * page <= chunks[0][0] <= first < chunks[0][0] + 32
        assert all(c_hi - c_lo == ck for c_lo, c_hi in chunks[:-1])
        assert len(chunks) <= attention_df.paged_max_chunks(page, max_pages)
        if page <= 32:
            # whole pages lo..hi, each in one chunk
            pages = [p for c_lo, c_hi in chunks
                     for p in range(c_lo // page, (c_hi - 1) // page + 1)]
            assert pages == list(range(lo, hi + 1)), (kv, chunks)
            assert all(c_lo % page == 0 for c_lo, _ in chunks)


def test_chunk_plan_depends_only_on_the_row():
    """A row's chunks are the same whatever the other rows, the batch
    size or the table's width (it caps hi only past a full table)."""
    for page in (16, 64):
        for kv in (1, 17, 200, 527, 4096):
            for window in (None, 100):
                alone = attention_df.paged_chunks(kv, page, 256, window)
                assert alone == attention_df.paged_chunks(kv, page, 1000,
                                                          window)
    assert attention_df.paged_chunks(600, 16, 10) == [(0, 128), (128, 160)]
    assert attention_df.paged_chunks(600, 64, 2) == [(0, 128)]
    assert attention_df.paged_chunks(300, 48, 20, 100) == [(192, 300)]
    assert attention_df.paged_max_chunks(16, 64) == 8
    assert attention_df.paged_max_chunks(16, 256) == 32
    assert attention_df.paged_max_chunks(128, 32) == 32
    assert attention_df.paged_max_chunks(48, 3) == 2


# ---------------------------------------------------------------------------
# A plain model of the split.
# ---------------------------------------------------------------------------
def split_model(q, k_pages, v_pages, tables, kv_lens, window=None,
                scale=None):
    """csrc/paged_attention.cu's arithmetic in plain PyTorch: per (row,
    q head) and chunk, tiles of ``paged_tile_keys(page)`` keys (each key
    at page kpos // page, offset kpos % page) folded into a running (m,
    l, acc), masked keys exactly 0; the chunks' partials merged in chunk
    order; l == 0 writes zeros."""
    b, hq, _, d = q.shape
    hkv, n_pages, page, _ = k_pages.shape
    max_pages = tables.shape[1]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    tk = attention_df.paged_tile_keys(page)
    out = torch.zeros_like(q)
    for r in range(b):
        kv = int(kv_lens[r])
        chunks = attention_df.paged_chunks(kv, page, max_pages, window)
        for h in range(hq):
            qh = q[r, h, 0]
            parts = []
            for c_lo, c_end in chunks:
                m, l, acc = torch.tensor(NEG_INF), torch.tensor(0.0), \
                    torch.zeros(d)
                for t0 in range(c_lo, c_end, tk):
                    kpos = torch.arange(t0, min(c_end, t0 + tk))
                    pid = tables[r, kpos // page].long()
                    ok = (pid >= 0) & (pid < n_pages)
                    if window:
                        ok &= kpos > kv - 1 - window
                    at = (h // group, pid.clamp(0, n_pages - 1), kpos % page)
                    kt = torch.where(ok[:, None], k_pages[at], 0.0)
                    vt = torch.where(ok[:, None], v_pages[at], 0.0)
                    s = torch.where(ok, (kt @ qh) * scale,
                                    torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max())
                    p = torch.where(ok, torch.exp(s - m_new), 0.0)
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum()
                    acc = acc * alpha + p @ vt
                    m = m_new
                parts.append((m, l, acc))
            if len(parts) == 1:
                m, l, acc = parts[0]
                out[r, h, 0] = acc / l if l > 0 else 0.0
            elif parts:
                mx = torch.stack([p[0] for p in parts]).max()
                l, a = torch.tensor(0.0), torch.zeros(d)
                for m_c, l_c, acc_c in parts:
                    w = torch.exp(m_c - mx)
                    l, a = l + w * l_c, a + w * acc_c
                out[r, h, 0] = a / l if l > 0 else 0.0
    return out


def _paged_inputs(seed, b, hq, hkv, d, page, max_pages, kv_lens):
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 1
    k = rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
    v = rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
    tables = rng.permutation(n_pages - 1)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    return q, k, v, tables, np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("window", [None, 10, 45])
@pytest.mark.parametrize("case", [
    (4, 4, 2, 32, 8, 5, [0, 7, 21, 40]),
    (3, 8, 2, 32, 4, 40, [150, 1, 97]),
    (2, 2, 1, 64, 16, 20, [300, 33]),
    (2, 6, 2, 32, 5, 30, [149, 71]),
    (3, 4, 4, 16, 48, 8, [300, 47, 130]),
    (2, 8, 1, 32, 128, 4, [400, 129]),
], ids=["page8", "page4_long", "page16", "page5", "page48", "page128"])
def test_split_model_matches_the_plain_version_and_jax(case, window):
    b, hq, hkv, d, page, max_pages, lens = case
    arrays = _paged_inputs(sum(lens) + d, b, hq, hkv, d, page, max_pages,
                           lens)
    q, k, v, tables, kv_lens = (torch.from_numpy(a) for a in arrays)
    got = split_model(q, k, v, tables, kv_lens, window=window)
    want = ref.paged_attention_ref(q, k, v, tables, kv_lens, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jwant = jops.paged_attention(*(jnp.asarray(a) for a in arrays),
                                 window=window, backend="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)
    # the port's entry point on CPU tensors is the plain version
    np.testing.assert_array_equal(
        ops.paged_attention(q, k, v, tables, kv_lens, window=window).numpy(),
        want.numpy())
    for r, kv in enumerate(lens):
        if kv == 0:
            assert np.all(got[r].numpy() == 0.0)
    # a row alone: the same bits as in the batch
    alone = split_model(q[1:2], k, v, tables[1:2], kv_lens[1:2],
                        window=window)
    np.testing.assert_array_equal(alone.numpy(), got[1:2].numpy())


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("page", [48, 64, 128])
def test_plain_version_matches_jax_at_pages_over_32_keys(page, group,
                                                         window):
    """The reference's paged kernel takes any page (``bkv == page``):
    ``ref.paged_attention_ref`` (what the port's wrapper computes on CPU
    tensors, and the card's kernel is held to) against it in interpret
    mode, rows of 0 keys to several pages."""
    lens = [0, 17, page + 3, 3 * page - 1]
    max_pages = 4
    arrays = _paged_inputs(page + group, len(lens), 2 * group, 2, 16, page,
                           max_pages, lens)
    q, k, v, tables, kv_lens = (torch.from_numpy(a) for a in arrays)
    got = ops.paged_attention(q, k, v, tables, kv_lens, window=window)
    np.testing.assert_array_equal(
        got.numpy(), ref.paged_attention_ref(q, k, v, tables, kv_lens,
                                             window=window).numpy())
    jwant = jops.paged_attention(*(jnp.asarray(a) for a in arrays),
                                 window=window, backend="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)
    assert np.all(got[0].numpy() == 0.0)


def test_split_model_masks_a_page_outside_the_pool():
    q, k, v, tables, kv_lens = (torch.from_numpy(a) for a in _paged_inputs(
        5, 2, 4, 2, 32, 8, 12, [90, 60]))
    tables[0, 3] = k.shape[1] + 7      # out of the pool: fully masked
    got = split_model(q, k, v, tables, kv_lens)
    keep = torch.ones(12 * 8, dtype=torch.bool)
    keep[24:32] = False
    hkv, _, page, d = k.shape
    kg = k[:, tables[0].clamp(max=k.shape[1] - 1).long()].reshape(hkv, -1, d)
    vg = v[:, tables[0].clamp(max=k.shape[1] - 1).long()].reshape(hkv, -1, d)
    for h in range(4):
        s = (kg[h // 2, :90] @ q[0, h, 0]) * d ** -0.5
        s = torch.where(keep[:90], s, torch.tensor(-float("inf")))
        want = torch.softmax(s, 0) @ vg[h // 2, :90]
        np.testing.assert_allclose(got[0, h, 0].numpy(), want.numpy(), **TOL)


def test_arrival_counters_are_kept_per_device_and_stream():
    """The zeroed counters the row's last CTA is found by: one buffer per
    (device, stream), reused while it is large enough, grown (zeroed) when
    not, so launches on two streams never share a counter."""
    cpu = torch.device("cpu")
    first = attention_df._paged_counters(cpu, 11, 32)
    assert first.dtype == torch.int32 and bool((first == 0).all())
    assert attention_df._paged_counters(cpu, 11, 8) is first
    other = attention_df._paged_counters(cpu, 12, 32)
    assert other is not first
    grown = attention_df._paged_counters(cpu, 11, first.numel() + 1)
    assert grown.numel() > first.numel() and bool((grown == 0).all())
    assert attention_df._paged_counters(cpu, 12, 8) is other
    for stream in (11, 12):
        del attention_df._PAGED_COUNTERS[(cpu, stream)]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split paged kernel runs only "
                    "there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("case", [
    (16, 8, 128, 16, [0, 17, 200, 527]),
    (16, 8, 128, 16, [4096, 4096, 4095, 1]),
    (4, 4, 64, 8, [1, 8, 9, 300]),
    (8, 1, 32, 32, [33, 1000, 0, 64]),
    (6, 2, 64, 5, [7, 161, 42, 500]),
    (6, 6, 16, 16, [5, 17, 200, 0]),
    (8, 2, 16, 8, [1, 300, 33, 64]),
    (64, 4, 128, 16, [0, 17, 200, 527]),
    (12, 1, 64, 8, [5, 300, 0, 33]),
    (16, 8, 128, 48, [0, 17, 200, 527]),
    (16, 8, 128, 64, [4096, 4096, 4095, 1]),
    (16, 2, 64, 128, [0, 17, 200, 527]),
    (16, 16, 16, 128, [129, 1, 600, 255]),
], ids=["served", "long", "page8", "group8", "page5", "d16_mha", "d16",
        "group16", "group12", "page48", "page64_long", "page128_group8",
        "page128_d16"])
def test_split_kernel_matches_the_plain_version_on_the_card(
        card, case, window, dtype):
    """Within B2's tolerances (bf16: atol 4e-3, rtol 8e-3; float32: 1e-4;
    chip_smoke.py's att_tol and f32_tol), every row of 0 keys all zeros."""
    hq, hkv, d, page, lens = case
    dt = getattr(torch, dtype)
    rows, max_pages = len(lens), -(-max(lens) // page) + 2
    gen = torch.Generator(device=card).manual_seed(sum(lens) + d)
    n_pages = rows * max_pages
    kp = torch.randn((hkv, n_pages, page, d), generator=gen,
                     device=card).to(dt)
    vp = torch.randn((hkv, n_pages, page, d), generator=gen,
                     device=card).to(dt)
    tables = torch.randperm(n_pages, generator=gen, device=card).reshape(
        rows, max_pages).to(torch.int32)
    q = torch.randn((rows, hq, 1, d), generator=gen, device=card).to(dt)
    kv = torch.tensor(lens, dtype=torch.int32, device=card)
    before = dict(_build.LAUNCHES)
    got = attention_df.paged_flash_attention(q, kp, vp, tables, kv,
                                             window=window)
    assert _build.LAUNCHES["paged_attention"] == \
        before["paged_attention"] + 1
    # a group over 8 runs the 16-warp kernel, counted beside
    assert _build.LAUNCHES[_build.PAGED_G16] == \
        before[_build.PAGED_G16] + (hq // hkv > 8)
    want = ref.paged_attention_ref(q, kp, vp, tables, kv, window=window)
    tol = (dict(atol=4e-3, rtol=8e-3) if dt == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    for r, n in enumerate(lens):
        if n == 0:
            assert bool((got[r] == 0).all())
    # the same row alone gives the same bits
    alone = attention_df.paged_flash_attention(q[1:2], kp, vp, tables[1:2],
                                               kv[1:2], window=window)
    assert torch.equal(alone, got[1:2])


@pytest.mark.card
def test_split_kernel_masks_a_page_outside_the_pool_on_the_card(card):
    """A page id outside the pool reads as fully masked: float32, against
    the split model on the CPU (1e-4)."""
    arrays = _paged_inputs(5, 3, 4, 2, 32, 8, 40, [300, 60, 0])
    q, k, v, tables, kv_lens = (torch.from_numpy(a) for a in arrays)
    tables[0, 3] = k.shape[1] + 7
    tables[1, 0] = -1
    got = attention_df.paged_flash_attention(
        *(t.to(card) for t in (q, k, v, tables, kv_lens)), window=None)
    want = split_model(q, k, v, tables, kv_lens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.card
def test_split_kernel_on_two_streams_at_once_on_the_card(card):
    """Launches on two streams at once, rows of many chunks, give the bits
    of a launch on the default stream: each stream merges through
    counters of its own."""
    hq, hkv, d, page, lens = 16, 8, 128, 16, [4096, 527, 2000, 1]
    rows, max_pages = len(lens), -(-max(lens) // page)
    gen = torch.Generator(device=card).manual_seed(20)
    n_pages = rows * max_pages
    kp = torch.randn((hkv, n_pages, page, d), generator=gen,
                     device=card).to(torch.bfloat16)
    vp = torch.randn((hkv, n_pages, page, d), generator=gen,
                     device=card).to(torch.bfloat16)
    tables = torch.randperm(n_pages, generator=gen, device=card).reshape(
        rows, max_pages).to(torch.int32)
    q = torch.randn((rows, hq, 1, d), generator=gen,
                    device=card).to(torch.bfloat16)
    kv = torch.tensor(lens, dtype=torch.int32, device=card)
    want = attention_df.paged_flash_attention(q, kp, vp, tables, kv)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    got = [[], []]
    for _ in range(20):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[i].append(attention_df.paged_flash_attention(
                    q, kp, vp, tables, kv))
    torch.cuda.synchronize()
    for outs in got:
        for out in outs:
            assert torch.equal(out, want)
    for stream in streams:
        assert (q.device, stream.cuda_stream) in attention_df._PAGED_COUNTERS
