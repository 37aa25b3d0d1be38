"""Paged KV cache: block-table indirection over a shared page pool.

Twin of ``repro/serve/paged_cache.py``.  K and V live in pools of shape
``(n_layers, n_kv_heads, n_pages + 1, page_size, d_head)`` on the
device; a request owns a list of page ids holding its positions
``[0, kv_len)`` in order.  Page ``n_pages`` is the scratch page: decode
writes of idle batch rows land there, and it is never allocated or read.
Pages are refcounted, and full pages join a prefix chain keyed
``(parent_key, token_chunk)`` so prompts with a common prefix share its
pages (``lookup_prefix``).  Bookkeeping is host-side; only the payload
lives on the device.

Memory pressure adds a second tier below the device pool:
``spill(pages)`` copies a cold request's private pages to host tensors
and returns the device pages to the free list; ``unspill(entries)``
copies them back bit for bit.  Shared prefix pages (refcount > 1) are
never copied: the spilling request keeps its reference, so they stay
pinned.  High and low watermarks over the pool's occupancy give the
scheduler a hysteresis band: admission defers above ``high_watermark``
and spilled requests resume below ``low_watermark``.  A release of a
free page (a double free) is counted, and raises under
``REPRO_STRICT_POOL=1``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime import health


def _strict_pool() -> bool:
    return os.environ.get("REPRO_STRICT_POOL", "0") not in ("", "0")


def pages_for(seq: int, page_size: int) -> int:
    """Pages needed to hold ``seq`` KV positions (ceil division)."""
    return max(0, -(-int(seq) // int(page_size)))


class PagedKVCache:
    """Refcounted page pool with prefix reuse for one model config."""

    def __init__(self, cfg, n_pages: int, page_size: int = 16,
                 dtype: str = "bfloat16", device=None,
                 high_watermark: float = 0.90, low_watermark: float = 0.60):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        shape = (cfg.n_layers, cfg.n_kv_heads, n_pages + 1, page_size,
                 cfg.d_head)
        dt = getattr(torch, dtype)
        self.k_pages = torch.zeros(shape, dtype=dt, device=device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=device)
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.scratch = int(n_pages)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.refs = np.zeros(n_pages, np.int32)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._prefix: Dict[Tuple, int] = {}
        self._page_key: Dict[int, Tuple] = {}
        self.stats: Dict[str, int] = {
            "allocs": 0, "frees": 0, "reuse_hits": 0, "reuse_pages": 0,
            "oom_rejects": 0, "ref_underflows": 0,
            "spills": 0, "spilled_pages": 0, "unspills": 0,
        }

    # -- allocation -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_pages

    def above_high(self) -> bool:
        return self.occupancy() >= self.high_watermark

    def below_low(self) -> bool:
        return self.occupancy() <= self.low_watermark

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh pages (ref 1 each), or None if the pool cannot
        hold them; never a partial allocation.  A ``pool.alloc``
        raise-fault counts as a simulated OOM."""
        try:
            health.maybe_inject("pool.alloc")
        except health.SimulatedFailure:
            self.stats["oom_rejects"] += 1
            return None
        if n > len(self._free):
            self.stats["oom_rejects"] += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pid in pages:
            self.refs[pid] = 1
        self.stats["allocs"] += n
        return pages

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; at 0 the page returns to the free
        list and leaves the prefix chain.  A release of a free page (a
        double free) is counted in ``ref_underflows``, not clamped
        silently, and raises under ``REPRO_STRICT_POOL=1``: an underflow
        means another request's shared page was just freed under it."""
        for pid in pages:
            if self.refs[pid] <= 0:
                self.stats["ref_underflows"] += 1
                if _strict_pool():
                    raise RuntimeError(
                        f"page {pid} released with refcount "
                        f"{int(self.refs[pid])} (double free)")
                continue
            self.refs[pid] -= 1
            if self.refs[pid] == 0:
                key = self._page_key.pop(pid, None)
                if key is not None:
                    self._prefix.pop(key, None)
                self._free.append(pid)
                self.stats["frees"] += 1

    # -- host spill tier -----------------------------------------------
    def spill(self, pages: Sequence[int]) -> List[Tuple]:
        """Move a request's pages to host memory, freeing device pages.

        One entry per page, in order: ``("host", k, v)`` for a private
        page (refcount 1), whose payload (``(n_layers, n_kv_heads, page,
        d_head)`` each) was copied to host tensors and whose device page
        went back to the free list; ``("resident", pid)`` for a shared
        page, which stays on the device with the spiller's reference.
        """
        # the SIGKILL-mid-spill drill's site: spilling never touches the
        # journal, so a cold replay re-prefills and needs no host copy
        health.maybe_inject("pool.spill")
        entries: List[Tuple] = []
        n_host = 0
        for pid in pages:
            pid = int(pid)
            if self.refs[pid] > 1:
                entries.append(("resident", pid))
                continue
            entries.append(("host",
                            self.k_pages[:, :, pid].to("cpu", copy=True),
                            self.v_pages[:, :, pid].to("cpu", copy=True)))
            self.release([pid])
            n_host += 1
        self.stats["spills"] += 1
        self.stats["spilled_pages"] += n_host
        return entries

    def unspill(self, entries: Sequence[Tuple]) -> Optional[List[int]]:
        """Copy spilled entries back onto fresh device pages; returns the
        request's page list in its old order (shared pages unchanged), or
        None, with ``entries`` untouched and no page taken, when the pool
        cannot hold them now."""
        need = sum(1 for e in entries if e[0] == "host")
        fresh = self.alloc(need) if need else []
        if fresh is None:
            return None
        pages: List[int] = []
        new_ids, chunks_k, chunks_v = [], [], []
        it = iter(fresh)
        for e in entries:
            if e[0] == "resident":
                pages.append(e[1])
                continue
            pid = next(it)
            pages.append(pid)
            new_ids.append(pid)
            chunks_k.append(e[1])
            chunks_v.append(e[2])
        if new_ids:
            idx = torch.as_tensor(new_ids, device=self.k_pages.device)
            for pool, chunks in ((self.k_pages, chunks_k),
                                 (self.v_pages, chunks_v)):
                pool[:, :, idx] = torch.stack(chunks, dim=2).to(
                    device=pool.device, dtype=pool.dtype)
        self.stats["unspills"] += 1
        return pages

    # -- prefix reuse ---------------------------------------------------
    def lookup_prefix(self, tokens) -> Tuple[List[int], int]:
        """Longest resident full-page prefix of ``tokens``: the shared
        pages, incref'd, and the positions they hold.  Never the whole
        prompt: the last token is prefilled live so its logits exist."""
        toks = [int(t) for t in tokens]
        limit = (len(toks) - 1) // self.page_size * self.page_size
        pages: List[int] = []
        covered = 0
        parent: Tuple = ()
        while covered < limit:
            key = (parent, tuple(toks[covered:covered + self.page_size]))
            pid = self._prefix.get(key)
            if pid is None:
                break
            pages.append(pid)
            self.refs[pid] += 1
            parent = key
            covered += self.page_size
        if pages:
            self.stats["reuse_hits"] += 1
            self.stats["reuse_pages"] += len(pages)
        return pages, covered

    def store(self, tokens, pages: Sequence[int], covered: int,
              k_row: torch.Tensor, v_row: torch.Tensor) -> None:
        """Write a request's prefilled KV into its new pages.

        ``pages`` is the request's full page list (reused prefix first);
        positions below ``covered`` are already resident.  ``k_row`` /
        ``v_row`` are its contiguous KV, ``(n_layers, n_kv_heads, >=plen,
        d_head)``; a partial last page is zero past the prompt.  Newly
        stored full pages join the prefix chain.
        """
        toks = [int(t) for t in tokens]
        plen = len(toks)
        ps = self.page_size
        first_new, n_total = covered // ps, pages_for(plen, ps)
        if first_new < n_total:
            lo, hi = first_new * ps, n_total * ps
            idx = torch.as_tensor(list(pages[first_new:n_total]),
                                  device=self.k_pages.device)
            for pool, row in ((self.k_pages, k_row), (self.v_pages, v_row)):
                chunk = torch.zeros(row.shape[:2] + (hi - lo, row.shape[3]),
                                    dtype=pool.dtype, device=pool.device)
                chunk[:, :, :plen - lo] = row[:, :, lo:plen]
                pool[:, :, idx] = chunk.reshape(
                    row.shape[0], row.shape[1], n_total - first_new, ps,
                    row.shape[3])
        parent: Tuple = ()
        for gi in range(plen // ps):
            key = (parent, tuple(toks[gi * ps:(gi + 1) * ps]))
            pid = pages[gi]
            if gi >= first_new and pid not in self._page_key \
                    and key not in self._prefix:
                self._prefix[key] = pid
                self._page_key[pid] = key
            parent = key

    # -- views ----------------------------------------------------------
    def gather(self, pages: Sequence[int]):
        """Contiguous ``(n_layers, n_kv_heads, len(pages)*page, d_head)``
        K/V of a request (seeds a prefix-reuse prefill)."""
        idx = torch.as_tensor(list(pages), device=self.k_pages.device)
        shp = self.k_pages.shape
        k = self.k_pages[:, :, idx].reshape(
            shp[0], shp[1], len(pages) * self.page_size, shp[4])
        v = self.v_pages[:, :, idx].reshape(
            shp[0], shp[1], len(pages) * self.page_size, shp[4])
        return k, v

    def block_table(self, pages: Sequence[int], max_pages: int) -> np.ndarray:
        """One request's ``(max_pages,)`` int32 table row, padded with
        page 0 (never read: the kernel stops at the row's last page)."""
        row = np.zeros(max_pages, np.int32)
        row[:len(pages)] = np.asarray(list(pages), np.int32)
        return row

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.stats)
        out["pages_total"] = self.n_pages
        out["pages_free"] = len(self._free)
        out["pages_shared"] = int(np.sum(self.refs > 1))
        out["occupancy"] = round(self.occupancy(), 4)
        out["above_high"] = self.above_high()
        out["below_low"] = self.below_low()
        return out
