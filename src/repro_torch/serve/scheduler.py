"""Continuous-batching scheduler: per-step admit, prefill and paged decode.

Twin of ``repro/serve/scheduler.py`` for paged-decode-capable configs.
Each ``step()`` admits at most one waiting request into a free slot —
its prompt's pages are acquired from the ``PagedKVCache`` (sharing any
resident full-page prefix), the prompt is prefilled whole (or only its
uncovered tail, on a prefix hit) and its KV scattered into the pages —
then runs one ``lm.paged_decode_step`` over every occupied slot straight
off the block tables.  Requests finish individually and free their slot
at once.

Admission defers (the request stays QUEUED with ``queue_reason`` set,
counted as ``backpressure``) while other requests hold pages and the
pool is above its high watermark, or while the prompt's pages cannot be
allocated.  Determinism: admission follows enqueue order, slots are
taken lowest-free-first and a request's math does not depend on the
other rows of its batch, so a mixed-length batch emits the same greedy
tokens as each request served alone.

Commit rule: a decode step writes this step's K/V into the pools in
place, at each row's committed length (or the scratch page); the
host-side ``kv_lens`` advance only after the engine has checked the
step's logits, so a failed and retried step rewrites the same positions
and leaves nothing a later step reads.

Not ported yet (each raises ``NotImplementedError``): chunked prefill
(``prefill_chunk > 0``, ROADMAP A5c), the spill and preempt rungs of the
pressure ladder (A5b) and the slot-cache decode fallback (A5d).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve.paged_cache import PagedKVCache, pages_for


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling settings for the handle/stream API."""
    max_new_tokens: int = 16
    greedy: bool = True
    seed: int = 0
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs.

    ``max_batch``      decode slots (batch rows of every decode step).
    ``prefill_chunk``  0: whole-prompt prefill (the only mode ported).
    ``page_size`` / ``n_pages`` size the page pool; ``n_pages=0`` holds
                       ``max_batch`` full ``max_len`` rows.
    ``prefix_reuse``   share full-page common prefixes across requests.
    ``high_watermark`` pool occupancy above which admission defers while
                       other requests hold pages.
    """
    max_batch: int = 4
    prefill_chunk: int = 0
    page_size: int = 16
    n_pages: int = 0
    prefix_reuse: bool = True
    high_watermark: float = 0.90


def paged_decode_enabled(cfg, sc: Optional[SchedulerConfig],
                         max_len: int) -> bool:
    """Does a scheduler built from ``sc`` decode off the page pool?"""
    sc = sc or SchedulerConfig()
    return bool(sc.page_size and lm.supports_paged_decode(cfg)
                and max_len % sc.page_size == 0)


def pool_capacity(sc: Optional[SchedulerConfig], max_len: int) -> int:
    """Total pages the scheduler's pool will hold."""
    sc = sc or SchedulerConfig()
    return sc.n_pages or sc.max_batch * pages_for(max_len, sc.page_size)


def _sample_seed(seed: int, rid: int, position: int) -> int:
    return ((seed * 1_000_003 + rid) * 1_000_003 + position) % 2 ** 63


class ContinuousScheduler:
    """Slot-based continuous batching over one ``Engine``'s page pool."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None):
        from repro_torch.serve import engine as engine_mod   # circular-safe
        self._E = engine_mod
        self.eng = engine
        self.cc = config or SchedulerConfig()
        if self.cc.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.cc.max_batch}")
        if self.cc.prefill_chunk:
            raise NotImplementedError(
                "chunked prefill is not ported yet (ROADMAP A5c)")
        if not paged_decode_enabled(engine.cfg, self.cc, engine.max_len):
            raise NotImplementedError(
                f"{engine.cfg.name} with page_size={self.cc.page_size}, "
                f"max_len={engine.max_len} needs the slot-cache decode "
                f"path, which is not ported yet (ROADMAP A5d)")
        cfg = engine.cfg
        self.waiting: deque = deque()
        self.slots: List[Optional[Any]] = [None] * self.cc.max_batch
        self.last_tok = np.zeros(self.cc.max_batch, np.int64)
        self.kv_lens = np.zeros(self.cc.max_batch, np.int64)  # committed
        self.step_count = 0
        self.greedy = True
        self.seed = 0
        self.t_start: Dict[int, float] = {}
        self.req_pages: Dict[int, List[int]] = {}
        self.paged = PagedKVCache(
            cfg, pool_capacity(self.cc, engine.max_len), self.cc.page_size,
            dtype=cfg.act_dtype, device=engine.device,
            high_watermark=self.cc.high_watermark)
        self.max_pages = engine.max_len // self.cc.page_size

    # -- queue ----------------------------------------------------------
    def enqueue(self, req) -> None:
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or any(r is not None for r in self.slots))

    def inflight(self) -> List[Any]:
        return list(self.waiting) + [r for r in self.slots if r is not None]

    # -- the step -------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit (one prefill), then decode every slot.
        Returns True if any work was done."""
        did = self._admit()
        return self._decode_paged() or did

    def drain(self, greedy: bool = True, seed: int = 0) -> None:
        """Step until every owned request is terminal.  A tick without
        progress while requests are in flight is a stall: ledgered, and
        every stranded request FAILS instead of waiting forever."""
        self.greedy, self.seed = bool(greedy), int(seed)
        try:
            while self.has_work:
                if not self.step():
                    self._stall()
                    break
        finally:
            self.greedy, self.seed = True, 0

    def _stall(self) -> None:
        stranded = [r for r in self.inflight()
                    if not self._E._terminal(r.state)]
        detail = (f"no forward progress with {len(stranded)} request(s) "
                  f"in flight: rids {sorted(r.rid for r in stranded)}")
        self.eng.monitor.note("scheduler.stall", site="serve.drain",
                              step=self.step_count, detail=detail)
        err = RuntimeError(f"scheduler stalled: {detail}")
        for r in stranded:
            self._fail(r, err)
        self.waiting.clear()
        for i, r in enumerate(self.slots):
            if r is not None:
                self._free_slot(i)

    # -- admission ------------------------------------------------------
    def _admit(self) -> bool:
        while self.waiting:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                return False
            req = self.waiting[0]
            if req.state != self._E.RequestState.QUEUED:
                self.waiting.popleft()
                continue
            plen = int(req.prompt.shape[0])
            reach = min(plen + req.max_new_tokens, self.eng.max_len)
            need_reach = pages_for(reach, self.cc.page_size)
            if need_reach > self.paged.n_pages:
                self.waiting.popleft()
                self._fail(req, RuntimeError(
                    f"page pool cannot hold request: kv reach {reach} needs "
                    f"{need_reach} pages, pool holds {self.paged.n_pages}"))
                return True
            holders = bool(self.req_pages)
            if holders and self.paged.above_high():
                self._defer(req, f"pool above high watermark (occupancy "
                                 f"{self.paged.occupancy():.2f} >= "
                                 f"{self.paged.high_watermark:.2f})")
                return False
            reuse: List[int] = []
            covered = 0
            if self.cc.prefix_reuse:
                reuse, covered = self.paged.lookup_prefix(req.prompt)
            need = pages_for(plen, self.cc.page_size) - len(reuse)
            new = self.paged.alloc(need)
            if new is None:
                if reuse:
                    self.paged.release(reuse)
                if holders:
                    self._defer(req, f"page pool exhausted ({need} pages "
                                     f"needed, {self.paged.free_pages} free)")
                    return False
                self.waiting.popleft()
                self._fail(req, RuntimeError(
                    f"page pool cannot hold prompt: {need} pages needed, "
                    f"pool holds {self.paged.n_pages}"))
                return True
            self.waiting.popleft()
            req.queue_reason = None
            self.t_start.setdefault(req.rid, time.monotonic())
            return self._prefill_whole(req, free[0], list(reuse) + new,
                                       reuse, covered)
        return False

    def _defer(self, req, reason: str) -> None:
        """Backpressure: ``req`` stays QUEUED with its reason on record."""
        if req.queue_reason != reason:
            req.queue_reason = reason
            self.eng._counters["backpressure"] += 1
            self.eng.monitor.note("backpressure", site="serve.admit",
                                  step=self.step_count,
                                  detail=f"rid {req.rid}: {reason}")

    def _prefill_whole(self, req, slot: int, pages: List[int],
                       reuse: List[int], covered: int) -> bool:
        """Prefill the prompt (only its tail on a prefix hit), scatter its
        KV into ``pages`` and install the row in ``slot``."""
        prompt = np.asarray(req.prompt, np.int64)
        req.state = self._E.RequestState.PREFILLING
        try:
            if covered:
                logits, rcache = self._prefill_from_pages(prompt, reuse,
                                                          covered)
            else:
                tokens = torch.as_tensor(prompt[None], device=self.eng.device)
                logits, rcache, path = self.eng._execute(
                    "serve.prefill", self.step_count,
                    lambda: lm.prefill(self.eng.params, tokens, self.eng.cfg,
                                       max_len=self.eng.max_len))
                self._count_path(path, [])
        except self._E.StepFailed as e:
            self._fail(req, e)
            self.paged.release(pages)
            return True
        self.paged.store(prompt, pages, covered, rcache["k"][:, 0],
                         rcache["v"][:, 0])
        self.req_pages[req.rid] = pages
        self.kv_lens[slot] = len(prompt)
        req.state = self._E.RequestState.DECODING
        self.slots[slot] = req
        self._emit(slot, logits[0].float().cpu().numpy())
        return True

    def _prefill_from_pages(self, prompt: np.ndarray, reuse: List[int],
                            covered: int):
        """Seed a fresh cache row from the reused prefix pages, then
        prefill only the uncovered tail (``lm.prefill_chunk``)."""
        cfg = self.eng.cfg
        kp, vp = self.paged.gather(reuse)
        rcache = lm.init_cache(cfg, 1, self.eng.max_len, cfg.act_dtype,
                               self.eng.device)
        rcache["k"][:, 0, :, :covered] = kp[:, :, :covered]
        rcache["v"][:, 0, :, :covered] = vp[:, :, :covered]
        rcache["index"] = covered
        tail = torch.as_tensor(prompt[None, covered:], device=self.eng.device)
        logits, rcache, path = self.eng._execute(
            "serve.prefill", self.step_count,
            lambda: lm.prefill_chunk(self.eng.params, rcache, tail, cfg,
                                     covered))
        self._count_path(path, [])
        return logits, rcache

    def _count_path(self, path: str, active: List[int]) -> None:
        if path == "degraded":
            self.eng._counters["degraded_steps"] += 1
            for i in active:
                self.slots[i].degraded_steps += 1

    # -- decode ---------------------------------------------------------
    def _acquire_decode_page(self, slot: int) -> None:
        req = self.slots[slot]
        new = self.paged.alloc(1)
        if new is None:
            raise NotImplementedError(
                f"rid {req.rid} needs a page and the pool is full: the "
                f"spill and preempt rungs are not ported yet (ROADMAP A5b)")
        self.req_pages[req.rid].extend(new)

    def _sweep_deadlines(self) -> bool:
        now = time.monotonic()
        evicted = False
        for i, r in enumerate(self.slots):
            if r is not None and r.deadline_s is not None \
                    and now - self.t_start[r.rid] > r.deadline_s:
                r.state = self._E.RequestState.EVICTED
                r.error = (f"deadline {r.deadline_s:.3f}s exceeded after "
                           f"{len(r.out_tokens)} tokens")
                self.eng._counters["evicted"] += 1
                self.eng.monitor.note("evicted", site="serve.decode_step",
                                      step=self.step_count, detail=r.error)
                self._free_slot(i)
                evicted = True
        return evicted

    def _decode_paged(self) -> bool:
        """Grow rows at page boundaries, then one paged decode step over
        the block tables."""
        evicted = self._sweep_deadlines()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return evicted
        ps = self.cc.page_size
        for i in active:
            if int(self.kv_lens[i]) // ps >= len(
                    self.req_pages[self.slots[i].rid]):
                self._acquire_decode_page(i)
        self.step_count += 1
        mb = self.cc.max_batch
        tables = np.zeros((mb, self.max_pages), np.int32)
        wp = np.full(mb, self.paged.scratch, np.int64)
        wo = np.zeros(mb, np.int64)
        for i in active:
            pages = self.req_pages[self.slots[i].rid]
            tables[i] = self.paged.block_table(pages, self.max_pages)
            kv = int(self.kv_lens[i])
            wp[i], wo[i] = pages[kv // ps], kv % ps
        dev = self.eng.device
        toks = torch.as_tensor(self.last_tok[:, None], device=dev)
        tables_d = torch.as_tensor(tables, device=dev)
        kv_d = torch.as_tensor(self.kv_lens.astype(np.int32), device=dev)
        wp_d, wo_d = torch.as_tensor(wp, device=dev), torch.as_tensor(
            wo, device=dev)
        k_pool, v_pool = self.paged.k_pages, self.paged.v_pages
        t0 = time.monotonic()
        try:
            logits, _, path = self.eng._execute(
                "serve.decode_step", self.step_count,
                lambda: lm.paged_decode_step(
                    self.eng.params, k_pool, v_pool, toks, tables_d, kv_d,
                    wp_d, wo_d, self.eng.cfg))
        except self._E.StepFailed as e:
            for i in active:
                self._fail(self.slots[i], e)
                self._free_slot(i)
            return True
        self._count_path(path, active)
        self.eng.monitor.record(self.step_count, time.monotonic() - t0)
        logits_np = logits.float().cpu().numpy()
        for i in active:
            self.kv_lens[i] += 1           # the commit; before _emit frees
            self._emit(i, logits_np[i])
        return True

    def _emit(self, slot: int, logits_row: np.ndarray) -> None:
        """Sample one token for ``slot``; finish the request on budget."""
        req = self.slots[slot]
        sp = req.sampling
        greedy = self.greedy if sp is None else sp.greedy
        if greedy:
            t = int(np.argmax(logits_row))
        else:
            seed = self.seed if sp is None else sp.seed
            gen = torch.Generator().manual_seed(
                _sample_seed(seed, req.rid, len(req.out_tokens)))
            probs = torch.softmax(torch.from_numpy(logits_row), dim=-1)
            t = int(torch.multinomial(probs, 1, generator=gen))
        req.out_tokens.append(t)
        self.last_tok[slot] = t
        if len(req.out_tokens) >= req.max_new_tokens:
            req.state = self._E.RequestState.DONE
            self.eng._counters["completed"] += 1
            self._free_slot(slot)

    # -- bookkeeping ----------------------------------------------------
    def _fail(self, req, err: BaseException) -> None:
        req.state = self._E.RequestState.FAILED
        req.error = str(err)
        self.eng._counters["failed"] += 1
        pages = self.req_pages.pop(req.rid, None)
        if pages is not None:
            self.paged.release(pages)

    def _free_slot(self, slot: int) -> None:
        req = self.slots[slot]
        self.slots[slot] = None
        self.last_tok[slot] = 0
        self.kv_lens[slot] = 0
        self.t_start.pop(req.rid, None)
        pages = self.req_pages.pop(req.rid, None)
        if pages is not None:
            self.paged.release(pages)

    def report(self) -> Dict[str, Any]:
        return {
            "steps": self.step_count,
            "waiting": len(self.waiting),
            "active": sum(r is not None for r in self.slots),
            "max_batch": self.cc.max_batch,
            "paged_decode": True,
            "pages": self.paged.report(),
        }
