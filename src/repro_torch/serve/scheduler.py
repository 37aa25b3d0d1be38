"""Continuous-batching scheduler: per-step admit, prefill and decode.

Twin of ``repro/serve/scheduler.py``.  Each ``step()`` admits at most
one waiting request into a free slot — its prompt's pages are acquired
from the ``PagedKVCache`` (sharing any resident full-page prefix), the
prompt is prefilled whole (or only its uncovered tail, on a prefix
hit), or one chunk of it when ``prefill_chunk`` is set, so running
requests never stall behind a long prompt — then runs one decode step
over every occupied slot.  Requests finish individually and free their
slot at once.

Decode runs straight off the block tables (``lm.paged_decode_step``,
B3) for every config the paged step takes.  Where it cannot
(``page_size=0``, or a ``max_len`` that is not a whole number of pages)
the scheduler keeps a contiguous slot cache of ``max_batch`` rows and
decodes with ``lm.decode_step`` (B2 at Sq = 1 with a per-row
``kv_len``); freed rows park at index 0, so the cache is a pure
function of the live requests, and a page pool (when ``page_size`` is
set) only mirrors prompts for prefix sharing.  An int8 KV cache
(``kv_cache_dtype="int8"``) always decodes off the slot cache, its
codes and per-position scales side by side, with no pool at all: the
pool holds float K/V, so there is no mirror and no prefix reuse.  A
config with SSM state (``ssm``/``conv``) decodes off the slot cache too,
each row's state beside its K/V; an attention-free one (mamba2) has no
pool, and a hybrid (hymba) keeps the mirror but never reuses a prefix:
the pages hold K/V but not the state the SSM reached over the prefix,
so a hit would prefill the tail from a state that never saw it (the JAX
scheduler does, ROADMAP C).

Memory pressure on the paged path runs a ladder, coarse to fine:

1. **watermark backpressure**: admission defers (the request stays
   QUEUED with ``queue_reason`` set, counted as ``backpressure``) while
   other requests hold pages and the pool is above ``high_watermark``,
   or while the prompt's pages cannot be allocated;
2. **host spill**: a decoding row that cannot grow by one page spills
   the coldest other active request (smallest last decode step, ties to
   the youngest rid) to host tensors (shared prefix pages stay pinned);
   it parks in ``paused``;
3. **preemption**: if no spill frees a page, the youngest request
   holding pool memory is preempted: its pages are released, an fsync'd
   ``preempt`` record is journaled, its tokens become the engine's
   replay expectation and it is re-queued.  Greedy decode is
   deterministic, so the recompute regenerates the same tokens, which
   the engine's ``replay_divergence`` check verifies.

Spilled requests resume (``unspill``, bit for bit) before anyone new is
admitted, once a slot is free and the pool is below ``low_watermark``
(or nothing is active).

Determinism: admission follows enqueue order, slots are taken
lowest-free-first, the ladder's victims are keyed on step counts and
rids only, and a request's math does not depend on the other rows of
its batch — so a mixed-length batch emits each request's tokens alone,
and a cold journal replay of the same rids walks the same evolution.

Commit rule: a decode step writes this step's K/V into the pools (or
the slot cache) in place, at each row's committed length; the committed
lengths advance only after the engine has checked the step's logits, so
a failed and retried step rewrites the same positions and leaves
nothing a later step reads.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.runtime import health
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
    ``prefill_chunk``  0 prefills whole prompts; > 0 streams a longer
                       prompt through ``lm.prefill_chunk`` one chunk a
                       step, interleaved with decode.
    ``page_size`` / ``n_pages`` size the page pool; ``n_pages=0`` holds
                       ``max_batch`` full ``max_len`` rows;
                       ``page_size=0`` decodes off the slot cache.
    ``prefix_reuse``   share full-page common prefixes across requests.
    ``high_watermark`` / ``low_watermark``: the pool-occupancy band:
                       admission defers above high, spilled requests
                       resume below low.
    """
    max_batch: int = 4
    prefill_chunk: int = 0
    page_size: int = 16
    n_pages: int = 0
    prefix_reuse: bool = True
    high_watermark: float = 0.90
    low_watermark: float = 0.60


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
    """Slot-based continuous batching over one ``Engine``: it owns the
    waiting queue, the slots, the page pool (or the slot cache) and the
    spill/preempt ladder, and borrows the engine's ``_execute``,
    journal and counters."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None):
        from repro_torch.serve import engine as engine_mod   # circular-safe
        self._E = engine_mod
        self.eng = engine
        self.cc = config or SchedulerConfig()
        if self.cc.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.cc.max_batch}")
        cfg = engine.cfg
        self.waiting: deque = deque()
        self.slots: List[Optional[Any]] = [None] * self.cc.max_batch
        self.cache: Optional[Dict[str, Any]] = None     # the slot cache
        self.last_tok = np.zeros(self.cc.max_batch, np.int64)
        self.kv_lens = np.zeros(self.cc.max_batch, np.int64)  # committed
        self.step_count = 0
        self.greedy = True
        self.seed = 0
        self.t_start: Dict[int, float] = {}
        self.req_pages: Dict[int, List[int]] = {}
        self.last_step: Dict[int, int] = {}    # rid -> last decode step
        self.paused: List[int] = []            # spilled rids, spill order
        self.spilled: Dict[int, Tuple[Any, int, List[Tuple]]] = {}
        self._pf: Optional[Tuple] = None       # chunked prefill in flight
        self.paged: Optional[PagedKVCache] = None
        # the pool holds float K/V: an int8 cache (codes and per-position
        # scales) or a config without attention gets none, so no mirror
        # and no prefix reuse, as in the JAX package
        if self.cc.page_size and cfg.has_attention and not lm.int8_kv(cfg):
            self.paged = PagedKVCache(
                cfg, pool_capacity(self.cc, engine.max_len),
                self.cc.page_size, dtype=cfg.act_dtype,
                device=engine.device,
                high_watermark=self.cc.high_watermark,
                low_watermark=self.cc.low_watermark)
        self.use_paged = paged_decode_enabled(cfg, self.cc, engine.max_len)
        # a prefix's pages carry no SSM state: a config with one never
        # reuses them
        self.prefix_reuse = self.cc.prefix_reuse and not cfg.has_ssm
        self.max_pages = (engine.max_len // self.cc.page_size
                          if self.use_paged else 0)

    # -- queue ----------------------------------------------------------
    def enqueue(self, req) -> None:
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self._pf is not None or self.paused
                    or any(r is not None for r in self.slots))

    def inflight(self) -> List[Any]:
        """Every request the scheduler owns: queued, mid-prefill,
        decoding or spilled to the host."""
        out = list(self.waiting)
        if self._pf is not None:
            out.append(self._pf[0])
        out.extend(r for r in self.slots if r is not None)
        out.extend(self.spilled[rid][0] for rid in self.paused)
        return out

    # -- the step -------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit (one prefill, or one chunk), then decode every
        slot.  Returns True if any work was done."""
        did = self._admit()
        return self._decode() or did

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
        if self._pf is not None and self._pf[3]:
            self.paged.release(self._pf[3])    # chunked-prefill reserve
        self._pf = None
        for r in stranded:
            self._fail(r, err)
        self.waiting.clear()
        for rid in list(self.paused):
            _, _, entries = self.spilled.pop(rid)
            self.paged.release([e[1] for e in entries if e[0] == "resident"])
        self.paused = []
        for i, r in enumerate(self.slots):
            if r is not None:
                self._free_slot(i)

    # -- admission ------------------------------------------------------
    def _admit(self) -> bool:
        if self._pf is not None:
            return self._advance_chunked()
        did = self._try_resume()
        if self.paused:
            # spilled requests resume before anyone new is admitted:
            # admitting into the pool they wait on would thrash
            return did
        while self.waiting:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                return did
            req = self.waiting[0]
            if req.state != self._E.RequestState.QUEUED:
                self.waiting.popleft()
                continue                   # served elsewhere
            plen = int(req.prompt.shape[0])
            chunked = bool(self.cc.prefill_chunk
                           and plen > self.cc.prefill_chunk)
            pages: Optional[List[int]] = None
            reuse: List[int] = []
            covered = 0
            if self.use_paged:
                # a request whose whole reach exceeds the pool can never
                # finish: admitting it would livelock the ladder
                reach = min(plen + req.max_new_tokens, self.eng.max_len)
                need_reach = pages_for(reach, self.cc.page_size)
                if need_reach > self.paged.n_pages:
                    self.waiting.popleft()
                    self._fail(req, RuntimeError(
                        f"page pool cannot hold request: kv reach {reach} "
                        f"needs {need_reach} pages, pool holds "
                        f"{self.paged.n_pages}"))
                    return True
                holders = bool(self.req_pages) or bool(self.spilled)
                if holders and self.paged.above_high():
                    self._defer(req, f"pool above high watermark "
                                     f"(occupancy "
                                     f"{self.paged.occupancy():.2f} >= "
                                     f"{self.paged.high_watermark:.2f})")
                    return did
                if not chunked and self.prefix_reuse:
                    reuse, covered = self.paged.lookup_prefix(req.prompt)
                need = pages_for(plen, self.cc.page_size) - len(reuse)
                new = self.paged.alloc(need)
                if new is None:
                    if reuse:
                        self.paged.release(reuse)
                    if holders:
                        self._defer(req, f"page pool exhausted ({need} "
                                         f"pages needed, "
                                         f"{self.paged.free_pages} free)")
                        return did
                    self.waiting.popleft()
                    self._fail(req, RuntimeError(
                        f"page pool cannot hold prompt: {need} pages "
                        f"needed, pool holds {self.paged.n_pages}"))
                    return True
                pages = list(reuse) + new
            self.waiting.popleft()
            req.queue_reason = None
            self._ensure_cache()
            self.t_start.setdefault(req.rid, time.monotonic())
            c = self.cc.prefill_chunk
            self.eng._warm_autotune(
                1, plen, self.cc.max_batch, per_row=True,
                chunks=(c, plen - (plen - 1) // c * c) if chunked else None)
            if chunked:
                self._pf = (req, None, 0, pages)
                return self._advance_chunked()
            return self._prefill_whole(req, free[0], pages, reuse, covered)
        return did

    def _defer(self, req, reason: str) -> None:
        """Backpressure: ``req`` stays QUEUED with its reason on record."""
        if req.queue_reason != reason:
            req.queue_reason = reason
            self.eng._counters["backpressure"] += 1
            self.eng.monitor.note("backpressure", site="serve.admit",
                                  step=self.step_count,
                                  detail=f"rid {req.rid}: {reason}")

    def _try_resume(self) -> bool:
        """Unspill the oldest paused request once a slot is free and the
        pool is below the low watermark (or nothing is active)."""
        if not self.paused:
            return False
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            return False
        if any(r is not None for r in self.slots) \
                and not self.paged.below_low():
            return False
        rid = self.paused[0]
        req, kv_len, entries = self.spilled[rid]
        while True:
            pages = self.paged.unspill(entries)
            if pages is not None:
                break
            if self._preempt_youngest(exclude_rid=rid):
                continue
            # no room even with everyone else gone: recompute this one
            self.paused.pop(0)
            del self.spilled[rid]
            self.paged.release([e[1] for e in entries if e[0] == "resident"])
            self._requeue(req)
            return True
        self.paused.pop(0)
        del self.spilled[rid]
        slot = free[0]
        req.state = self._E.RequestState.DECODING
        self.slots[slot] = req
        self.req_pages[rid] = pages
        self.kv_lens[slot] = kv_len
        self.last_tok[slot] = req.out_tokens[-1]
        self.last_step[rid] = self.step_count
        self.eng._counters["unspills"] += 1
        self.eng.monitor.note(
            "unspill", site="serve.admit", step=self.step_count,
            detail=f"rid {rid}: {len(pages)} pages back on the device at "
                   f"kv_len {kv_len}")
        return True

    def _ensure_cache(self) -> None:
        if self.use_paged or self.cache is not None:
            return                         # the pool is the datapath
        eng = self.eng
        self.cache = lm.init_cache(eng.cfg, self.cc.max_batch, eng.max_len,
                                   eng.cfg.act_dtype, eng.device)
        self.cache["index"] = torch.zeros(self.cc.max_batch,
                                          dtype=torch.int32,
                                          device=eng.device)

    def _prefill_whole(self, req, slot: int, pages: Optional[List[int]],
                       reuse: List[int], covered: int) -> bool:
        """Prefill the prompt (only its tail on a prefix hit) and install
        the row in ``slot``.  On the paged path ``pages`` (with the
        shared prefix) were acquired at admission; the slot path looks
        its prefix up in the mirror pool here."""
        prompt = np.asarray(req.prompt, np.int64)
        if pages is None:
            reuse, covered = [], 0
            if self.paged is not None and self.prefix_reuse:
                reuse, covered = self.paged.lookup_prefix(prompt)
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
            if pages is not None:
                self.paged.release(pages)
            elif reuse:
                self.paged.release(reuse)
            return True
        self._store_pages(req, prompt, reuse, covered, rcache, pages)
        self._install(req, slot, rcache, len(prompt), logits[0])
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
        self.eng._warm_autotune(1, len(prompt), self.cc.max_batch,
                                per_row=True, chunks=(len(prompt) - covered,))
        tail = torch.as_tensor(prompt[None, covered:], device=self.eng.device)
        logits, rcache, path = self.eng._execute(
            "serve.prefill", self.step_count,
            lambda: lm.prefill_chunk(self.eng.params, rcache, tail, cfg,
                                     covered))
        self._count_path(path, [])
        return logits, rcache

    def _advance_chunked(self) -> bool:
        """Push one chunk of the prompt in flight; after its last chunk,
        install the row in a free slot.  The deadline is checked at every
        chunk boundary: a prompt past its deadline is evicted there, not
        after its remaining chunks."""
        RequestState = self._E.RequestState
        req, rcache, pos, pages = self._pf
        prompt = np.asarray(req.prompt, np.int64)
        plen = len(prompt)
        dl = req.deadline_s
        if dl is not None and time.monotonic() - self.t_start[req.rid] > dl:
            self._pf = None
            if pages:
                self.paged.release(pages)
            req.state = RequestState.EVICTED
            req.error = (f"deadline {dl:.3f}s exceeded during chunked "
                         f"prefill at position {pos}/{plen}")
            self.eng._counters["evicted"] += 1
            self.eng.monitor.note("evicted", site="serve.prefill",
                                  step=self.step_count, detail=req.error)
            self.eng._journal_terminal(req, self.step_count)
            self.t_start.pop(req.rid, None)
            return True
        end = min(pos + self.cc.prefill_chunk, plen)
        cfg = self.eng.cfg
        toks = torch.as_tensor(prompt[None, pos:end], device=self.eng.device)
        req.state = RequestState.PREFILLING
        try:
            if rcache is None:
                rcache = lm.init_cache(cfg, 1, self.eng.max_len,
                                       cfg.act_dtype, self.eng.device)
            logits, rcache, path = self.eng._execute(
                "serve.prefill", self.step_count,
                lambda: lm.prefill_chunk(self.eng.params, rcache, toks, cfg,
                                         pos))
            self._count_path(path, [])
        except self._E.StepFailed as e:
            self._pf = None
            self._fail(req, e)
            if pages:
                self.paged.release(pages)
            return True
        if end < plen:
            self._pf = (req, rcache, end, pages)
            return True
        self._pf = None
        free = [i for i, r in enumerate(self.slots) if r is None]
        self._store_pages(req, prompt, [], 0, rcache, pages)
        self._install(req, free[0], rcache, plen, logits[0])
        return True

    def _store_pages(self, req, prompt: np.ndarray, reuse: List[int],
                     covered: int, rcache, pages: Optional[List[int]]
                     ) -> None:
        """Scatter the prefilled row into the page pool.  On the paged
        path ``pages`` were acquired at admission, so this cannot fail;
        the slot path mirrors what the pool can hold, for prefix
        sharing, and skips the rest (and a cache with no K/V)."""
        if self.paged is None or "k" not in rcache:
            return
        if pages is None:
            new = self.paged.alloc(
                pages_for(len(prompt), self.cc.page_size) - len(reuse))
            if new is None:
                if reuse:
                    self.paged.release(reuse)
                return
            pages = list(reuse) + new
        self.paged.store(prompt, pages, covered, rcache["k"][:, 0],
                         rcache["v"][:, 0])
        self.req_pages[req.rid] = pages

    def _install(self, req, slot: int, rcache, plen: int,
                 first_logits: torch.Tensor) -> None:
        """Make the row live (paged: its committed length; slot cache:
        copy the prefilled row in, its SSM state too) and emit its first
        token."""
        if self.use_paged:
            self.kv_lens[slot] = plen
        else:
            for name in lm.CACHE_KEYS:
                if name in self.cache:
                    self.cache[name][:, slot] = rcache[name][:, 0]
            self.cache["index"][slot] = plen
        req.state = self._E.RequestState.DECODING
        self.slots[slot] = req
        self._emit(slot, first_logits.float().cpu().numpy())

    def _count_path(self, path: str, active: List[int]) -> None:
        if path == "degraded":
            self.eng._counters["degraded_steps"] += 1
            for i in active:
                self.slots[i].degraded_steps += 1

    # -- the pressure ladder --------------------------------------------
    def _acquire_decode_page(self, slot: int) -> bool:
        """One more page for ``slot``'s request, running the ladder when
        the pool is full: spill the coldest other active request, then
        preempt the youngest other holder.  False once the ladder is
        spent (the caller preempts the needy request itself)."""
        req = self.slots[slot]
        while True:
            new = self.paged.alloc(1)
            if new is not None:
                self.req_pages[req.rid].extend(new)
                return True
            if self._spill_coldest(exclude_slot=slot):
                continue
            if self._preempt_youngest(exclude_rid=req.rid):
                continue
            return False

    def _spill_coldest(self, exclude_slot: int) -> bool:
        """Spill the active request with the smallest last decode step
        (ties to the youngest rid) other than ``exclude_slot``."""
        cands = [i for i, r in enumerate(self.slots)
                 if r is not None and i != exclude_slot]
        if not cands:
            return False
        victim = min(cands, key=lambda i: (
            self.last_step.get(self.slots[i].rid, 0), -self.slots[i].rid))
        return self._spill_slot(victim)

    def _spill_slot(self, slot: int) -> bool:
        """Move ``slot``'s request to the host tier and park it.  A
        ``pool.spill`` raise aborts the spill (the caller preempts)."""
        req = self.slots[slot]
        pages = self.req_pages[req.rid]
        try:
            entries = self.paged.spill(pages)
        except health.SimulatedFailure as e:
            self.eng.monitor.note("spill-failed", site="pool.spill",
                                  step=self.step_count,
                                  detail=f"rid {req.rid}: {e}")
            return False
        del self.req_pages[req.rid]
        n_host = sum(1 for e in entries if e[0] == "host")
        self.spilled[req.rid] = (req, int(self.kv_lens[slot]), entries)
        self.paused.append(req.rid)
        self.slots[slot] = None
        self.last_tok[slot] = 0
        self.kv_lens[slot] = 0
        self.eng._counters["spills"] += 1
        self.eng._counters["spilled_pages"] += n_host
        self.eng.monitor.note(
            "spill", site="serve.decode_step", step=self.step_count,
            detail=f"rid {req.rid}: {n_host} page(s) to the host "
                   f"({len(entries) - n_host} shared stay pinned)")
        return True

    def _preempt_youngest(self, exclude_rid: Optional[int] = None) -> bool:
        """Preempt the youngest (highest-rid) request holding pool pages,
        paused before active."""
        paused = [rid for rid in self.paused if rid != exclude_rid]
        if paused:
            rid = max(paused)
            req, _, entries = self.spilled.pop(rid)
            self.paused.remove(rid)
            self.paged.release([e[1] for e in entries if e[0] == "resident"])
            self._requeue(req)
            return True
        cands = [i for i, r in enumerate(self.slots)
                 if r is not None and r.rid != exclude_rid]
        if not cands:
            return False
        self._preempt_slot(max(cands, key=lambda i: self.slots[i].rid))
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Release ``slot``'s pages and re-queue its request."""
        req = self.slots[slot]
        self.paged.release(self.req_pages.pop(req.rid))
        self.slots[slot] = None
        self.last_tok[slot] = 0
        self.kv_lens[slot] = 0
        self.last_step.pop(req.rid, None)
        self._requeue(req)

    def _requeue(self, req) -> None:
        """Journal an fsync'd ``preempt`` record, keep the emitted tokens
        as the replay expectation, and put the request back at the head
        of the queue."""
        if self.eng.journal is not None:
            self.eng.journal.append("preempt", fsync=True, rid=req.rid,
                                    step=self.step_count,
                                    tokens_done=len(req.out_tokens))
        if req.out_tokens:
            exp = self.eng._replay_expected
            if len(req.out_tokens) > len(exp.get(req.rid, [])):
                exp[req.rid] = list(req.out_tokens)
        req.out_tokens = []
        req.state = self._E.RequestState.QUEUED
        self.waiting.appendleft(req)
        self.eng._counters["preemptions"] += 1
        self.eng.monitor.note(
            "preempt", site="serve.decode_step", step=self.step_count,
            detail=f"rid {req.rid} re-queued under memory pressure (to "
                   f"recompute)")

    # -- decode ---------------------------------------------------------
    def _sweep_deadlines(self) -> bool:
        """Evict every active or spilled request past its deadline."""
        now = time.monotonic()
        evicted = False
        for i, r in enumerate(self.slots):
            if r is not None and r.deadline_s is not None \
                    and now - self.t_start[r.rid] > r.deadline_s:
                self._evict(r, i)
                evicted = True
        for rid in list(self.paused):
            req, _, entries = self.spilled[rid]
            if req.deadline_s is not None \
                    and now - self.t_start.get(rid, now) > req.deadline_s:
                self.paused.remove(rid)
                del self.spilled[rid]
                self.paged.release([e[1] for e in entries
                                    if e[0] == "resident"])
                self._evict(req, None)
                evicted = True
        return evicted

    def _evict(self, r, slot: Optional[int]) -> None:
        r.state = self._E.RequestState.EVICTED
        r.error = (f"deadline {r.deadline_s:.3f}s exceeded after "
                   f"{len(r.out_tokens)} tokens")
        self.eng._counters["evicted"] += 1
        self.eng.monitor.note("evicted", site="serve.decode_step",
                              step=self.step_count, detail=r.error)
        self.eng._journal_terminal(r, self.step_count)
        if slot is not None:
            self._free_slot(slot)
        else:
            self.t_start.pop(r.rid, None)
            self.last_step.pop(r.rid, None)

    def _decode(self) -> bool:
        """One decode step over every occupied slot: off the page pool,
        or off the slot cache."""
        if self.use_paged:
            return self._decode_paged()
        evicted = self._sweep_deadlines()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return evicted
        self.step_count += 1
        dev = self.eng.device
        toks = torch.as_tensor(self.last_tok[:, None], device=dev)
        cache = self.cache
        t0 = time.monotonic()
        try:
            logits, cache, path = self.eng._execute(
                "serve.decode_step", self.step_count,
                lambda: lm.decode_step(self.eng.params, cache, toks,
                                       self.eng.cfg))
        except self._E.StepFailed as e:
            for i in active:
                self._fail(self.slots[i], e)
                self._free_slot(i)
            return True
        self.cache = cache                 # the commit
        self._count_path(path, active)
        self.eng.monitor.record(self.step_count, time.monotonic() - t0)
        logits_np = logits.float().cpu().numpy()
        for i in active:
            self._emit(i, logits_np[i])
        # park freed rows at index 0, so the cache is a pure function of
        # the live requests (what a cold replay rebuilds)
        occupied = torch.as_tensor([r is not None for r in self.slots],
                                   device=dev)
        self.cache["index"] = torch.where(
            occupied, self.cache["index"],
            torch.zeros_like(self.cache["index"]))
        return True

    def _decode_paged(self) -> bool:
        """Grow rows at page boundaries (the ladder runs when the pool is
        full), then one paged decode step over the block tables."""
        evicted = self._sweep_deadlines()
        if not any(r is not None for r in self.slots):
            return evicted
        ps = self.cc.page_size
        # the ladder may spill or preempt other slots while serving row i,
        # so liveness is read again row by row
        for i in range(self.cc.max_batch):
            req = self.slots[i]
            if req is None:
                continue
            if int(self.kv_lens[i]) // ps < len(self.req_pages[req.rid]):
                continue
            if not self._acquire_decode_page(i):
                # the ladder is spent and this request is the only holder
                # left: recompute it later rather than wedge
                self._preempt_slot(i)
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return True                    # the ladder did the work
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
        """Sample one token for ``slot``, journal it, and finish the
        request on its budget."""
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
        self.last_step[req.rid] = self.step_count
        if self.eng.journal is not None:
            self.eng.journal.append("token", rid=req.rid,
                                    step=len(req.out_tokens), token=t)
        if len(req.out_tokens) >= req.max_new_tokens:
            req.state = self._E.RequestState.DONE
            self.eng._counters["completed"] += 1
            self.eng._journal_terminal(req, self.step_count)
            self._free_slot(slot)

    # -- bookkeeping ----------------------------------------------------
    def _fail(self, req, err: BaseException) -> None:
        req.state = self._E.RequestState.FAILED
        req.error = str(err)
        self.eng._counters["failed"] += 1
        self.eng._journal_terminal(req, self.step_count)
        pages = self.req_pages.pop(req.rid, None)
        if pages is not None:
            self.paged.release(pages)

    def _free_slot(self, slot: int) -> None:
        req = self.slots[slot]
        self.slots[slot] = None
        self.last_tok[slot] = 0
        self.kv_lens[slot] = 0
        self.t_start.pop(req.rid, None)
        self.last_step.pop(req.rid, None)
        pages = self.req_pages.pop(req.rid, None)
        if pages is not None:
            self.paged.release(pages)

    def report(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "steps": self.step_count,
            "waiting": len(self.waiting),
            "active": sum(r is not None for r in self.slots),
            "paused": len(self.paused),
            "max_batch": self.cc.max_batch,
            "paged_decode": self.use_paged,
        }
        if self.paged is not None:
            out["pages"] = self.paged.report()
        return out
