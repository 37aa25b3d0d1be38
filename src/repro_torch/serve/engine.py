"""Serving engine: request lifecycle, batch-synchronous and continuous.

Twin of ``repro/serve/engine.py``:

    QUEUED -> PREFILLING -> DECODING -> {DONE, FAILED, EVICTED}

``submit`` validates a prompt (``ValueError``) and rejects what the
port's kernels cannot run or the page pool can never hold
(``AdmissionError``), and returns a ``RequestHandle``.  ``step`` /
``drain`` (and the handles' ``tokens()``/``result()``) run the
``ContinuousScheduler``.  ``serve`` drives a batch: equal prompt lengths
run the batch-synchronous loop (one prefill, then ``lm.decode_step`` on
the slot cache until the last request finishes, resumable from a
snapshot); mixed lengths run a fresh continuous scheduler.
``generate`` is a deprecated shim over ``submit`` + ``drain``.

Every prefill and decode step runs under ``_execute``: the
``serve.prefill`` / ``serve.decode_step`` fault sites fire, the step's
logits must be finite, and a failed step is retried with backoff.  On
the card the retry runs the CUDA kernels again: the plain PyTorch
versions never stand in for them there.  On a CPU engine, where every
kernel wrapper computes its plain version, a failed step demotes to
``layers.forced_backend("torch")`` as the JAX engine demotes to XLA,
re-probing the primary path after a cooldown.  A kernel that does not
build or launch (``KernelError``) is not a failed step: it propagates at
once.  Admission asks what the CUDA kernels accept — the head dimension
and the GQA group — and then, as the JAX engine does,
whether the explorer has a feasible attention dataflow for every
workload the request implies (``_attention_feasible``).  A CUDA engine
warms the autotuner (``core.autotune``) for each request shape before it
runs (``_warm_autotune``), so the ops' ``spec=None`` lookups on the
serving path are dictionary hits; ``self.hw`` is the card the engine's
device is, and the picks are the Hopper cost model's for it.

Crash safety.  Given a journal directory (``journal_dir=`` or
``REPRO_JOURNAL_DIR``), every admission, emitted token, preemption and
terminal transition is written ahead to a ``RequestJournal``.
``snapshot()`` saves the batch loop's whole state — request table,
tokens, counters, health ledger, slot cache, last logits and params —
through the ``Checkpointer``, every ``snapshot_every`` decode steps
(``REPRO_SNAPSHOT_EVERY``); it exists only inside the batch-synchronous
loop.  After a kill, a fresh engine's ``restore()`` rebuilds the request
table from the journal, loads the newest intact snapshot onto its own
device (falling back to older ones, then to a journal-only cold replay)
and arms the resume; the next ``serve()`` finishes the interrupted batch.
Greedy decode is a pure function of the params and the journaled
prompts, so the recovered tokens equal the uninterrupted run's, and
``_check_replay`` counts any that do not (``replay_divergence``).
``restore(devices=...)`` (a smaller mesh) is not ported (ROADMAP A14).

An encoder-decoder config (whisper, family ``audio``) is admitted as the
JAX engine admits it, and served as that engine serves it: no step of
either passes encoder frames (the JAX engine's ``make_prefill_fn`` never
does), so a whole-prompt prefill raises ``ValueError`` inside
``_execute`` and its requests end FAILED once the retries are spent; a
chunked prefill runs ``lm.prefill_chunk`` over the cache's zero cross
K/V, as the JAX scheduler's does.  The encoder runs through
``lm.prefill(..., enc_frames=)`` and ``lm.forward``, outside the engine.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.ckpt.checkpoint import Checkpointer, CheckpointError
from repro_torch.core import autotune, cost_model, explorer
from repro_torch.kernels import attention_df
from repro_torch.kernels._build import KernelError
from repro_torch.models import bridge, layers, lm
from repro_torch.runtime import health
from repro_torch.serve import journal as journal_lib
from repro_torch.serve.paged_cache import pages_for
from repro_torch.serve.scheduler import (ContinuousScheduler, SamplingParams,
                                         SchedulerConfig, _sample_seed,
                                         paged_decode_enabled, pool_capacity)

health.register_site("snapshot.save")
health.register_site("engine.restore")


class RequestState(str, enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"
    FAILED = "failed"
    EVICTED = "evicted"


def _terminal(state: RequestState) -> bool:
    return state in (RequestState.DONE, RequestState.FAILED,
                     RequestState.EVICTED)


def to_state_safe(value) -> RequestState:
    """RequestState from a journal or snapshot string; QUEUED on junk."""
    try:
        return RequestState(value)
    except ValueError:
        return RequestState.QUEUED


class AdmissionError(ValueError):
    """Request rejected at admission (resource infeasibility)."""


class StepFailed(RuntimeError):
    """A prefill/decode step failed on both paths, retries exhausted."""


class NonFiniteLogits(RuntimeError):
    """The post-step sentinel saw NaN/Inf logits."""


@dataclasses.dataclass
class RequestHandle:
    """One request, as ``Engine.submit`` or ``restore`` returns it, bound
    to its engine.  ``tokens()`` streams generated ids, stepping the
    engine when the stream runs dry; ``result()`` drains it
    (``StepFailed`` if FAILED).  A request served by ``serve()`` has its
    tokens in ``out_tokens`` already."""
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    deadline_s: Optional[float] = None   # wall-clock budget from admission
    rid: int = -1
    state: RequestState = RequestState.QUEUED
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    degraded_steps: int = 0       # decode steps served on the plain path
    queue_reason: Optional[str] = None   # why a QUEUED request waits
    sampling: Optional[SamplingParams] = None
    engine: Optional["Engine"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def tokens(self) -> Iterator[int]:
        i = 0
        while True:
            while i < len(self.out_tokens):
                yield self.out_tokens[i]
                i += 1
            if _terminal(self.state):
                return
            if self.engine is None:
                raise RuntimeError(f"request {self.rid} is detached from "
                                   f"its engine and not terminal")
            self.engine.step()

    def result(self) -> np.ndarray:
        for _ in self.tokens():
            pass
        if self.state == RequestState.FAILED:
            raise StepFailed(f"request {self.rid} ended failed: "
                             f"{self.error}")
        return np.asarray(self.out_tokens, np.int32)


class Engine:
    """Serving with admission, degradation, retries and crash recovery,
    on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, cfg, params, max_len: int = 2048, device=None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 journal_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None):
        self.device = device_lib.resolve(device)
        lm._check_supported(cfg)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.hw = cost_model.hardware_for(self.device)
        self._warmed: set = set()
        # (seq len, kv reach) -> feasible
        self._admission_cache: Dict[Tuple[int, int], bool] = {}
        self.monitor = health.HealthMonitor()
        self.policy = health.DegradationPolicy()
        self.scheduler_config = scheduler_config
        self._scheduler: Optional[ContinuousScheduler] = None
        self._last_sched_report: Optional[Dict[str, Any]] = None
        self._backlog: List[RequestHandle] = []
        self._next_rid = 0
        self._kernel_refusal = self._kernels_refuse()
        jd = journal_dir or journal_lib.journal_dir()
        self.journal = journal_lib.RequestJournal(jd) if jd else None
        sd = snapshot_dir or (os.path.join(jd, "snapshots") if jd else None)
        self.snapshots = Checkpointer(sd) if sd else None
        if snapshot_every is None:
            snapshot_every = int(os.environ.get("REPRO_SNAPSHOT_EVERY", "0")
                                 or 0)
        self.snapshot_every = snapshot_every
        # the batch loop's state between decode steps, for snapshot():
        # (reqs, cache, logits, step, greedy, seed)
        self._live: Optional[Tuple] = None
        self._pending_resume: Optional[Dict[str, Any]] = None
        self._replay_expected: Dict[int, List[int]] = {}
        self._counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "rejected": 0,
            "completed": 0, "failed": 0, "evicted": 0,
            "retries": 0, "demotions": 0, "degraded_steps": 0,
            "budget_clamped": 0,
            "snapshots_saved": 0, "snapshot_errors": 0,
            "recovered": 0, "replayed_steps": 0,
            "replay_divergence": 0, "restore_fallbacks": 0,
            "spills": 0, "spilled_pages": 0, "unspills": 0,
            "preemptions": 0, "backpressure": 0,
        }

    # -- admission ------------------------------------------------------
    def _kernels_refuse(self) -> Optional[str]:
        """Why the port's kernels cannot serve this config, or None.  An
        attention-free config (an SSM's) reaches no attention kernel."""
        cfg = self.cfg
        if not cfg.has_attention:
            return None
        if cfg.d_head not in attention_df.HEAD_DIMS:
            return (f"d_head {cfg.d_head} not in the attention kernels' "
                    f"{attention_df.HEAD_DIMS}")
        if cfg.n_heads // cfg.n_kv_heads > attention_df.MAX_GROUP:
            return (f"GQA group {cfg.n_heads // cfg.n_kv_heads} > the paged "
                    f"kernel's {attention_df.MAX_GROUP}")
        return None

    def _attention_feasible(self, seq: int,
                            cap: Optional[int] = None) -> bool:
        """Does the explorer have a feasible attention dataflow (B2 or B7
        on ``self.hw``) for every attention workload a request of ``seq``
        prompt tokens and kv reach ``cap`` implies?"""
        cap = int(cap if cap is not None else self.max_len)
        key = (seq, cap)
        if key not in self._admission_cache:
            self._admission_cache[key] = all(
                explorer.enumerate_attention_candidates(p, self.hw)
                for p in lm.hot_attention_problems(self.cfg, 1, max(seq, 1),
                                                   cap))
        return self._admission_cache[key]

    def _warm_autotune(self, batch: int, seq: int,
                       decode_batch: Optional[int] = None,
                       per_row: bool = False,
                       chunks: Optional[Sequence[int]] = None) -> None:
        """Fill the autotuner for this request shape, so the ops' lookups
        on the serving path hit.  Runs on a CUDA engine only, as the JAX
        engine warms on a TPU only."""
        if self.device.type != "cuda":
            return
        key = (batch, seq, decode_batch, per_row, tuple(chunks or ()))
        if key in self._warmed:
            return
        self._warmed.add(key)
        autotune.warm(self._hot_problems(batch, seq, decode_batch, per_row,
                                         chunks), hw=self.hw)

    def _hot_problems(self, batch: int, seq: int,
                      decode_batch: Optional[int] = None,
                      per_row: bool = False,
                      chunks: Optional[Sequence[int]] = None) -> list:
        """What a request shape hands the autotuner: the MLP GEMMs (or
        binary GEMMs) and the attention of a ``batch`` x ``seq`` prefill
        (or, with ``chunks``, of one row's chunks of those lengths over
        the cache) and of a decode step at ``decode_batch`` rows (default
        ``batch``; ``per_row``: each row at its own cache index, as the
        scheduler's slot cache decodes); and an audio config's frontend
        convs (``lm.hot_conv_problems``), as the JAX engine warms them."""
        cfg, db = self.cfg, decode_batch or batch
        if chunks:
            prefill = [p for c in sorted(set(chunks))
                       for p in lm.hot_chunk_problems(cfg, c, self.max_len)]
        else:
            prefill = (lm.hot_gemm_problems(cfg, batch, seq)
                       + lm.hot_binary_problems(cfg, batch, seq)
                       + [p for p in lm.hot_attention_problems(
                           cfg, batch, seq) if p.sq == seq])
        return (prefill + lm.hot_gemm_problems(cfg, db, 1)
                + lm.hot_conv_problems(cfg, batch, seq)
                + lm.hot_binary_problems(cfg, db, 1)
                + [p for p in lm.hot_attention_problems(
                    cfg, db, 1, self.max_len, rows=db if per_row else 1)
                   if p.sq == 1 and p.skv == self.max_len])

    def _reject(self, reason: str, exc_type=ValueError) -> None:
        self._counters["rejected"] += 1
        self.monitor.note("admission-reject", site="serve.submit",
                          detail=reason)
        raise exc_type(reason)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> RequestHandle:
        """Validate and admit one request (state QUEUED), or raise
        ``ValueError`` (malformed input) / ``AdmissionError``."""
        self._counters["submitted"] += 1
        if max_new_tokens is None:
            max_new_tokens = (sampling.max_new_tokens if sampling is not None
                              else 16)
        if deadline_s is None and sampling is not None:
            deadline_s = sampling.deadline_s
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            self._reject(f"prompt must be rank-1 (one request), got shape "
                         f"{prompt.shape}")
        if prompt.size == 0:
            self._reject("empty prompt: need at least one token")
        if not np.issubdtype(prompt.dtype, np.integer):
            self._reject(f"prompt dtype must be integer token ids, got "
                         f"{prompt.dtype}")
        plen = int(prompt.shape[0])
        if plen >= self.max_len:
            self._reject(f"prompt length {plen} leaves no decode room under "
                         f"max_len={self.max_len}")
        if max_new_tokens < 1:
            self._reject(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
        if self._kernel_refusal is not None:
            self._reject(f"the port's kernels cannot serve {self.cfg.name}: "
                         f"{self._kernel_refusal}", AdmissionError)
        reach = min(plen + max_new_tokens, self.max_len)
        if not self._attention_feasible(plen, reach):
            self._reject(f"no attention dataflow of the port's kernels "
                         f"serves a {plen}-token prompt reaching {reach} "
                         f"keys on {self.hw.name}", AdmissionError)
        sc = self.scheduler_config or SchedulerConfig()
        if paged_decode_enabled(self.cfg, sc, self.max_len):
            need, cap = pages_for(reach, sc.page_size), pool_capacity(
                sc, self.max_len)
            if need > cap:
                self._reject(f"page pool cannot hold request: kv reach "
                             f"{reach} needs {need} pages of "
                             f"{sc.page_size}, pool capacity is {cap} "
                             f"pages", AdmissionError)
        budget = min(max_new_tokens, self.max_len - plen)
        if budget < max_new_tokens:
            self._counters["budget_clamped"] += 1
            self.monitor.note(
                "backpressure", site="serve.submit",
                detail=f"budget clamped {max_new_tokens} -> {budget} "
                       f"(cache capacity max_len={self.max_len})")
        self._counters["admitted"] += 1
        req = RequestHandle(prompt=np.asarray(prompt, np.int32),
                            max_new_tokens=budget, deadline_s=deadline_s,
                            rid=self._next_rid, sampling=sampling,
                            engine=self)
        self._next_rid += 1
        self._backlog.append(req)
        if self.journal is not None:
            # write-ahead: the caller hears "admitted" only once the
            # admission is durable, so a kill cannot lose it
            self.journal.append(
                "submit", fsync=True, rid=req.rid,
                prompt=[int(t) for t in req.prompt],
                max_new_tokens=req.max_new_tokens, deadline_s=req.deadline_s)
        sched = self._scheduler
        if sched is not None and sched.use_paged and sched.paged.above_high():
            # queued with its reason, never dropped: it waits for the pool
            # to drain below the watermark
            req.queue_reason = (f"pool above high watermark (occupancy "
                                f"{sched.paged.occupancy():.2f})")
            self._counters["backpressure"] += 1
            self.monitor.note("backpressure", site="serve.submit",
                              detail=f"rid {req.rid}: {req.queue_reason}")
        return req

    # -- guarded step execution -----------------------------------------
    def _execute(self, site: str, step: int,
                 fn: Callable[[], Tuple[torch.Tensor, Any]]
                 ) -> Tuple[torch.Tensor, Any, str]:
        """Run one step fault-tolerantly: pick the path (``fn`` as is, or
        on a CPU engine the degradation policy's
        ``forced_backend("torch")``), fire the injection site, check the
        logits are finite, and on failure retry with backoff, demoting
        first on a CPU engine.  Returns (logits, other output, path);
        raises ``StepFailed`` when retries are exhausted, and re-raises a
        ``KernelError`` untouched."""
        demotable = self.device.type == "cpu"
        attempt = 0
        while True:
            path = (self.policy.backend_for(step, self.monitor)
                    if demotable else "primary")
            try:
                fault = health.maybe_inject(site)
                if path == "primary":
                    logits, out = fn()
                else:
                    with layers.forced_backend("torch"):
                        logits, out = fn()
                if fault == "nan":
                    logits = logits * float("nan")
                # padded-vocab columns are -inf by design at decode: only
                # the real vocabulary must be finite
                if not bool(torch.isfinite(
                        logits[..., :self.cfg.vocab_size]).all()):
                    raise NonFiniteLogits(f"non-finite logits from {site} "
                                          f"step {step} ({path} path)")
                return logits, out, path
            except KernelError:
                raise
            except Exception as e:   # any failure a bad step can surface
                failure = e
            if demotable:
                self.policy.on_failure(site, step, failure, self.monitor)
                self._counters["demotions"] += 1
            attempt += 1
            if attempt > self.policy.max_retries:
                raise StepFailed(
                    f"{site} step {step} failed after "
                    f"{self.policy.max_retries} retries: "
                    f"{type(failure).__name__}: {failure}") from failure
            self._counters["retries"] += 1
            self.monitor.note("retry", site=site, step=step,
                              detail=f"attempt {attempt} after "
                                     f"{type(failure).__name__}")
            time.sleep(self.policy.backoff_seconds(attempt - 1))

    # -- the batch-synchronous loop --------------------------------------
    def serve(self, requests: Sequence[RequestHandle], greedy: bool = True,
              seed: int = 0) -> List[RequestHandle]:
        """Drive a batch of QUEUED requests to a terminal state.

        Equal prompt lengths run the batch-synchronous loop on the slot
        cache (snapshot-resumable); mixed lengths run a fresh continuous
        scheduler.  After ``restore()``, a call that includes the
        recovered batch finishes it from its restored decode position —
        the snapshot's cache and logits (warm), or a fresh prefill and
        re-decode (cold) — with the journaled ``greedy``/``seed``, not
        this call's.  Returns the same requests.
        """
        pending = self._take_resume(requests)
        mode = "batch"
        if pending is not None:
            greedy, seed = pending["greedy"], pending["seed"]
            mode = pending.get("mode", "batch")
            reqs = pending["reqs"]
            if pending["cache"] is not None:
                self._decode_loop(reqs, pending["cache"], pending["logits"],
                                  pending["step"], time.monotonic(), greedy,
                                  seed)
                self._check_replay(requests)
                return list(requests)
            reqs = [r for r in reqs if r.state == RequestState.QUEUED]
        else:
            reqs = [r for r in requests if r.state == RequestState.QUEUED]
        if not reqs:
            return list(requests)
        lens = {int(r.prompt.shape[0]) for r in reqs}
        if len(lens) != 1 or mode == "continuous":
            return self._serve_ragged(requests, reqs, greedy, seed)
        prompts = np.stack([r.prompt for r in reqs]).astype(np.int64)
        self._warm_autotune(prompts.shape[0], prompts.shape[1])
        t_start = time.monotonic()
        if self.journal is not None:
            # the batch a cold replay must rebuild
            self.journal.append("serve", fsync=True,
                                rids=[r.rid for r in reqs], seed=int(seed),
                                greedy=bool(greedy),
                                prompt_len=int(prompts.shape[1]))
        for r in reqs:
            r.state = RequestState.PREFILLING
        tokens = torch.as_tensor(prompts, device=self.device)
        try:
            logits, cache, path = self._execute(
                "serve.prefill", 0,
                lambda: lm.prefill(self.params, tokens, self.cfg,
                                   max_len=self.max_len))
        except StepFailed as e:
            self._fail_batch(reqs, e)
            return list(requests)
        if path == "degraded":
            self._counters["degraded_steps"] += 1
        for r in reqs:
            r.state = RequestState.DECODING
        self._decode_loop(reqs, cache, logits, 0, t_start, greedy, seed)
        self._check_replay(requests)
        return list(requests)

    def _serve_ragged(self, requests: Sequence[RequestHandle],
                      reqs: List[RequestHandle], greedy: bool,
                      seed: int) -> List[RequestHandle]:
        """Drain a mixed-length batch through a fresh continuous scheduler:
        admission order, slots and the ladder are then functions of the
        batch alone, which is what a cold replay of the same rids
        rebuilds."""
        self._live = None        # no snapshot point inside a ragged drain
        if self.journal is not None:
            self.journal.append(
                "serve", fsync=True, rids=[r.rid for r in reqs],
                seed=int(seed), greedy=bool(greedy), mode="continuous",
                prompt_lens=[int(r.prompt.shape[0]) for r in reqs])
        sched = ContinuousScheduler(self, self.scheduler_config)
        for r in reqs:
            sched.enqueue(r)
        sched.drain(greedy=greedy, seed=seed)
        self._last_sched_report = sched.report()
        self._check_replay(requests)
        return list(requests)

    def _decode_loop(self, reqs: List[RequestHandle], cache, logits,
                     step: int, t_start: float, greedy: bool,
                     seed: int) -> None:
        """The batch loop, resumable at any ``step``: ``reqs`` in cache-row
        order (terminal rows stay, inert), ``logits`` predicting the next
        token, ``cache`` holding everything up to ``step``."""
        self._live = (reqs, cache, logits, step, greedy, seed)
        while True:
            now = time.monotonic()
            for r in reqs:
                if r.state == RequestState.DECODING \
                        and r.deadline_s is not None \
                        and now - t_start > r.deadline_s:
                    r.state = RequestState.EVICTED
                    r.error = (f"deadline {r.deadline_s:.3f}s exceeded "
                               f"after {len(r.out_tokens)} tokens")
                    self._counters["evicted"] += 1
                    self.monitor.note("evicted", site="serve.decode_step",
                                      step=step, detail=r.error)
                    self._journal_terminal(r, step)
            if not any(r.state == RequestState.DECODING for r in reqs):
                break
            logits_np = logits.float().cpu().numpy()
            tok = np.zeros(len(reqs), np.int64)
            for i, r in enumerate(reqs):
                if r.state != RequestState.DECODING:
                    continue
                if greedy:
                    t = int(np.argmax(logits_np[i]))
                else:
                    gen = torch.Generator().manual_seed(
                        _sample_seed(seed, r.rid, len(r.out_tokens)))
                    probs = torch.softmax(torch.from_numpy(
                        logits_np[i][:self.cfg.vocab_size]), dim=-1)
                    t = int(torch.multinomial(probs, 1, generator=gen))
                tok[i] = t
                r.out_tokens.append(t)
                if self.journal is not None:
                    # position-addressed: a replayed step overwrites
                    self.journal.append("token", rid=r.rid,
                                        step=len(r.out_tokens), token=t)
                if len(r.out_tokens) >= r.max_new_tokens:
                    r.state = RequestState.DONE
                    self._counters["completed"] += 1
                    self._journal_terminal(r, step)
            if not any(r.state == RequestState.DECODING for r in reqs):
                break
            step += 1
            toks = torch.as_tensor(tok[:, None], device=self.device)
            t0 = time.monotonic()
            try:
                logits, cache, path = self._execute(
                    "serve.decode_step", step,
                    lambda: lm.decode_step(self.params, cache, toks,
                                           self.cfg))
            except StepFailed as e:
                self._fail_batch(reqs, e, step)
                break
            if path == "degraded":
                self._counters["degraded_steps"] += 1
                for r in reqs:
                    if r.state == RequestState.DECODING:
                        r.degraded_steps += 1
            self.monitor.record(step, time.monotonic() - t0)
            self._live = (reqs, cache, logits, step, greedy, seed)
            if (self.snapshot_every and self.snapshots is not None
                    and step % self.snapshot_every == 0):
                self.snapshot()

    def _journal_terminal(self, r: RequestHandle,
                          step: Optional[int] = None) -> None:
        if self.journal is not None:
            self.journal.append(r.state.value, fsync=True, rid=r.rid,
                                step=step, error=r.error)

    def _fail_batch(self, reqs: List[RequestHandle], err: BaseException,
                    step: Optional[int] = None) -> None:
        for r in reqs:
            if r.state in (RequestState.PREFILLING, RequestState.DECODING):
                r.state = RequestState.FAILED
                r.error = str(err)
                self._counters["failed"] += 1
                self._journal_terminal(r, step)

    # -- continuous stepping --------------------------------------------
    def _ensure_scheduler(self) -> ContinuousScheduler:
        if self._scheduler is None:
            self._scheduler = ContinuousScheduler(self, self.scheduler_config)
        return self._scheduler

    def _enqueue_backlog(self, sched: ContinuousScheduler) -> None:
        """Hand submitted, unserved handles to the scheduler in rid order,
        journaling the in-flight set so a cold replay re-enqueues the
        same batch."""
        new = [r for r in self._backlog if r.state == RequestState.QUEUED]
        self._backlog = []
        if not new:
            return
        if self.journal is not None:
            live = {r.rid for r in new}
            live.update(r.rid for r in sched.inflight()
                        if not _terminal(r.state))
            self.journal.append("serve", fsync=True, rids=sorted(live),
                                seed=int(sched.seed),
                                greedy=bool(sched.greedy), mode="continuous")
        for r in new:
            sched.enqueue(r)

    def step(self) -> bool:
        """One scheduler tick: admit at most one waiting request (or push
        one prefill chunk), then decode every occupied slot.  True if any
        work was done."""
        sched = self._ensure_scheduler()
        self._enqueue_backlog(sched)
        self._live = None
        return sched.step()

    def drain(self, greedy: bool = True, seed: int = 0) -> None:
        """Step until every submitted request is terminal."""
        sched = self._ensure_scheduler()
        self._enqueue_backlog(sched)
        self._live = None
        sched.drain(greedy=greedy, seed=seed)

    def scheduler_report(self) -> Optional[Dict[str, Any]]:
        """The persistent scheduler's report, else the last ragged
        ``serve()`` drain's (None before any continuous serving)."""
        if self._scheduler is not None:
            return self._scheduler.report()
        return self._last_sched_report

    def stats(self) -> Dict[str, object]:
        """Counters merged with the health ledger, the scheduler's pool
        report and the journal's and snapshots' counters."""
        out: Dict[str, object] = dict(self._counters)
        out["demoted_now"] = self.policy.demoted
        out["probes"] = self.policy.probes
        out["health"] = self.monitor.report()
        sched = self.scheduler_report()
        if sched is not None:
            out["scheduler"] = sched
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        if self.snapshots is not None:
            out["snapshots"] = self.snapshots.stats()
        return out

    def generate(self, prompts, max_new_tokens: int, greedy: bool = True,
                 seed: int = 0) -> np.ndarray:
        """prompts (B, S) -> (B, new) tokens, through ``submit`` +
        ``drain``.  Deprecated, as in the JAX package: stream
        ``submit()``'s handles, or batch with ``serve()``/``drain()``.
        Raises ``StepFailed`` if any request does not end DONE."""
        warnings.warn(
            "Engine.generate() is deprecated; use Engine.submit() and "
            "stream the RequestHandle (tokens()/result()), or "
            "serve()/drain() for batches", DeprecationWarning, stacklevel=2)
        reqs = [self.submit(p, max_new_tokens) for p in np.asarray(prompts)]
        self.drain(greedy=greedy, seed=seed)
        bad = [r for r in reqs if r.state != RequestState.DONE]
        if bad:
            raise StepFailed(f"request {bad[0].rid} ended "
                             f"{bad[0].state.value}: {bad[0].error}")
        return np.stack([np.asarray(r.out_tokens, np.int32) for r in reqs])

    # -- crash safety: snapshot, restore, replay --------------------------
    def snapshot(self) -> Optional[int]:
        """Save the batch loop's live state through the Checkpointer:
        params, slot cache and last logits (``arrays.npz``), and the
        request table, tokens, counters and health ledger (the manifest's
        extras).  Returns the step saved, or None when nothing is live or
        the save failed: a failed snapshot costs a recovery point, never
        the serving."""
        if self.snapshots is None or self._live is None:
            return None
        reqs, cache, logits, step, greedy, seed = self._live
        try:
            health.maybe_inject("snapshot.save")
            extras = {
                "step": step, "greedy": bool(greedy), "seed": int(seed),
                "rids": [r.rid for r in reqs],
                "requests": [{
                    "rid": r.rid, "state": r.state.value,
                    "prompt": [int(t) for t in r.prompt],
                    "max_new_tokens": r.max_new_tokens,
                    "deadline_s": r.deadline_s,
                    "out_tokens": list(r.out_tokens),
                    "error": r.error,
                } for r in reqs],
                "counters": dict(self._counters),
                "health_events": [[e.kind, e.site, e.step, e.detail]
                                  for e in self.monitor.events],
            }
            self.snapshots.save(step, {"params": self.params, "cache": cache,
                                       "logits": {"arr": logits}},
                                extras=extras, blocking=True)
        except (CheckpointError, OSError, health.SimulatedFailure) as e:
            self._counters["snapshot_errors"] += 1
            self.monitor.note("snapshot-error", site="snapshot.save",
                              step=step, detail=f"{type(e).__name__}: {e}")
            return None
        self._counters["snapshots_saved"] += 1
        if self.journal is not None:
            self.journal.append("snapshot", fsync=True, step=step)
        return step

    def restore(self, devices: Optional[Sequence] = None
                ) -> List[RequestHandle]:
        """Rebuild the journaled requests after a crash and arm the resume.

        Returns every journaled request in rid order: those that reached
        a durable terminal state as they ended, tokens included; those in
        flight re-admitted at their decode position, for the next
        ``serve()`` to finish.  Sources, best first: the newest intact
        snapshot (a corrupt or faulted one falls back to older steps,
        counted in ``restore_fallbacks``), then a cold replay from the
        journal alone.
        """
        if devices is not None:
            raise NotImplementedError(
                "restore onto a set of devices (elastic remesh) is not "
                "ported yet (ROADMAP A14)")
        if self.journal is None:
            raise ValueError("restore() needs a journal: construct the "
                             "Engine with journal_dir= or set "
                             "REPRO_JOURNAL_DIR")
        records = self.journal.scan()
        table = journal_lib.replay_table(records)
        reqs: Dict[int, RequestHandle] = {}
        for rid in sorted(table):
            row = table[rid]
            r = RequestHandle(prompt=np.asarray(row["prompt"], np.int32),
                              max_new_tokens=row["max_new_tokens"],
                              deadline_s=row["deadline_s"], rid=rid,
                              state=RequestState(row["state"]), engine=self)
            r.out_tokens = list(row["tokens"])
            r.error = row["error"]
            reqs[rid] = r
        if reqs:
            self._next_rid = max(self._next_rid, max(reqs) + 1)
        snap = None
        if self.snapshots is not None:
            for snap_step in reversed(self.snapshots.steps()):
                try:
                    health.maybe_inject("engine.restore")
                    snap = self._load_snapshot(snap_step)
                    break
                except Exception as e:
                    # corrupt (torn npz or manifest, foreign params) or an
                    # injected fault: fall back to an older step, then to
                    # a cold replay
                    self._counters["restore_fallbacks"] += 1
                    self.monitor.note("restore-fallback",
                                      site="engine.restore", step=snap_step,
                                      detail=f"{type(e).__name__}: {e}")
                    snap = None
        if snap is not None:
            self._arm_snapshot_resume(snap, reqs)
        else:
            self._arm_cold_resume(records, reqs)
        out = [reqs[rid] for rid in sorted(reqs)]
        recovered = [r for r in out if not _terminal(r.state)]
        self._counters["recovered"] += len(recovered)
        self.monitor.note(
            "restore", site="engine.restore",
            detail=f"{len(out)} journaled requests, {len(recovered)} in "
                   f"flight, {'warm' if snap is not None else 'cold'} resume")
        return out

    def _load_snapshot(self, step: int):
        """One snapshot step, on this engine's device; raises on any
        corruption or on params of another shape."""
        _, state, extras = self.snapshots.restore(step, device=self.device)
        bridge.check_tree(state["params"], self.cfg)
        return state, extras

    def _arm_snapshot_resume(self, snap, reqs: Dict[int, RequestHandle]
                             ) -> None:
        """Warm restart: the batch re-admitted at the snapshot's step."""
        state, extras = snap
        self.params = state["params"]
        step = int(extras["step"])
        snap_reqs = {sr["rid"]: sr for sr in extras.get("requests", [])}
        batch: List[RequestHandle] = []
        for rid in extras["rids"]:
            sr = snap_reqs.get(rid, {})
            r = reqs.get(rid)
            if r is None and sr:
                # the journal lost the submit record: the snapshot's
                # request table is the second source
                r = RequestHandle(prompt=np.asarray(sr["prompt"], np.int32),
                                  max_new_tokens=sr["max_new_tokens"],
                                  deadline_s=sr.get("deadline_s"), rid=rid,
                                  state=to_state_safe(sr.get("state")),
                                  engine=self)
                r.out_tokens = list(sr.get("out_tokens", []))
                r.error = sr.get("error")
                reqs[rid] = r
            if r is None:
                raise CheckpointError(
                    f"snapshot step {step} names rid {rid} known to neither "
                    f"the journal nor the snapshot's request table")
            snap_state = to_state_safe(sr.get("state")) if sr else None
            if _terminal(r.state):
                pass                     # the journal's terminal record wins
            elif snap_state is not None and _terminal(snap_state):
                # the journal lost the terminal record, the snapshot has it
                r.state = snap_state
                r.out_tokens = list(sr.get("out_tokens", r.out_tokens))
                r.error = sr.get("error", r.error)
            else:
                # the journal may be ahead of the snapshot: its tokens are
                # the replay expectation, the live position the snapshot's
                if len(r.out_tokens) > step:
                    self._replay_expected[rid] = list(r.out_tokens)
                out = sr.get("out_tokens")
                r.out_tokens = (list(out) if out is not None
                                else r.out_tokens[:step])
                self._counters["replayed_steps"] += max(
                    0, len(self._replay_expected.get(rid, []))
                    - len(r.out_tokens))
                r.state = RequestState.DECODING
            batch.append(r)
        for k, v in extras.get("counters", {}).items():
            if k in self._counters:
                self._counters[k] = max(self._counters[k], int(v))
        for kind, site, estep, detail in extras.get("health_events", []):
            self.monitor.events.append(health.HealthEvent(
                kind=kind, site=site, step=estep, detail=detail))
        self._pending_resume = {
            "reqs": batch, "cache": state["cache"],
            "logits": state["logits"]["arr"], "step": step,
            "greedy": bool(extras["greedy"]), "seed": int(extras["seed"]),
        }

    def _arm_cold_resume(self, records: List[dict],
                         reqs: Dict[int, RequestHandle]) -> None:
        """No usable snapshot: the in-flight requests of the last
        journaled batch go back to QUEUED, their journaled tokens kept as
        the replay expectation, for a fresh prefill and re-decode."""
        serves = [rec for rec in records if rec.get("kind") == "serve"]
        if not serves:
            return                      # a crash before any serve: QUEUED
        last = serves[-1]
        batch = []
        for rid in last.get("rids", []):
            r = reqs.get(rid)
            if r is None or _terminal(r.state):
                continue
            if r.out_tokens:
                self._replay_expected[rid] = list(r.out_tokens)
                self._counters["replayed_steps"] += len(r.out_tokens)
            r.out_tokens = []
            r.state = RequestState.QUEUED
            batch.append(r)
        if batch:
            self._pending_resume = {
                "reqs": batch, "cache": None, "logits": None, "step": 0,
                "greedy": bool(last.get("greedy", True)),
                "seed": int(last.get("seed", 0)),
                "mode": last.get("mode", "batch"),
            }

    def _take_resume(self, requests: Sequence[RequestHandle]):
        """Pop the armed resume if its batch is inside ``requests``."""
        if self._pending_resume is None:
            return None
        given = {id(r) for r in requests}
        if all(id(r) in given for r in self._pending_resume["reqs"]):
            pending, self._pending_resume = self._pending_resume, None
            return pending
        return None

    def _check_replay(self, requests: Sequence[RequestHandle]) -> None:
        """Hold re-decoded tokens against the journal's: a difference
        means corrupted state (a bad snapshot, a forged record, other
        params) and is ledgered; the recomputed tokens stand."""
        for r in requests:
            exp = self._replay_expected.pop(r.rid, None)
            if exp is None:
                continue
            n = min(len(exp), len(r.out_tokens))
            if r.out_tokens[:n] != exp[:n]:
                self._counters["replay_divergence"] += 1
                self.monitor.note(
                    "replay-divergence", site="engine.restore",
                    detail=f"rid {r.rid}: journaled {exp[:n]} vs replayed "
                           f"{r.out_tokens[:n]}")
