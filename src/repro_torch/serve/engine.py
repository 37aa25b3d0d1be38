"""Serving engine: request lifecycle over the continuous scheduler.

Twin of ``repro/serve/engine.py``'s handle/stream API:

    QUEUED -> PREFILLING -> DECODING -> {DONE, FAILED, EVICTED}

``submit`` validates a prompt (``ValueError``) and rejects what the
port's kernels cannot run or the page pool can never hold
(``AdmissionError``), and returns a ``RequestHandle``; ``step`` /
``drain`` run the ``ContinuousScheduler``.  Every prefill and decode step
runs under ``_execute``: the ``serve.prefill`` / ``serve.decode_step``
fault sites fire, the step's logits must be finite, and a failed step
is retried with backoff.  On the card the retry runs the CUDA kernels
again: the plain PyTorch versions never stand in for them there.  On a
CPU engine, where every kernel wrapper computes its plain version, a
failed step demotes to ``layers.forced_backend("torch")`` as the JAX
engine demotes to XLA, re-probing the primary path after a cooldown.
A kernel that does not build or launch (``KernelError``) is not a
failed step: it propagates at once.

Admission asks what the CUDA kernels accept — the head dimension, the
page size and the GQA group — where the JAX engine probes TPU VMEM.

Not ported yet (each raises ``NotImplementedError``): the request
journal, snapshots and ``restore`` (ROADMAP A5a), and the
batch-synchronous ``serve``/``generate`` loop (A5d).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import attention_df
from repro_torch.kernels._build import KernelError
from repro_torch.models import layers, lm
from repro_torch.runtime import health
from repro_torch.serve.paged_cache import pages_for
from repro_torch.serve.scheduler import (ContinuousScheduler, SamplingParams,
                                         SchedulerConfig,
                                         paged_decode_enabled, pool_capacity)


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


class AdmissionError(ValueError):
    """Request rejected at admission (resource infeasibility)."""


class StepFailed(RuntimeError):
    """A prefill/decode step failed on both paths, retries exhausted."""


class NonFiniteLogits(RuntimeError):
    """The post-step sentinel saw NaN/Inf logits."""


@dataclasses.dataclass
class RequestHandle:
    """One request, as ``Engine.submit`` returns it, bound to its engine.
    ``tokens()`` streams generated ids, stepping the engine when the
    stream runs dry; ``result()`` drains it (``StepFailed`` if FAILED)."""
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


def _not_ported(what: str, entry: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {entry})")


class Engine:
    """Continuous-batching serving with admission, degradation and
    retries, on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, cfg, params, max_len: int = 2048, device=None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 journal_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None):
        if journal_dir or snapshot_dir or snapshot_every:
            _not_ported("the request journal and snapshots",
                        "A5a: journal/snapshot/restore")
        self.device = device_lib.resolve(device)
        lm._check_supported(cfg)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.monitor = health.HealthMonitor()
        self.policy = health.DegradationPolicy()
        self.scheduler_config = scheduler_config
        self._scheduler: Optional[ContinuousScheduler] = None
        self._backlog: List[RequestHandle] = []
        self._next_rid = 0
        self._kernel_refusal = self._kernels_refuse()
        self._counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "rejected": 0,
            "completed": 0, "failed": 0, "evicted": 0,
            "retries": 0, "demotions": 0, "degraded_steps": 0,
            "budget_clamped": 0, "backpressure": 0,
        }

    # -- admission ------------------------------------------------------
    def _kernels_refuse(self) -> Optional[str]:
        """Why the port's kernels cannot serve this config, or None."""
        cfg = self.cfg
        sc = self.scheduler_config or SchedulerConfig()
        if cfg.d_head not in attention_df.HEAD_DIMS:
            return (f"d_head {cfg.d_head} not in the attention kernels' "
                    f"{attention_df.HEAD_DIMS}")
        if sc.page_size > attention_df.MAX_PAGE:
            return (f"page_size {sc.page_size} > the paged kernel's "
                    f"{attention_df.MAX_PAGE}")
        if cfg.n_heads // cfg.n_kv_heads > attention_df.MAX_GROUP:
            return (f"GQA group {cfg.n_heads // cfg.n_kv_heads} > the paged "
                    f"kernel's {attention_df.MAX_GROUP}")
        return None

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

    # -- continuous stepping --------------------------------------------
    def _ensure_scheduler(self) -> ContinuousScheduler:
        if self._scheduler is None:
            self._scheduler = ContinuousScheduler(self, self.scheduler_config)
        sched = self._scheduler
        for r in self._backlog:
            if r.state == RequestState.QUEUED:
                sched.enqueue(r)
        self._backlog = []
        return sched

    def step(self) -> bool:
        """One scheduler tick: admit at most one waiting request, then
        decode every occupied slot.  True if any work was done."""
        return self._ensure_scheduler().step()

    def drain(self, greedy: bool = True, seed: int = 0) -> None:
        """Step until every submitted request is terminal."""
        self._ensure_scheduler().drain(greedy=greedy, seed=seed)

    def scheduler_report(self) -> Optional[Dict[str, Any]]:
        if self._scheduler is None:
            return None
        return self._scheduler.report()

    def stats(self) -> Dict[str, object]:
        """Counters merged with the health ledger and the scheduler's
        pool report."""
        out: Dict[str, object] = dict(self._counters)
        out["demoted_now"] = self.policy.demoted
        out["probes"] = self.policy.probes
        out["health"] = self.monitor.report()
        sched = self.scheduler_report()
        if sched is not None:
            out["scheduler"] = sched
        return out

    # -- not ported yet ---------------------------------------------------
    def serve(self, requests, greedy: bool = True, seed: int = 0):
        _not_ported("the batch-synchronous serve() loop",
                    "A5d: slot-cache decode and serve()")

    def generate(self, prompts, max_new_tokens: int, greedy: bool = True,
                 seed: int = 0):
        _not_ported("generate()", "A5d: slot-cache decode and serve()")

    def snapshot(self):
        _not_ported("engine snapshots", "A5a: journal/snapshot/restore")

    def restore(self, devices=None):
        _not_ported("engine restore", "A5a: journal/snapshot/restore")
