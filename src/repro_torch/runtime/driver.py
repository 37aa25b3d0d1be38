"""Fault-tolerant training driver: checkpoint-restart and health monitoring.

The port's counterpart of ``repro/runtime/driver.py``.  The driver owns
the loop: step-addressed data (``SyntheticLMDataset``, a pure function of
(seed, step), so nothing of an iterator is persisted), the train step
(``train.step.make_train_step``: ``lm.loss_fn`` under autograd through
the kernels, AdamW in place), checkpoints every ``ckpt_every`` steps and
at the end, step timing and straggler detection (``HealthMonitor``), and
the crash hook (``health.maybe_inject_failure``, armed by
``REPRO_FAIL_AT_STEP``).  ``run(resume=True)`` after a crash restores
the newest checkpoint and continues.  The steps run under
``torch.use_deterministic_algorithms`` (on the card the embedding's
backward accumulates with atomics otherwise), so a resumed run's
parameters equal an uninterrupted run's bit for bit; an op with no
deterministic CUDA kernel (the SSM block's float ``cumsum``) warns and
runs as it is, so a resumed mamba2 or hymba run may differ in the last
bits on the card.

Checkpoints are saved in the background (``Checkpointer.save(...,
blocking=False)``): the save copies every tensor to the host before it
returns, so the next step's in-place update cannot reach the files, and
only the writing overlaps the training.  ``run`` waits for the last write
before it returns, and before it lets an injected failure propagate, so
a restart in the same process never reads a checkpoint still being
written.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import lm
from repro_torch.optim import AdamW, AdamWState, schedules
from repro_torch.runtime import health
from repro_torch.train.step import make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainJobConfig:
    arch: Any                      # ArchConfig
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    schedule: str = "cosine"       # cosine | wsd | const
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 20
    microbatches: int = 1
    remat: str = "none"
    seed: int = 0
    aux_weight: float = 0.01


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: AdamWState
    last_loss: float = float("nan")


@contextlib.contextmanager
def _deterministic():
    """The body under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, restoring the previous mode after.  cuBLAS then
    needs ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8`` unless the environment
    sets it); fresh tensors are not filled (every kernel writes its whole
    output, and the fill would cost a write of each)."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _lr_fn(job: TrainJobConfig):
    warm = max(job.steps // 10, 1)
    if job.schedule == "cosine":
        return lambda s: schedules.cosine(s, warm, job.steps, job.lr)
    if job.schedule == "wsd":
        return lambda s: schedules.wsd(s, warm, int(job.steps * 0.7),
                                       max(job.steps // 5, 1), job.lr)
    if job.schedule == "const":
        return lambda s: job.lr
    raise ValueError(f"schedule must be cosine, wsd or const, got "
                     f"{job.schedule!r}")


class TrainDriver:
    def __init__(self, job: TrainJobConfig, device=None):
        self.job = job
        self.device = device_lib.resolve(device)
        cfg = job.arch
        self.optimizer = AdamW(lr_fn=_lr_fn(job))
        self.dataset = SyntheticLMDataset(
            vocab_size=cfg.vocab_size, seq_len=job.seq_len,
            global_batch=job.global_batch, seed=job.seed,
            with_enc_frames=cfg.is_encoder_decoder, d_model=cfg.d_model,
            enc_seq_ratio=cfg.enc_seq_ratio)
        self.ckpt = Checkpointer(job.ckpt_dir)
        self.monitor = health.HealthMonitor()
        self._step_fn = make_train_step(
            cfg, self.optimizer, remat=job.remat,
            microbatches=job.microbatches, aux_weight=job.aux_weight)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        params = lm.init_model(self.job.arch, seed=self.job.seed,
                               device=self.device)
        return TrainState(0, params, self.optimizer.init(params))

    def run(self, resume: bool = False,
            state: Optional[TrainState] = None) -> TrainState:
        if state is None:
            if resume and self.ckpt.latest_step() is not None:
                state = self.restore()
                print(f"resumed from step {state.step}")
            else:
                state = self.init_state()
        with _deterministic():
            while state.step < self.job.steps:
                state = self._one_step(state)
        self.ckpt.wait()
        return state

    def _one_step(self, state: TrainState) -> TrainState:
        step = state.step
        batch = self.dataset.batch(step, self.device)
        t0 = time.monotonic()
        params, opt_state, metrics = self._step_fn(state.params,
                                                   state.opt_state, batch)
        loss = float(metrics["loss"])          # waits for the card
        dt = time.monotonic() - t0
        state = TrainState(step + 1, params, opt_state, loss)
        if self.monitor.record(step, dt):
            print(f"straggler: step {step} took {dt:.2f}s "
                  f"(median {self.monitor.median_step_seconds:.2f}s)")
        if (step + 1) % self.job.ckpt_every == 0 \
                or step + 1 == self.job.steps:
            self.save(state)
        try:
            health.maybe_inject_failure(step + 1)
        except health.SimulatedFailure as e:
            # ledger the crash, let the write in flight land, and
            # propagate: the drill is the restart (run(resume=True))
            self.monitor.note("fault", site="train.step", step=step + 1,
                              detail=str(e))
            self.ckpt.wait()
            raise
        return state

    def health_report(self) -> Dict[str, object]:
        """Step timing and the ledger's rollup for this driver."""
        return self.monitor.report()

    # ------------------------------------------------------------------
    def save(self, state: TrainState, blocking: bool = False) -> None:
        opt = state.opt_state
        self.ckpt.save(
            state.step,
            {"params": state.params,
             "opt": {"step": opt.step, "m": opt.m, "v": opt.v}},
            extras={"last_loss": state.last_loss,
                    "dataset_seed": self.job.seed},
            blocking=blocking)

    def restore(self) -> TrainState:
        step, trees, extras = self.ckpt.restore(device=self.device)
        opt = trees["opt"]
        loss = extras.get("last_loss")
        return TrainState(step, trees["params"],
                          AdamWState(opt["step"], opt["m"], opt["v"]),
                          math.nan if loss is None else loss)
