"""Data pipeline: deterministic, stateless synthetic LM batches.

The port's copy of ``repro/data/pipeline.py``'s ``SyntheticLMDataset``:
a batch is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it (a Zipf-ish unigram stream with copy motifs, and
for an encoder-decoder normal frame embeddings), so the two packages see
the same tokens bit for bit and a restart resumes with no iterator
state.  ``make_global_batch``, which materializes one host's shards of a
sharded batch, waits for ROADMAP A14.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    with_enc_frames: bool = False
    d_model: int = 0
    enc_seq_ratio: float = 1.0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        """The whole batch of ``step``: ``tokens`` and next-token
        ``targets`` (B, seq_len) int32, and ``enc_frames`` (B, seq_len *
        enc_seq_ratio, d_model) float32 for an encoder-decoder."""
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab_size
        probs = 1.0 / np.arange(1, v + 1)
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, s), p=probs).astype(np.int32)
        # copy motifs: the second half repeats a window of the first
        motif = min(16, self.seq_len // 4)
        if motif >= 2:
            start = rng.integers(0, self.seq_len // 2 - motif, size=b)
            for i in range(b):
                src = toks[i, start[i]:start[i] + motif]
                dst = self.seq_len // 2 + start[i]
                toks[i, dst:dst + motif] = src
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.with_enc_frames:
            es = int(self.seq_len * self.enc_seq_ratio)
            out["enc_frames"] = rng.normal(
                size=(b, es, self.d_model)).astype(np.float32)
        return out

    def batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """``batch_np(step)`` as tensors on ``device`` (the card by
        default)."""
        dev = device_lib.resolve(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in self.batch_np(step).items()}


def make_global_batch(*args, **kwargs):
    raise NotImplementedError(
        "make_global_batch shards a batch over a device mesh: it waits "
        "for ROADMAP A14 (multi-device on torch.distributed)")
