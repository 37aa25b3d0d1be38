"""Data pipeline: deterministic, stateless synthetic LM batches.

The port's copy of ``repro/data/pipeline.py``'s ``SyntheticLMDataset``:
a batch is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it (a Zipf-ish unigram stream with copy motifs, and
for an encoder-decoder normal frame embeddings), so the two packages see
the same tokens bit for bit and a restart resumes with no iterator
state.  ``make_global_batch`` makes a DTensor of a batch leaf from this
rank's slice alone (``batch(step, sharding=)``).
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

    def batch(self, step: int, device=None, sharding=None
              ) -> Dict[str, torch.Tensor]:
        """``batch_np(step)`` as tensors on ``device`` (the card by
        default); with ``sharding`` (a ``launch.sharding.Sharding``, or a
        dict of them by leaf name: ``batch_shardings``), DTensors holding
        this rank's slice only (``make_global_batch``)."""
        dev = device_lib.resolve(device)
        np_batch = self.batch_np(step)
        if sharding is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in np_batch.items()}
        return {k: make_global_batch(
            v, sharding[k] if isinstance(sharding, dict) else sharding, dev)
            for k, v in np_batch.items()}


def make_global_batch(array: np.ndarray, sharding, device=None):
    """A DTensor of the global ``array`` under ``sharding`` (a
    ``launch.sharding.Sharding``): this rank's slice, found from the
    placements, is the only part copied to ``device``; no other rank's
    shard is materialized there."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as rules

    dev = device_lib.resolve(device)
    pls = sharding.placements
    local = array[rules.shard_slices(array.shape, pls, sharding.mesh)]
    t = torch.from_numpy(np.ascontiguousarray(local)).to(dev)
    stride, acc = [], 1
    for d in reversed(array.shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(t, sharding.mesh, pls, run_check=False,
                              shape=torch.Size(array.shape),
                              stride=tuple(reversed(stride)))
