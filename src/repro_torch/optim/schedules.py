"""Learning-rate schedules, pure functions of the step.

The port's copy of ``repro/optim/schedules.py``: WSD (warmup-stable-
decay, the schedule MiniCPM trains with), cosine and linear warmup.
Each takes the step as a number and returns the rate as a Python float,
computed in double precision (the reference computes in float32; the
two agree to within an ulp of float32, which is how the optimizer uses
the rate).
"""
from __future__ import annotations

import math


def linear_warmup(step: float, warmup_steps: int, peak: float) -> float:
    return peak * min(1.0, (float(step) + 1) / max(warmup_steps, 1))


def wsd(step: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, peak: float, floor: float = 0.0) -> float:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395 §4): a linear
    warmup, ``peak`` for ``stable_steps``, then a fast exponential anneal
    down to ``floor``."""
    step = float(step)
    if step < warmup_steps:
        return peak * (step + 1) / max(warmup_steps, 1)
    if step < warmup_steps + stable_steps:
        return peak
    decay_frac = (step - warmup_steps - stable_steps) / max(decay_steps, 1)
    return max(peak * math.exp(-decay_frac * 5.0), floor)


def cosine(step: float, warmup_steps: int, total_steps: int, peak: float,
           floor_ratio: float = 0.1) -> float:
    """A linear warmup, then a half cosine from ``peak`` down to
    ``floor_ratio * peak`` at ``total_steps``."""
    step = float(step)
    if step < warmup_steps:
        return peak * (step + 1) / max(warmup_steps, 1)
    t = min(max((step - warmup_steps)
                / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    return peak * (floor_ratio + (1 - floor_ratio) * 0.5
                   * (1 + math.cos(math.pi * t)))
