"""How B2's bf16 outputs round, where the served binary MLP can see it.

The binary-MLP decoder thresholds its activations at zero, so a bf16
rounding that B2 takes differently from the plain attention can flip a
bit and move the logits: ``chip_smoke.py`` gates its 2-layer prefill at
a logits cosine of 0.999 against the plain path.  This runs that prefill
(qwen3-1.7b at full width, binary MLP, two layers, random weights from
``seed``, the 17-token prompt of the serve phases) three ways: plain,
on the kernels, and on the kernels with B2 replaced by its float32
CUDA-core instantiation on the widened inputs, rounded to bf16 (the
arithmetic of B2's bf16 path before the tensor cores).  For each B2
call it counts the bf16 outputs that differ from the plain version.

    PYTHONPATH=src python -m repro_torch.bench.attention_rounding

On the CPU nothing runs (the kernels exist only on the card): ``run``
returns no rows.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.kernels import attention_df, ref
from repro_torch.models import layers, lm

PROMPT = 17


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def run(device: Optional[str] = None, seed: int = 0) -> List[dict]:
    device = device_lib.resolve(device)
    if device.type != "cuda":
        return []
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=2,
                              binary_mlp=True)
    params = lm.init_model(cfg, seed=seed, device=device)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, PROMPT)
    toks = torch.as_tensor(prompt.astype(np.int32)[None], device=device)
    kernel = attention_df.flash_attention

    def widened(q, k, v, **kw):
        return kernel(q.float(), k.float(), v.float(), **kw).to(q.dtype)

    rows = []

    def counted(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        rows.append({"bench": "b2_rounding", "call": len(rows),
                     "shape": list(q.shape), "elements": q.numel(),
                     "tensor_cores_differ": int((got != want).sum()),
                     "float32_path_differs": int(
                         (widened(q, k, v, **kw) != want).sum())})
        return got

    with layers.forced_backend("torch"):
        plain, _ = lm.prefill(params, toks, cfg, max_len=1024)
    try:
        attention_df.flash_attention = counted
        on_kernels, _ = lm.prefill(params, toks, cfg, max_len=1024)
        attention_df.flash_attention = widened
        float32_path, _ = lm.prefill(params, toks, cfg, max_len=1024)
    finally:
        attention_df.flash_attention = kernel
    rows.append({"bench": "b2_rounding", "layers": cfg.n_layers,
                 "cosine_tensor_cores": _cosine(on_kernels, plain),
                 "cosine_float32_path": _cosine(float32_path, plain)})
    return rows


if __name__ == "__main__":
    for r in run():
        print(json.dumps(r))
